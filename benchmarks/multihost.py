"""Multi-host distributed global BA: self-spawning harness + benchmark.

Parent mode (no --process-id): spawns --num-processes child copies of itself
on localhost (CPU backend, 4 virtual devices each — the multi-host smoke rig),
waits, and merges their reports. The parent never imports JAX, and each
child gets `JAX_PLATFORMS=cpu` in its environment, so the rig never opens a
GPU (a second JAX process on a card fails for want of device memory).

Child mode (--process-id given, or MSLAM_* env set by a real launcher): calls
`parallel.distributed.initialize`, builds the SAME synthetic global-BA
problem from a fixed seed on every process, runs landmark-sharded
`distributed_bundle_adjust` over the global mesh, and reports LM iters/sec.

On a real cluster each process is one host, launched with the MSLAM_* env
vars of `parallel/distributed.py`; the identical code path runs with no
changes (SURVEY.md §5.8).

    python benchmarks/multihost.py --num-processes 2 --frames 32 --points 20000
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def child(args) -> None:
    import jax

    from monocular_slam_tpu.parallel import distributed

    multi = distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    import jax.numpy as jnp

    from monocular_slam_tpu.geometry import camera, se3, so3
    from monocular_slam_tpu.optim import ba
    from monocular_slam_tpu.parallel import sharded_ba

    # identical problem on every process (fixed seed)
    F, P, OBS = args.frames, args.points, args.obs_per_frame
    key = jax.random.PRNGKey(0)
    kx, kn, kp = jax.random.split(key, 3)
    X = jax.random.uniform(kx, (P, 3), minval=-10, maxval=10) + jnp.array([0, 0, 20.0])
    k = jnp.array([500.0, 500.0, 320.0, 240.0])
    poses = jnp.stack(
        [
            se3.from_Rt(
                so3.exp(jnp.array([0.0, 0.02 * i, 0.0])),
                jnp.array([-0.2 * i, 0.0, 0.0]),
            )
            for i in range(F)
        ]
    )
    cam_idx = jnp.repeat(jnp.arange(F, dtype=jnp.int32), OBS)
    pt_idx = jax.random.randint(kp, (F * OBS,), 0, P, dtype=jnp.int32)
    uv_true = camera.project(
        k, se3.apply(poses[cam_idx], X[pt_idx])
    ) + 0.5 * jax.random.normal(kn, (F * OBS, 2))
    prob = ba.BAProblem(
        poses=se3.compose(se3.exp(0.01 * jax.random.normal(kn, (F, 6))), poses),
        points=X + 0.05 * jax.random.normal(kx, X.shape),
        k=jnp.broadcast_to(k, (F, 4)),
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        uv=uv_true,
        info=jnp.ones(F * OBS),
        valid=jnp.ones(F * OBS, bool),
        fixed=jnp.zeros(F, bool).at[0].set(True),
    )

    from monocular_slam_tpu.parallel import distributed as dist

    mesh = dist.global_mesh()
    report = {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "mesh_model": int(mesh.shape["model"]),
        "multi": bool(multi),
    }
    for solver in args.solvers:
        res = sharded_ba.distributed_bundle_adjust(
            prob, mesh, n_iters=args.iters, solver=solver
        )
        jax.block_until_ready(res.poses)
        t0 = time.perf_counter()
        res = sharded_ba.distributed_bundle_adjust(
            prob, mesh, n_iters=args.iters, solver=solver
        )
        jax.block_until_ready(res.poses)
        dt = time.perf_counter() - t0
        report[solver] = {
            "iters_per_sec": round(args.iters / dt, 3),
            "chi2_initial": float(res.chi2_initial),
            "chi2_final": float(res.chi2_history[-1]),
        }
        assert float(res.chi2_history[-1]) < float(res.chi2_initial), solver
    print("MULTIHOST_REPORT " + json.dumps(report), flush=True)


def parent(args) -> int:
    port = args.port
    procs = []
    # localhost rig: every child on the CPU backend with its virtual devices
    flags = " ".join(
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f
    )
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count={args.local_devices}".strip(),
    )
    for pid in range(args.num_processes):
        cmd = [
            sys.executable, os.path.abspath(__file__),
            "--process-id", str(pid),
            "--num-processes", str(args.num_processes),
            "--coordinator", f"localhost:{port}",
            "--frames", str(args.frames),
            "--points", str(args.points),
            "--obs-per-frame", str(args.obs_per_frame),
            "--iters", str(args.iters),
            "--local-devices", str(args.local_devices),
            "--solvers", *args.solvers,
        ]
        procs.append(
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env
            )
        )
    reports, ok = [], True
    for p in procs:
        out, _ = p.communicate(timeout=args.timeout)
        if p.returncode != 0:
            ok = False
            sys.stderr.write(out[-4000:])
        for line in out.splitlines():
            if line.startswith("MULTIHOST_REPORT "):
                reports.append(json.loads(line[len("MULTIHOST_REPORT "):]))
    print(json.dumps({"ok": ok, "reports": reports}, indent=1))
    return 0 if ok and len(reports) == args.num_processes else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--points", type=int, default=20000)
    p.add_argument("--obs-per-frame", type=int, default=1500)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--local-devices", type=int, default=4)
    p.add_argument("--solvers", nargs="*", default=["dense", "cg"])
    p.add_argument("--port", type=int, default=12921)
    p.add_argument("--timeout", type=int, default=900)
    args = p.parse_args(argv)
    if args.process_id is None and "MSLAM_PROCESS_ID" not in os.environ:
        return parent(args)
    child(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
