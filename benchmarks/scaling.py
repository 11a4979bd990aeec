"""Distributed-BA scaling benchmark.

Measures LM iterations/sec of the landmark-sharded global BA at 1..N shards.
On a host with several GPUs the mesh rides NVLink; on N virtual CPU devices
the harness validates the collective structure and load balance, and times
are not device times.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --frames 32 --points 20000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cg_comm_bytes_per_iter(n_frames: int) -> int:
    """Analytic communication model of the sharded-CG Schur path: each CG
    step psums ONE (F, 6) f32 vector (`parallel/sharded_ba.py` matvec) —
    4*6*F bytes per direction, independent of landmark count. The HLO-level
    check lives in tests/test_comm_volume.py."""
    return 4 * 6 * n_frames


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--points", type=int, default=20000)
    p.add_argument("--obs-per-frame", type=int, default=1500)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--shards", type=int, nargs="*", default=None)
    p.add_argument("--cpu", action="store_true", help="force CPU virtual devices")
    p.add_argument("--out", default=None, help="write JSON artifact here")
    p.add_argument(
        "--one-thread-per-device",
        action="store_true",
        help="pin XLA-CPU intra-op parallelism to 1 thread so each virtual "
        "device ~ one core: without this, the 1-shard run already uses every "
        "core and strong-scaling efficiency is meaningless on a shared host",
    )
    args = p.parse_args(argv)

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            flags += " --xla_force_host_platform_device_count=8"
        if args.one_thread_per_device:
            flags += " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
        os.environ["XLA_FLAGS"] = flags

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from monocular_slam_tpu.geometry import camera, se3, so3
    from monocular_slam_tpu.optim import ba
    from monocular_slam_tpu.parallel import mesh as mesh_mod
    from monocular_slam_tpu.parallel import sharded_ba

    n_dev = jax.device_count()
    shards = args.shards or [s for s in (1, 2, 4, 8) if s <= n_dev]

    # synthetic global-BA problem
    F, P, OBS = args.frames, args.points, args.obs_per_frame
    key = jax.random.PRNGKey(0)
    X = jax.random.uniform(key, (P, 3), minval=-10, maxval=10) + jnp.array([0, 0, 20.0])
    k = jnp.array([500.0, 500.0, 320.0, 240.0])
    poses = jnp.stack(
        [
            se3.from_Rt(so3.exp(jnp.array([0.0, 0.02 * i, 0.0])), jnp.array([-0.3 * i, 0.0, 0.0]))
            for i in range(F)
        ]
    )
    # random observation pattern: OBS points per frame
    pt_idx = jax.random.randint(jax.random.PRNGKey(1), (F * OBS,), 0, P)
    cam_idx = jnp.repeat(jnp.arange(F, dtype=jnp.int32), OBS)
    uv = camera.project(k, se3.apply(poses[cam_idx], X[pt_idx]))
    uv = uv + 0.5 * jax.random.normal(jax.random.PRNGKey(2), uv.shape)
    poses0 = se3.compose(
        se3.exp(0.005 * jax.random.normal(jax.random.PRNGKey(3), (F, 6))), poses
    ).at[0].set(poses[0])
    prob = ba.BAProblem(
        poses=poses0.astype(jnp.float32),
        points=(X + 0.05 * jax.random.normal(jax.random.PRNGKey(4), X.shape)).astype(jnp.float32),
        k=jnp.broadcast_to(k, (F, 4)).astype(jnp.float32),
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        uv=uv.astype(jnp.float32),
        info=jnp.ones(F * OBS, jnp.float32),
        valid=jnp.ones(F * OBS, bool),
        fixed=jnp.zeros(F, bool).at[0].set(True),
    )

    results = {"dense": {}, "cg": {}}
    n_cores = os.cpu_count() or 1
    for solver in ("dense", "cg"):
        for s in shards:
            mesh = mesh_mod.make_mesh(s)
            run = lambda: sharded_ba.distributed_bundle_adjust(
                prob, mesh, n_iters=args.iters, solver=solver
            )
            res = run()
            jax.block_until_ready(res.poses)
            t0 = time.perf_counter()
            n_rep = 3
            for _ in range(n_rep):
                res = run()
            jax.block_until_ready(res.poses)
            dt = (time.perf_counter() - t0) / n_rep
            iters_sec = args.iters / dt
            results[solver][s] = iters_sec
            # On a shared-core virtual mesh, speedup beyond the physical core
            # count is impossible by construction; normalize to the
            # achievable parallelism so "efficiency" measures collective +
            # load-balance overhead, not the host's core budget.
            achievable = min(s, n_cores) if args.one_thread_per_device else 1
            base = results[solver].get(1)
            eff = iters_sec / (base * achievable) if base and s > 1 else 1.0
            # without one-thread-per-device this is raw speedup vs 1 shard,
            # NOT an efficiency — label it honestly
            label = (
                f"efficiency={eff:.2f} (vs {achievable} core(s))"
                if args.one_thread_per_device
                else f"speedup={eff:.2f}"
            )
            print(
                f"[{solver}] shards={s}: {dt * 1e3:7.1f} ms / {args.iters} LM iters "
                f"-> {iters_sec:7.1f} iters/s  {label}",
                flush=True,
            )
    out = {
        "metric": "distributed BA LM iters/sec by shard count",
        "frames": F, "points": P, "edges": F * OBS,
        "results": {
            sol: {str(k): round(v, 2) for k, v in r.items()}
            for sol, r in results.items()
        },
        "physical_cores": n_cores,
        "one_thread_per_device": bool(args.one_thread_per_device),
        "crossover_note": (
        "dense's per-LM-iteration collective is the full (F*6)^2 reduced "
        "system replicated by psum - O(F^2) bytes per device per iteration, "
        "so its throughput DEGRADES with shard count while CG's one (F,6) "
        "psum per CG step scales; distributed_bundle_adjust(solver='auto') "
        "picks dense <= 2 shards, cg beyond (the measured crossover)"
    ),
    "note": (
            "virtual CPU mesh shares physical cores; efficiency is "
            "normalized to min(shards, cores) threads when "
            "one_thread_per_device, else raw iters/sec only — absolute "
            "scaling numbers require a real multi-chip slice"
        ),
        "devices": str(jax.devices()[0]),
        "cg_comm_model": {
            "bytes_per_cg_iter_per_direction": cg_comm_bytes_per_iter(F),
            "formula": "4 * 6 * F (one (F,6) f32 psum per CG step; no F^2 or P terms)",
            "hlo_check": "tests/test_comm_volume.py",
        },
    }
    s_json = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(json.dumps(out, indent=1) + "\n")
    print(s_json)


if __name__ == "__main__":
    main()
