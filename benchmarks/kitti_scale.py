"""KITTI-scale benchmark: 10k-keyframe pose graph + (F=1k, P=100k) CG BA.

Demonstrates the matrix-free paths at the scale they were written for
(SURVEY.md §5.7, BASELINE.json configs[3]): a loop-closing Sim3 pose graph
with 10,000 keyframes through `pose_graph.optimize_cg` (and the sharded
variant when >1 device), and a 1,000-frame / 100,000-landmark / 1.5M-edge
global BA through `cg_ba.bundle_adjust_cg`. Reports seconds per LM iteration,
chi2 reduction, and device memory. Writes JSON to --out.

    python benchmarks/kitti_scale.py --out .data/kitti_scale.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_mem_mb():
    import jax

    try:
        s = jax.local_devices()[0].memory_stats()
        return round(s.get("bytes_in_use", 0) / 1e6, 1)
    except Exception:
        return None


def compiled_mem_mb(compiled):
    """Peak program memory from XLA's own memory analysis (argument +
    output + temp)."""
    try:
        m = compiled.memory_analysis()
        tot = (
            getattr(m, "argument_size_in_bytes", 0)
            + getattr(m, "output_size_in_bytes", 0)
            + getattr(m, "temp_size_in_bytes", 0)
        )
        return round(tot / 1e6, 1) if tot else None
    except Exception:
        return None


def _make_pose_graph(n_kf: int, n_loops: int):
    import jax
    import jax.numpy as jnp

    from monocular_slam_tpu.geometry import sim3, so3
    from monocular_slam_tpu.optim import pose_graph as pg

    key = jax.random.PRNGKey(0)
    # drifting circular trajectory with loop closures back to the start
    ang = jnp.arange(n_kf) * (2 * jnp.pi / (n_kf / 4))
    t = jnp.stack([jnp.sin(ang) * 50, jnp.zeros(n_kf), jnp.cos(ang) * 50], -1)
    rot = jnp.stack([jnp.zeros(n_kf), ang, jnp.zeros(n_kf)], -1)
    verts = sim3.pack(jax.vmap(so3.exp)(rot), t, jnp.ones(n_kf))
    # drift: accumulating odometry error (the regime a loop closure corrects),
    # not i.i.d. jitter — sized so LM has real work for the whole iteration
    # budget instead of stalling after 2-3 steps
    step_noise = 0.01 * jax.random.normal(key, (n_kf, 7))
    noise = jnp.cumsum(step_noise.at[0].set(0.0), axis=0)
    verts_n = sim3.compose(sim3.exp(noise), verts)

    # loop edges: frame i ~ frame i - n_kf//4 (one revolution)
    gap = n_kf // 4
    li = jnp.arange(gap, n_kf, max(1, n_kf // max(n_loops, 1)), dtype=jnp.int32)
    lj = li - gap
    meas = sim3.compose(verts[li], sim3.inverse(verts[lj]))
    return pg.sequential_graph(verts_n, jnp.ones(n_kf, bool), li, lj, meas)


def bench_pose_graph(n_kf: int, n_loops: int, iters: int):
    import jax

    from monocular_slam_tpu.optim import pose_graph as pg

    g = _make_pose_graph(n_kf, n_loops)
    f = jax.jit(lambda g_: pg.optimize_cg(g_, n_iters=iters))
    res = f(g)
    jax.block_until_ready(res.vertices)
    n_rep = 3
    t0 = time.perf_counter()
    for _ in range(n_rep):
        res = f(g)
        jax.block_until_ready(res.vertices)
    dt = (time.perf_counter() - t0) / n_rep
    # honest throughput: LM freezes into a no-op branch once improvement
    # stalls, so divide wall time by iterations actually EXECUTED
    n_run = int(res.n_iters_run)
    return {
        "n_keyframes": n_kf,
        "n_edges": int(g.i_idx.shape[0]),
        "lm_iters_requested": iters,
        "lm_iters_run": n_run,
        "sec_per_executed_lm_iter": round(dt / max(n_run, 1), 6),
        "executed_iters_per_sec": round(max(n_run, 1) / dt, 2),
        "chi2_initial": float(res.chi2_initial),
        "chi2_final": float(res.chi2_history[-1]),
        "mem_mb": device_mem_mb(),
    }


def _make_ba_problem(F: int, P: int, obs_per_frame: int):
    import jax
    import jax.numpy as jnp

    from monocular_slam_tpu.geometry import camera, se3, so3
    from monocular_slam_tpu.optim import ba

    key = jax.random.PRNGKey(1)
    kx, kn, kp, kt, kpt = jax.random.split(key, 5)
    # cameras orbit a point cloud at the origin, always looking inward: every
    # landmark sits comfortably in front of every camera (depths ~50-110),
    # so the synthetic graph is well-conditioned like a real survey rig —
    # a random box of points around the trajectory leaves most observations
    # behind the camera and every LM step gets rejected.
    X = 30.0 * jax.random.ball(kx, 3, shape=(P,))
    k = jnp.array([718.856, 718.856, 607.19, 185.22])  # KITTI cam0
    radius = 80.0
    ang = jnp.arange(F) * (2 * jnp.pi / F)

    def cam_pose(a):
        c = jnp.array([radius * jnp.sin(a), 0.0, -radius * jnp.cos(a)])
        z = -c / jnp.linalg.norm(c)
        x = jnp.cross(jnp.array([0.0, 1.0, 0.0]), z)
        x = x / jnp.linalg.norm(x)
        y = jnp.cross(z, x)
        R = jnp.stack([x, y, z])
        return se3.from_Rt(R, -R @ c)

    poses = jax.vmap(cam_pose)(ang)
    E = F * obs_per_frame
    cam_idx = jnp.repeat(jnp.arange(F, dtype=jnp.int32), obs_per_frame)
    pt_idx = jax.random.randint(kp, (E,), 0, P, dtype=jnp.int32)
    uv = camera.project(k, se3.apply(poses[cam_idx], X[pt_idx]))
    uv = uv + 0.5 * jax.random.normal(kn, uv.shape)
    prob = ba.BAProblem(
        poses=se3.compose(se3.exp(0.005 * jax.random.normal(kt, (F, 6))), poses),
        points=X + 0.1 * jax.random.normal(kpt, X.shape),
        k=jnp.broadcast_to(k, (F, 4)),
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        uv=uv,
        info=jnp.ones(E),
        valid=jnp.ones(E, bool),
        fixed=jnp.zeros(F, bool).at[0].set(True),
    )
    return prob


def bench_cg_ba(F: int, P: int, obs_per_frame: int, iters: int):
    import jax
    import numpy as np

    from monocular_slam_tpu.optim import cg_ba

    prob = _make_ba_problem(F, P, obs_per_frame)
    E = int(prob.cam_idx.shape[0])
    fn = lambda p: cg_ba.bundle_adjust_cg(p, n_iters=iters, max_cg_iters=50)
    compiled = jax.jit(fn).lower(prob).compile()
    res = compiled(prob)
    jax.block_until_ready(res.poses)
    t0 = time.perf_counter()
    res = compiled(prob)
    jax.block_until_ready(res.poses)
    dt = time.perf_counter() - t0
    n_run = int(res.n_iters_run)
    hist = [float(c) for c in res.chi2_history]
    # convergence accounting: LM freezes into a no-op branch when the
    # relative improvement stalls (the g2o/ORB-SLAM stop criterion shape);
    # also report the STATISTICAL floor — with pixel noise sigma the
    # converged chi2 of E 2-dof Gaussian residuals is ~ 2 sigma^2 E, so
    # "converged" is checkable, not an aesthetic judgement.
    sigma = 0.5
    floor = 2.0 * sigma * sigma * E
    # first iteration after which improvement is < 0.1% for good
    conv_at = n_run
    for ii in range(1, len(hist)):
        if hist[ii - 1] - hist[ii] < 1e-3 * hist[ii - 1]:
            conv_at = ii
            break
    return {
        "n_frames": F,
        "n_points": P,
        "n_edges": E,
        "lm_iters_requested": iters,
        "lm_iters_run": n_run,
        "sec_per_executed_lm_iter": round(dt / max(n_run, 1), 6),
        "executed_iters_per_sec": round(max(n_run, 1) / dt, 2),
        "chi2_initial": float(res.chi2_initial),
        "chi2_final": hist[-1],
        "chi2_history": [round(c, 1) for c in hist],
        "chi2_statistical_floor": round(floor, 1),
        "converged_at_iter": conv_at,
        "converged_to_floor": bool(hist[-1] <= 1.5 * floor),
        "mem_mb": device_mem_mb(),
        "program_peak_mem_mb": compiled_mem_mb(compiled),
        "problem_mb": round(sum(
            np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(prob)
        ) / 1e6, 1),
    }


def bench_cg_ba_cpu_yardstick(F, P, obs_per_frame, n_lm=2):
    """The SAME solver on one host CPU — a measured yardstick: a g2o/Ceres-class sparse CPU solver at this scale runs
    seconds-per-LM-iteration (its per-iteration work is ~0.8 GFLOP of
    buildSystem + ~2 GFLOP of per-landmark Schur products + a sparse
    6kx6k Cholesky with fill-in, on a ~5 GFLOP/s core); measuring OUR
    matrix-free CG on the CPU brackets the hardware-vs-algorithm split."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        import jax.numpy as jnp  # noqa: F401

        from monocular_slam_tpu.optim import cg_ba

        prob = _make_ba_problem(F, P, obs_per_frame)
        f = jax.jit(lambda p: cg_ba.bundle_adjust_cg(p, n_iters=n_lm, max_cg_iters=50))
        res = f(prob)
        jax.block_until_ready(res.poses)
        t0 = time.perf_counter()
        res = f(prob)
        jax.block_until_ready(res.poses)
        dt = time.perf_counter() - t0
        n_run = max(int(res.n_iters_run), 1)
    return {
        "sec_per_executed_lm_iter": round(dt / n_run, 3),
        "n_lm_measured": n_run,
        "note": "same matrix-free CG solver on the host CPU (all cores)",
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--keyframes", type=int, default=10000)
    p.add_argument("--loops", type=int, default=100)
    p.add_argument("--ba-frames", type=int, default=1000)
    p.add_argument("--ba-points", type=int, default=100000)
    p.add_argument("--obs-per-frame", type=int, default=1500)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--cpu-yardstick", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import jax

    out = {"device": str(jax.devices()[0])}
    print("[kitti_scale] pose graph ...", file=sys.stderr, flush=True)
    out["pose_graph_cg_10k"] = bench_pose_graph(args.keyframes, args.loops, args.iters)
    print(json.dumps(out["pose_graph_cg_10k"]), file=sys.stderr, flush=True)
    print("[kitti_scale] CG BA ...", file=sys.stderr, flush=True)
    out["global_ba_cg"] = bench_cg_ba(
        args.ba_frames, args.ba_points, args.obs_per_frame, args.iters
    )
    print(json.dumps(out["global_ba_cg"]), file=sys.stderr, flush=True)
    if args.cpu_yardstick:
        print("[kitti_scale] CPU yardstick ...", file=sys.stderr, flush=True)
        out["global_ba_cg_cpu_yardstick"] = bench_cg_ba_cpu_yardstick(
            args.ba_frames, args.ba_points, args.obs_per_frame
        )
        dev_s = out["global_ba_cg"]["sec_per_executed_lm_iter"]
        cpu_s = out["global_ba_cg_cpu_yardstick"]["sec_per_executed_lm_iter"]
        out["global_ba_cg_cpu_yardstick"]["device_speedup"] = round(cpu_s / dev_s, 2)
        out["global_ba_cg_cpu_yardstick"]["analytic_note"] = (
            "a g2o-class sparse CPU solver at F=1k/P=100k/E=1.5M spends per LM "
            "iteration ~0.8 GFLOP building the system + ~2 GFLOP on per-landmark "
            "Schur products + a sparse 6k x 6k Cholesky with fill-in "
            "(block_solver.hpp:373-479): seconds/iter on one core; ours is "
            "matrix-free CG (never forms Hschur) so the comparison brackets "
            "hardware vs algorithm"
        )
        print(json.dumps(out["global_ba_cg_cpu_yardstick"]), file=sys.stderr, flush=True)
    s = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(s + "\n")
    print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
