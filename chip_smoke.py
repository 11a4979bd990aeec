"""Smoke run of the SLAM system on NVIDIA GPUs, against plain references.

    python chip_smoke.py           # one card: main path, stages, memory
    python chip_smoke.py --four    # four cards: sharded solvers only

One process, no fallback: every phase either passes or raises, and any
failure exits non-zero without printing a result.

One card:
  device  the first JAX device must be a GPU; prints its kind, the device
          count, the JAX version and `nvidia-smi`'s name and power limit.
  main    renders a 60-frame 640x480 TUM-format orbit from a fixed seed and
          runs the CLI (`monocular_slam_tpu.run.main`) on it at ORB-SLAM2's
          TUM settings with loop closure: PNG decode -> upload -> ORB
          extraction -> PnP tracking -> local BA -> BoW loop detection.
          Requires >= 57/60 tracked, ATE < 2 cm, the native decoder, no PIL.
  stages  each stage on the GPU against the plain reference: ORB extraction
          against the same program on the CPU device, the Hamming matcher
          against a numpy brute-force top-2, and bundle adjustment against
          the float64 golden fixture.
  memory  `memory_analysis()` of the session's compiled per-frame image
          program and the device's peak bytes in use.

Four cards (--four): landmark-sharded global BA and edge-sharded pose-graph
optimization on a 4-card mesh (every card on the landmark/edge axis),
against the single-card solvers on the same problems.

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, ".data")
BA_FIXTURE = os.path.join(HERE, "tests", "fixtures", "ba_problem.npz")
BA_EXPECTED = os.path.join(HERE, "tests", "fixtures", "ba_expected.npz")

# main-path bar: the CPU rehearsal tracks 60/60 at 0.41 cm; the margin covers
# another summation order and TF32, not a broken tracker
MIN_TRACKED, N_FRAMES, MAX_ATE_M = 57, 60, 0.02
# extraction: f32 blur/orientation sums in another order can flip a bit or
# move a corner across a tie
MIN_RECALL, MIN_DESC_EQUAL = 0.99, 0.99
# bundle adjustment, f32 on the device against the float64 golden solve
BA_POSE_L2, BA_POINT_L2, BA_CHI2_RTOL = 1e-3, 1e-2, 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


# --- device -----------------------------------------------------------------


def check_device(count: int) -> jax.Device:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}")
    if jax.device_count() < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {jax.device_count()}")
    log(f"[device] platform={dev.platform} kind={dev.device_kind} "
        f"count={jax.device_count()} jax={jax.__version__}")
    from monocular_slam_tpu.utils.roofline import name_power_limit

    for line in name_power_limit():
        log(line)
    return dev


# --- main path --------------------------------------------------------------


def run_main_path() -> dict:
    """The CLI on a rendered TUM-format orbit; returns its JSON summary."""
    from monocular_slam_tpu import native, run
    from monocular_slam_tpu.datasets import render

    root = os.path.join(DATA, "smoke_tum")
    t0 = time.perf_counter()
    render.export_tum(root, key=jax.random.PRNGKey(11), n_frames=N_FRAMES, wh=(640, 480))
    log(f"[main] rendered {N_FRAMES} frames 640x480 in {time.perf_counter() - t0:.1f}s")

    # the CLI's trajectory plot is best-effort and matplotlib imports PIL;
    # keep it out so the PIL check below sees only the decode path
    sys.modules["matplotlib"] = None
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main([
            "--dataset", root, "--out", os.path.join(DATA, "smoke_out"),
            "--features", "1000", "--max-frames", "64", "--max-points", "20000",
            "--start", "0", "--end", str(N_FRAMES), "--step", "1",
            "--loop-closure", "--vocab", "default",
        ])
    log(out.getvalue().rstrip())
    check(rc == 0, f"run.main returned {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    check(summary["frames"] == N_FRAMES, f"frames {summary['frames']} != {N_FRAMES}")
    check(summary["tracked"] >= MIN_TRACKED,
          f"tracked {summary['tracked']}/{N_FRAMES} < {MIN_TRACKED}")
    check(summary["ate_rmse"] < MAX_ATE_M, f"ATE {summary['ate_rmse']} m >= {MAX_ATE_M}")
    check(native.available(), "native PNG decoder unavailable (decode fell back)")
    check("PIL" not in sys.modules, "PIL was imported on the main path")
    log(f"[main] ok: tracked {summary['tracked']}/{N_FRAMES}, "
        f"ATE {summary['ate_rmse'] * 100:.3f} cm, wall {summary['wall_s']} s")
    return summary


# --- stages against the plain reference -------------------------------------


def compare_extract(imgs, n_features: int, dev, ref_dev) -> dict:
    """`ops.features.extract` on `dev` against the same program on `ref_dev`.
    Keypoints pair up when they share a pyramid level and lie within 1 px
    (level-0 pixels); returns the worst recall in either direction and the
    worst fraction of paired keypoints with bit-equal descriptors."""
    from monocular_slam_tpu.ops import features

    fn = jax.jit(partial(features.extract, n_features=n_features))
    recall, desc_eq = 1.0, 1.0
    for img in imgs:
        a, b = (
            jax.device_get(fn(jax.device_put(jnp.asarray(img, jnp.float32), d)))
            for d in (dev, ref_dev)
        )
        va, vb = np.asarray(a.valid), np.asarray(b.valid)
        check(va.sum() > 0 and vb.sum() > 0, "extraction found no keypoints")
        ua, ub = np.asarray(a.uv)[va], np.asarray(b.uv)[vb]
        sa, sb = np.asarray(a.scale)[va], np.asarray(b.scale)[vb]
        d2 = np.sum((ua[:, None, :] - ub[None, :, :]) ** 2, axis=-1)
        d2 = np.where(sa[:, None] == sb[None, :], d2, np.inf)
        near = d2 <= 1.0
        recall = min(recall, near.any(1).mean(), near.any(0).mean())
        pair = np.argmin(d2, axis=1)
        has = near.any(1)
        da, db = np.asarray(a.desc)[va][has], np.asarray(b.desc)[vb][pair[has]]
        desc_eq = min(desc_eq, np.all(da == db, axis=1).mean())
    return {"recall_1px": float(recall), "desc_equal": float(desc_eq)}


def random_descriptors(n: int, m: int, seed: int):
    """±1 int8 descriptors: B holds noisy copies of most of A (real matches
    among distractors), and both sides carry a few invalid rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (n, 256), dtype=np.int8) * 2 - 1
    b = rng.integers(0, 2, (m, 256), dtype=np.int8) * 2 - 1
    k = min(n, m) * 3 // 4
    rows = rng.permutation(m)[:k]
    flips = np.where(rng.random((k, 256)) < 0.08, -1, 1).astype(np.int8)
    b[rows] = a[:k] * flips
    av = rng.random(n) > 0.02
    bv = rng.random(m) > 0.02
    return a.astype(np.int8), b.astype(np.int8), av, bv


def compare_match(n: int, m: int, dev, seed: int = 0, ratio: float = 0.8,
                  max_dist: int = 80) -> dict:
    """`ops.matching.match` on `dev` against the numpy brute-force top-2
    (`ops.reference.match_top2`): exact."""
    from monocular_slam_tpu.ops import matching, reference

    a, b, av, bv = random_descriptors(n, m, seed)
    fn = jax.jit(partial(matching.match, ratio=ratio, max_dist=max_dist))
    args = [jax.device_put(x, dev) for x in (a, b, av, bv)]
    out = jax.device_get(fn(*args))
    best, d1, ok = reference.match_top2(a, b, av, bv, ratio, max_dist)
    check(np.array_equal(np.asarray(out.idx), best), f"match {n}x{m}: idx differs")
    check(np.array_equal(np.asarray(out.dist), d1), f"match {n}x{m}: dist differs")
    check(np.array_equal(np.asarray(out.ok), ok), f"match {n}x{m}: ok differs")
    check(ok.sum() > 0, f"match {n}x{m}: no match passed (degenerate input)")
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"n_ok": int(ok.sum()), "median_ms": float(np.median(times) * 1e3)}


def compare_ba(dev, n_iters: int = 15) -> dict:
    """`optim.ba.bundle_adjust` in f32 on `dev` against the float64 golden
    solve (`tests/fixtures/ba_expected.npz`)."""
    from monocular_slam_tpu.io import snapshot
    from monocular_slam_tpu.optim import ba

    def f32(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return x.astype(np.float32)
        return x.astype(np.int32) if np.issubdtype(x.dtype, np.integer) else x

    prob = jax.tree_util.tree_map(f32, snapshot.load_ba_problem(BA_FIXTURE))
    res = jax.device_get(
        jax.jit(partial(ba.bundle_adjust, n_iters=n_iters))(jax.device_put(prob, dev))
    )
    exp = np.load(BA_EXPECTED)
    n_f = len(exp["poses"])
    pose_l2 = np.linalg.norm((res.poses - exp["poses"]).reshape(n_f, -1), axis=1).max()
    point_l2 = np.linalg.norm(res.points - exp["points"], axis=1).max()
    chi2 = float(res.chi2_history[-1])
    chi2_rel = abs(chi2 - float(exp["chi2_final"])) / float(exp["chi2_final"])
    out = {"pose_l2": float(pose_l2), "point_l2": float(point_l2), "chi2_rel": chi2_rel}
    check(pose_l2 <= BA_POSE_L2, f"BA pose L2 {pose_l2} > {BA_POSE_L2}")
    check(point_l2 <= BA_POINT_L2, f"BA point L2 {point_l2} > {BA_POINT_L2}")
    check(chi2_rel <= BA_CHI2_RTOL, f"BA chi2 rel {chi2_rel} > {BA_CHI2_RTOL}")
    return out


def run_stages(dev) -> None:
    from monocular_slam_tpu import native

    cpu = jax.devices("cpu")[0]
    root = os.path.join(DATA, "smoke_tum", "rgb")
    names = sorted(os.listdir(root))
    imgs = [native.load_png_f32(os.path.join(root, names[i])) for i in (0, 20, 40)]
    r = compare_extract(imgs, 1000, dev, cpu)
    log(f"[stages] extract 640x480x3 @1000: {r}")
    check(r["recall_1px"] >= MIN_RECALL, f"extract recall {r['recall_1px']} < {MIN_RECALL}")
    check(r["desc_equal"] >= MIN_DESC_EQUAL,
          f"extract descriptors equal {r['desc_equal']} < {MIN_DESC_EQUAL}")
    for n, m in ((1000, 1000), (2000, 20000)):
        log(f"[stages] match {n}x{m} exact vs numpy: {compare_match(n, m, dev)}")
    log(f"[stages] bundle_adjust f32 vs float64 golden: {compare_ba(dev)}")


def report_memory(dev) -> None:
    from monocular_slam_tpu.retrieval import vocabulary as vocab_mod
    from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu.slam.loop_closer import LoopCloser
    from monocular_slam_tpu.slam.session import SlamSession

    log(f"[memory] peak_bytes_in_use after main path: "
        f"{dev.memory_stats()['peak_bytes_in_use']}")
    # the CLI's configuration for the main-path sequence
    cfg = SlamConfig(
        max_frames=64, max_points=20000, image_wh=(640, 480),
        frontend=FrontendConfig(n_features=1000),
    )
    sess = SlamSession(cfg, loop_closer=LoopCloser(voc=vocab_mod.load_default(), cfg=cfg))
    log(f"[memory] image step memory_analysis: "
        f"{sess.lower_image_step().compile().memory_analysis()}")


# --- four cards ---------------------------------------------------------------


# --four sizes, from `benchmarks/kitti_scale.py`'s generators: the largest
# dense BA measured on one card (F=1200 keyframes, 120k points, 1.2M edges:
# 8.4 s for 10 LM iterations, 31 GB peak; memory, not time, is the limit)
# and a 40k-keyframe Sim3 pose graph (0.07 s on one card)
FOUR_BA = (1200, 120_000, 1000)  # frames, points, observations per frame
FOUR_PG = (40_000, 100)  # keyframes, loop edges
FOUR_ITERS = 10
# both sides f32: chi2 to 1e-3 relative; BA poses absolute (the cameras
# orbit at radius 80); graph vertices relative to the largest entry of the
# one-card solution (~240 at 40k keyframes), since f32 CG leaves the long
# chain's near-flat modes to rounding
FOUR_CHI2_RTOL, FOUR_POSE_ATOL, FOUR_VERTEX_RTOL = 1e-3, 1e-2, 1e-3


def run_four() -> None:
    """Sharded global BA and pose graph on 4 cards against one card."""
    from benchmarks.kitti_scale import _make_ba_problem, _make_pose_graph
    from monocular_slam_tpu.optim import ba, pose_graph as pg
    from monocular_slam_tpu.parallel import mesh as mesh_mod
    from monocular_slam_tpu.parallel import sharded_ba, sharded_pose_graph

    mesh = mesh_mod.make_mesh(4)  # (data=1, model=4): every card on the landmark axis
    one = jax.devices()[0]

    def timed(fn, *args):
        """(result, first call incl. compile, second call) seconds."""
        out, dts = None, []
        for _ in range(2):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            dts.append(time.perf_counter() - t0)
        return out, dts[0], dts[1]

    F, P, obs = FOUR_BA
    with jax.default_device(one):
        prob = _make_ba_problem(F, P, obs)
        ref, ref_first, ref_dt = timed(
            jax.jit(partial(ba.bundle_adjust, n_iters=FOUR_ITERS)), prob
        )
    # the solver distributed_bundle_adjust picks on 4 shards
    fn, args, P_orig = sharded_ba.build_sharded_fn(
        prob, mesh, n_iters=FOUR_ITERS, solver="cg"
    )
    (poses, _, chi2_0, chi2_h, _), d_first, d_dt = timed(fn, *args)
    chi2_ref, chi2_d = float(ref.chi2_history[-1]), float(chi2_h[-1])
    pose_diff = float(np.abs(np.asarray(poses) - np.asarray(ref.poses)).max())
    log(f"[four] BA F={F} P={P} E={F * obs}: one card {ref_dt:.3f}s "
        f"(first {ref_first:.1f}s) chi2 {float(ref.chi2_initial):.6g}->{chi2_ref:.6g}; "
        f"4 cards {d_dt:.3f}s (first {d_first:.1f}s) chi2 "
        f"{float(chi2_0):.6g}->{chi2_d:.6g}; max pose diff {pose_diff:.3g}")
    check(abs(chi2_d - chi2_ref) <= FOUR_CHI2_RTOL * chi2_ref,
          "sharded BA chi2 differs from one card")
    check(pose_diff <= FOUR_POSE_ATOL, f"sharded BA poses differ by {pose_diff}")

    n_kf, n_loops = FOUR_PG
    with jax.default_device(one):
        g = _make_pose_graph(n_kf, n_loops)
        ref, ref_first, ref_dt = timed(
            jax.jit(partial(pg.optimize_cg, n_iters=FOUR_ITERS)), g
        )
    # distributed_optimize builds its program per call: one call, compile included
    t0 = time.perf_counter()
    res = jax.block_until_ready(
        sharded_pose_graph.distributed_optimize(g, mesh, n_iters=FOUR_ITERS)
    )
    d_first = time.perf_counter() - t0
    chi2_ref, chi2_d = float(ref.chi2_history[-1]), float(res.chi2_history[-1])
    vdiff = float(np.abs(np.asarray(res.vertices) - np.asarray(ref.vertices)).max())
    vscale = float(np.abs(np.asarray(ref.vertices)).max())
    log(f"[four] pose graph {n_kf} keyframes: one card {ref_dt:.3f}s (first "
        f"{ref_first:.1f}s) chi2 {float(ref.chi2_initial):.6g}->{chi2_ref:.6g}; "
        f"4 cards {d_first:.1f}s incl. compile, chi2 {chi2_d:.6g}; "
        f"max vertex diff {vdiff:.3g} of max |vertex| {vscale:.4g}")
    check(chi2_d < float(res.chi2_initial), "sharded pose graph did not reduce chi2")
    check(abs(chi2_d - chi2_ref) <= FOUR_CHI2_RTOL * chi2_ref,
          "sharded pose graph chi2 differs")
    check(vdiff <= FOUR_VERTEX_RTOL * vscale,
          f"sharded pose graph vertices differ by {vdiff} (max |vertex| {vscale})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phase (sharded solvers vs one card)")
    args = p.parse_args(argv)

    dev = check_device(4 if args.four else 1)
    from monocular_slam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.four:
        run_four()
    else:
        run_main_path()
        report_memory(dev)
        run_stages(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": jax.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
