"""Benchmark: the flagship metrics (BASELINE.json.metric) on one NVIDIA GPU.
Exits non-zero when JAX finds no GPU: a CPU timing is not a device metric.

  1. frames/sec of the fused tracking + windowed-local-BA step (device-bound
     kernel metric, 1000 features/frame).
  2. frames/sec of the FULL image pipeline on a TUM-format dataset on disk:
     PNG load -> ORB extraction -> PnP tracking -> local BA (the reference's
     per-frame loop, `src/main.cpp:48-51`), plus its ATE.
  3. BA iters/sec: LM iterations/sec of the windowed local BA solve (the
     g2o `G2OBatchStatistics` analog).

Prints ONE JSON line. The flagship `metric`/`value`/`vs_baseline` is the
IMAGE PIPELINE fps (the BASELINE.json metric); the fused kernel-path fps is
reported separately as `kernel_fps` (a device-bound upper bound, not the
product number).

Baseline note: the C++ reference publishes no numbers (BASELINE.md) and its
2013-era dependency stack (OpenCV 2.4 nonfree, PCL, boost) cannot be built in
this image, so the denominator is a documented estimate: ~10 fps for
single-threaded C++ ORB tracking with per-frame pose refinement on a modern
x86 core (its per-frame global BA mode is far slower, O(T^2) over the run —
SURVEY.md 5.7). vs_baseline = fps / 10.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

REFERENCE_FPS_ESTIMATE = 10.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_fused_step(cfg, seq, warm_state):
    """Steady-state fused (track + local BA) step, chained on device."""
    from monocular_slam_tpu.slam import local_ba, tracker

    @jax.jit
    def frame_step(state, i, key):
        tres = tracker.track(state, i, key, cfg)
        bres = local_ba.local_bundle_adjust(tres.state, i, cfg)
        return bres.state

    key = jax.random.PRNGKey(7)
    i = jnp.asarray(39, jnp.int32)
    out = frame_step(warm_state, i, key)
    jax.block_until_ready(out.poses)

    n_rep = 30
    t0 = time.perf_counter()
    cur = warm_state
    for r in range(n_rep):
        cur = frame_step(cur, i, jax.random.fold_in(key, r))
    jax.block_until_ready(cur.poses)
    return (time.perf_counter() - t0) / n_rep


def bench_ba_iters(cfg, warm_state):
    """LM iterations/sec of the windowed local BA (BA iters/sec metric)."""
    from monocular_slam_tpu.slam import local_ba

    @jax.jit
    def ba_only(state, i):
        return local_ba.local_bundle_adjust(state, i, cfg).state

    i = jnp.asarray(39, jnp.int32)
    out = ba_only(warm_state, i)
    jax.block_until_ready(out.poses)
    n_rep = 30
    t0 = time.perf_counter()
    cur = warm_state
    for _ in range(n_rep):
        cur = ba_only(cur, i)
    jax.block_until_ready(cur.poses)
    dt = (time.perf_counter() - t0) / n_rep
    return cfg.ba.local_iters / dt, dt


def bench_rooflines(cfg, warm_state, step_dt, ba_dt):
    """Per-kernel roofline/MFU table (BASELINE.json "speed-of-light" clause):
    XLA cost-model flops+bytes over measured wall time vs device peaks, for
    the four hot programs — fused session step, Hamming matcher, FAST corner
    maps, and the windowed local-BA solve."""
    from functools import partial

    from monocular_slam_tpu.ops import features as features_mod, matching
    from monocular_slam_tpu.slam import local_ba, session as session_mod
    from monocular_slam_tpu.utils import roofline

    peaks = roofline.device_peaks()
    key = jax.random.PRNGKey(7)
    i = jnp.asarray(39, jnp.int32)
    lkf = jnp.asarray(20, jnp.int32)
    out = {}

    def timed(fn, args, n=30):
        c = jax.jit(fn).lower(*args).compile()
        o = c(*args)
        jax.block_until_ready(jax.tree_util.tree_leaves(o)[0])
        t0 = time.perf_counter()
        for _ in range(n):
            o = c(*args)
        jax.block_until_ready(jax.tree_util.tree_leaves(o)[0])
        return c, (time.perf_counter() - t0) / n

    # fused session step (keyframe path: the expensive variant), measured
    # wall passed in from the chained benchmark
    step_c = jax.jit(
        lambda st: session_mod._session_step(st, i, lkf, key, cfg, True)[0]
    ).lower(warm_state).compile()
    out["session_step"] = roofline.analyze(step_c, step_dt, peaks).as_dict()

    ba_c = jax.jit(
        lambda st: local_ba.local_bundle_adjust(st, i, cfg).state
    ).lower(warm_state).compile()
    out["local_ba"] = roofline.analyze(ba_c, ba_dt, peaks).as_dict()

    st = warm_state
    m_c, m_dt = timed(
        lambda a, b, va, vb: matching.match(a, b, va, vb, ratio=0.8, max_dist=80),
        (st.desc_pm1[10], st.desc_pm1[11], st.kp_valid[10], st.kp_valid[11]),
    )
    out["matcher_1kx1k"] = roofline.analyze(m_c, m_dt, peaks).as_dict()

    img = jax.random.uniform(jax.random.PRNGKey(3), (480, 640), jnp.float32) * 255.0
    from monocular_slam_tpu.ops import fast

    f_c, f_dt = timed(
        lambda im: (fast.nms3(fast.corner_score(im, 20.0)),
                    fast.corner_score_raw(im)), (img,))
    out["fast_640x480"] = roofline.analyze(f_c, f_dt, peaks).as_dict()

    e_c, e_dt = timed(
        partial(features_mod.extract, n_features=cfg.frontend.n_features), (img,)
    )
    out["extract_640x480"] = roofline.analyze(e_c, e_dt, peaks).as_dict()

    log(f"-- roofline ({peaks.name}: {peaks.peak_flops/1e12:.0f} TF/s bf16, "
        f"{peaks.peak_bw/1e9:.0f} GB/s, {peaks.source}; card power limit "
        f"{roofline.name_power_limit()[0]}) --")
    for name, r in out.items():
        log(f"  {name:16s} {r['wall_ms']:8.3f} ms  {r['flops']/1e9:8.2f} GF  "
            f"AI {r['intensity_flop_per_byte']:7.1f}  mfu {r['mfu']*100:5.1f}%  "
            f"hbm {r['hbm_frac']*100:5.1f}%  {r['bound']}-bound, "
            f"{r['sol_frac']*100:5.1f}% of roof")
    return out


def bench_image_pipeline(n_feat: int):
    """Image pipeline (ORB -> track -> BA) on a rendered TUM-format dataset.

    Frames are decoded on the host and PRELOADED into one device-resident
    (N, H, W) HBM buffer before the loop — exact methodology parity with the
    reference, whose FrameLoader reads every image into RAM before its
    per-frame loop starts (`src/main.cpp:35-37`); the timed loop is the
    `main.cpp:48-51` analog and does zero host->device transfers. Decode +
    upload cost is measured and reported separately (ingest_ms_per_frame).
    Returns (fps, ate_m, tracked, n_frames, warmup_s, ingest_ms_per_frame).
    """
    from monocular_slam_tpu.datasets import render, tum
    from monocular_slam_tpu.eval import ate as ate_mod
    from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu.slam.session import SlamSession
    import numpy as np

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".data", "bench_tum")
    vfile = os.path.join(root, "VERSION")
    cached_v = open(vfile).read().strip() if os.path.exists(vfile) else None
    if not os.path.exists(os.path.join(root, "rgb.txt")) or cached_v != str(
        render.RENDER_VERSION
    ):
        log("rendering TUM-format benchmark dataset ...")
        render.export_tum(root, key=jax.random.PRNGKey(11), n_frames=60, wh=(640, 480))
    seq = tum.load(root)
    n = len(seq.frames)
    cfg = SlamConfig(
        max_frames=64,
        max_points=20000,
        image_wh=(640, 480),
        frontend=FrontendConfig(n_features=n_feat),
    )

    # ingest: threaded native PNG decode + ONE HBM upload (FrameLoader parity)
    t0 = time.perf_counter()
    imgs = np.stack(seq.load_images_batch(range(n)))
    buf = jax.device_put(imgs)
    jax.block_until_ready(buf)
    ingest_ms = (time.perf_counter() - t0) / n * 1e3

    # pass 1: warmup/compile (parallel ahead-of-time program compiles,
    # then one full pass)
    t0 = time.perf_counter()
    sess = SlamSession(cfg, seed=1, run_ba=True)
    sess.prewarm(image=True)
    for i in range(n):
        sess.add_frame_from_buffer(buf, i, seq.k, seq.frames[i].timestamp)
    jax.block_until_ready(sess.state.poses)
    warmup_s = time.perf_counter() - t0

    # pass 2: fresh session; fps measured over the STEADY tail (after frame
    # `skip`) so one-time costs — re-tracing the new session's jit closures
    # and loading the persistent compile cache — land in warmup where they
    # belong, not amortized into the throughput number
    def timed_pass(loop_closer=None):
        skip = 10
        sess = SlamSession(cfg, seed=1, run_ba=True, loop_closer=loop_closer)
        for i in range(skip):
            sess.add_frame_from_buffer(buf, i, seq.k, seq.frames[i].timestamp)
        jax.block_until_ready(sess.state.poses)
        t0 = time.perf_counter()
        for i in range(skip, n):
            sess.add_frame_from_buffer(buf, i, seq.k, seq.frames[i].timestamp)
        jax.block_until_ready(sess.state.poses)
        wall = time.perf_counter() - t0
        return sess, (n - skip) / wall

    sess, fps = timed_pass()
    poses, valid, _ = sess.trajectory()
    gt = np.stack([f.pose_gt for f in seq.frames])
    r = ate_mod.ate(poses[valid], gt[: len(valid)][valid])

    # loop-closure-attached fps: same pipeline with the
    # bundled vocabulary + LoopCloser. Detection runs at keyframe rate and
    # the per-frame cost is the tracked/keyframe scalar syncs.
    from monocular_slam_tpu.retrieval import vocabulary as vocab_mod
    from monocular_slam_tpu.slam.loop_closer import LoopCloser

    lc = LoopCloser(voc=vocab_mod.load_default(), cfg=cfg)
    lc_sess, lc_fps = timed_pass(loop_closer=lc)
    lc_poses, lc_valid, _ = lc_sess.trajectory()
    lc_r = ate_mod.ate(lc_poses[lc_valid], gt[: len(lc_valid)][lc_valid])

    # overlapped ingest: disk-PNG -> pose with the threaded
    # native decoder PREFETCHING ahead of the device — decode+upload of
    # frame i+depth overlaps the device step of frame i, so end-to-end-from-
    # disk throughput approaches the preloaded-HBM fps instead of
    # serializing host decode behind each device step.
    def overlapped_pass(depth: int = 6):
        from concurrent.futures import ThreadPoolExecutor

        skip = 10
        sess = SlamSession(cfg, seed=1, run_ba=True)
        with ThreadPoolExecutor(2) as ex:
            futs = {
                i: ex.submit(lambda j=i: jax.device_put(seq.load_image(j)))
                for i in range(min(depth, n))
            }

            def get(i):
                img = futs.pop(i).result()
                nxt = i + depth
                if nxt < n:
                    futs[nxt] = ex.submit(
                        lambda j=nxt: jax.device_put(seq.load_image(j))
                    )
                return img

            for i in range(skip):
                sess.add_frame(get(i), seq.k, seq.frames[i].timestamp)
            jax.block_until_ready(sess.state.poses)
            t0 = time.perf_counter()
            for i in range(skip, n):
                sess.add_frame(get(i), seq.k, seq.frames[i].timestamp)
            jax.block_until_ready(sess.state.poses)
            return (n - skip) / (time.perf_counter() - t0)

    ingest_ov_fps = overlapped_pass()
    return (fps, float(r.rmse), int(valid.sum()), n, warmup_s, ingest_ms,
            lc_fps, ingest_ov_fps, float(lc_r.rmse))


def main():
    from monocular_slam_tpu.utils import roofline

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {dev.platform!r}")
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": jax.device_count(),
        "name_power_limit": roofline.name_power_limit()[0],
    }
    log("device:", device)

    from monocular_slam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from monocular_slam_tpu.datasets import synthetic
    from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu.slam.session import SlamSession

    # Reference-scale workload: 1000 features/frame, 5-frame back-traverse,
    # 8-frame local BA window (reference processes 100 frames @ ~1000 ORB
    # features, `src/main.cpp:35`, OpenCV ORB defaults).
    n_feat = 1000
    cfg = SlamConfig(
        max_frames=64, max_points=20000, frontend=FrontendConfig(n_features=n_feat)
    )
    seq = synthetic.feature_sequence(
        jax.random.PRNGKey(0),
        n_frames=40,
        n_world_points=2500,
        n_features=n_feat,
        pix_noise=0.3,
        drop_prob=0.08,
    )
    t0 = time.perf_counter()
    sess = SlamSession(cfg, seed=1, run_ba=True)
    sess.prewarm(image=False)
    tracked = 0
    for i, f in enumerate(seq.frames):
        st = sess.add_frame_features(f, seq.k, seq.timestamps[i])
        tracked += int(st.tracked)
    warmup_feat = time.perf_counter() - t0
    log(f"warmup+compile (feature path): {warmup_feat:.1f}s, tracked {tracked}/40")

    dt = bench_fused_step(cfg, seq, sess.state)
    fps = 1.0 / dt

    ba_ips, ba_dt = bench_ba_iters(cfg, sess.state)
    log(f"fused step {dt * 1e3:.1f} ms -> {fps:.1f} fps; local BA {ba_dt * 1e3:.1f} ms "
        f"-> {ba_ips:.0f} LM iters/sec")

    rooflines = bench_rooflines(cfg, sess.state, dt, ba_dt)

    # ATE sanity on the warmup run (synthetic feature path)
    import numpy as np

    from monocular_slam_tpu.eval import ate

    poses, valid, _ = sess.trajectory()
    r = ate.ate(poses[valid], np.asarray(seq.poses_gt)[valid])
    log(f"feature-path ATE {r.rmse * 1e3:.2f} mm")

    (img_fps, img_ate, img_tracked, img_n, warmup_img, ingest_ms,
     lc_fps, ingest_ov_fps, lc_ate) = bench_image_pipeline(n_feat)
    log(f"image pipeline {img_fps:.1f} fps, ATE {img_ate * 100:.2f} cm, "
        f"tracked {img_tracked}/{img_n}, warmup {warmup_img:.1f}s, "
        f"ingest {ingest_ms:.1f} ms/frame, with-loop-closer {lc_fps:.1f} fps "
        f"(ATE {lc_ate * 100:.2f} cm), overlapped-ingest {ingest_ov_fps:.1f} fps")

    print(
        json.dumps(
            {
                # flagship = the BASELINE.json metric: full image pipeline
                # (disk PNG -> ORB -> PnP -> local BA), fps + ATE, vs the
                # DOCUMENTED ~10 fps estimate for the unbuildable 2013-stack
                # C++ reference (see module docstring)
                "metric": "image pipeline fps (ORB->track->BA, 640x480, frames preloaded to HBM like the reference's FrameLoader preloads to RAM)",
                "value": round(img_fps, 2),
                "unit": "fps",
                "vs_baseline": round(img_fps / REFERENCE_FPS_ESTIMATE, 2),
                "baseline_note": "reference estimate 10 fps = conservative end of the 10-29 fps per-stage decomposition in BASELINE.md (unbuildable 2013 OpenCV2.4/PCL stack); both sides exclude image load from the per-frame loop (src/main.cpp:35-37 preloads before :48-51)",
                "image_pipeline_ate_cm": round(img_ate * 100, 3),
                "image_pipeline_tracked": f"{img_tracked}/{img_n}",
                "image_warmup_s": round(warmup_img, 1),
                "ingest_ms_per_frame": round(ingest_ms, 2),
                # disk->pose with decode prefetched ahead of the device
                # (no HBM preload): proves ingest OVERLAPS device compute
                "ingest_overlapped_fps": round(ingest_ov_fps, 2),
                "lc_fps": round(lc_fps, 2),
                "lc_ate_cm": round(lc_ate * 100, 3),
                "kernel_fps": round(fps, 2),
                "kernel_ate_mm": round(r.rmse * 1e3, 3),
                "kernel_tracked": f"{int(valid.sum())}/{len(valid)}",
                "ba_iters_per_sec": round(ba_ips, 1),
                "warmup_s": round(warmup_feat, 1),
                "device": device,
                # per-kernel roofline/MFU (BASELINE.json speed-of-light
                # clause): XLA cost-model flops+bytes over measured wall vs
                # device peaks; "bound" names the nearer wall, sol_frac the
                # distance to it
                "mfu": rooflines["session_step"]["mfu"],
                "rooflines": rooflines,
            }
        )
    )


if __name__ == "__main__":
    main()
