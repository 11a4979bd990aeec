"""Long-trajectory live-session benchmark (SURVEY §5.7).

Drives a ≥1,000-frame rendered multi-revolution orbit through a LIVE
SlamSession with the slot-recycled feature tier (max_slots << n_frames) and
a loop closer attached — the configs[3]-shaped capability the reference's
unbounded `DataManager` (`src/DataManager.h:25-35`) could never run: its
per-frame global BA is O(T^2) and its RAM grows linearly with frames, while
this session's feature memory is a fixed 256-slot pool recycled
keyframe-aware and its pose tier costs 12 floats/frame.

    python benchmarks/long_run.py [--frames 1000] [--slots 256]

Writes benchmarks/long_run_<platform>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".data")


def state_nbytes(state) -> int:
    import jax

    return int(sum(x.nbytes for x in jax.tree_util.tree_leaves(state)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--wh", type=int, nargs=2, default=(640, 480))
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--root", default=os.path.join(DATA, "long_tum"))
    ap.add_argument("--vocab", default="bundled",
                    help="'bundled' or a path to a vocabulary .npz")
    ap.add_argument("--steer", default="continuous",
                    help="BRIEF steering mode: this orbit turns 2.9 deg/frame, "
                         "inside the documented fast-rotation regime where "
                         "binned-LUT steering destabilizes (see "
                         "FrontendConfig.steer_mode)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from monocular_slam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from monocular_slam_tpu.datasets import render, tum
    from monocular_slam_tpu.eval import ate as ate_mod
    from monocular_slam_tpu.retrieval import vocabulary as vocab_mod
    from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu.slam.loop_closer import LoopCloser, LoopClosureConfig
    from monocular_slam_tpu.slam.session import SlamSession

    n = args.frames
    wh = tuple(args.wh)
    dev = jax.devices()[0]
    print("device:", dev, file=sys.stderr)

    # --- dataset (cached on disk) ------------------------------------------
    vfile = os.path.join(args.root, "VERSION_LONG")
    tag = f"{render.RENDER_VERSION}-{n}-{wh[0]}x{wh[1]}"
    if not os.path.exists(vfile) or open(vfile).read().strip() != tag:
        print(f"rendering {n}-frame orbit ({wh[0]}x{wh[1]}) ...", file=sys.stderr)
        render.export_tum(
            args.root, key=jax.random.PRNGKey(19), n_frames=n, wh=wh,
            ang_step=0.05,  # ~126 frames/revolution -> ~8 revisits
        )
        with open(vfile, "w") as f:
            f.write(tag)
    seq = tum.load(args.root)
    assert len(seq.frames) == n

    cfg = SlamConfig(
        max_frames=n + 32,
        max_slots=args.slots,
        max_points=30000,
        image_wh=wh,
        frontend=FrontendConfig(n_features=args.features, steer_mode=args.steer),
    )

    # --- the BUNDLED 10^4-word vocabulary (the shipped artifact, trained on
    # a disjoint rendered corpus — deployment parity instead of a
    # sequence-specific tree), or an explicit tree for A/B runs
    if args.vocab == "bundled":
        voc = vocab_mod.load_default()
    else:
        voc = vocab_mod.load(args.vocab)
    print(f"vocab: {args.vocab}, {voc.n_words} words", file=sys.stderr)

    # --- ingest: decode + preload to HBM (FrameLoader parity) ---------------
    t0 = time.perf_counter()
    chunks = []
    B = 200
    for lo in range(0, n, B):
        imgs = np.stack(seq.load_images_batch(range(lo, min(lo + B, n))))
        chunks.append(jax.device_put(imgs))
    jax.block_until_ready(chunks[-1])
    ingest_s = time.perf_counter() - t0
    print(f"ingest (decode+upload): {ingest_s:.0f}s", file=sys.stderr)

    # cooldown ~ half a revolution: one correction per revisit region (the
    # default 20-frame cooldown re-closed the same loop at every eligible
    # keyframe — 13 global corrections in 1000 frames, each a perturbation)
    lc = LoopCloser(voc=voc, cfg=cfg,
                    lc=LoopClosureConfig(min_gap=60, cooldown=60))
    sess = SlamSession(cfg, seed=0, run_ba=True, loop_closer=lc)
    sess.prewarm(image=True)

    t0 = time.perf_counter()
    t_steady = None
    for i in range(n):
        sess.add_frame_from_buffer(chunks[i // B], i % B, seq.k,
                                   seq.frames[i].timestamp)
        if i == 49:
            jax.block_until_ready(sess.state.poses)
            t_steady = time.perf_counter()
        if i % 100 == 99:
            print(f"  frame {i + 1}/{n}  kf={len(sess.keyframes)} "
                  f"closures={len(lc.closures)}", file=sys.stderr)
    jax.block_until_ready(sess.state.poses)
    wall = time.perf_counter() - t0
    steady_fps = (n - 50) / (time.perf_counter() - t_steady)

    print("closure timings:", {k: (round(v, 1) if isinstance(v, float) else v)
                                for k, v in lc.timings.items()}, file=sys.stderr)
    poses, valid, _ = sess.trajectory()
    gt = np.stack([f.pose_gt for f in seq.frames])
    finite = np.isfinite(poses).all(axis=(1, 2))
    n_nonfinite = int((valid & ~finite).sum())
    valid = valid & finite
    r = ate_mod.ate(poses[valid], gt[: len(valid)][valid])

    slot_of = np.asarray(sess.state.slot_of)[:n]
    evicted = int((slot_of < 0).sum())
    mem_state = state_nbytes(sess.state)
    # the feature tier the old design would have needed: one slot per frame
    per_frame_slab = (
        sess.state.kp_uv.nbytes + sess.state.kp_scale.nbytes
        + sess.state.kp_valid.nbytes + sess.state.desc.nbytes
        + sess.state.desc_pm1.nbytes + sess.state.feat_point.nbytes
    )
    unbounded_equiv = per_frame_slab * (n / args.slots)

    out = {
        "device": str(dev),
        "frames": n,
        "resolution": f"{wh[0]}x{wh[1]}",
        "max_slots": args.slots,
        "tracked": int(valid.sum()),
        "nonfinite_poses": n_nonfinite,
        "steady_fps": round(steady_fps, 2),
        "wall_s": round(wall, 1),
        "ate_rmse_m": round(float(r.rmse), 4),
        "keyframes_live": len(sess.keyframes),
        "loop_closures": lc.closures,
        "frames_evicted": evicted,
        "state_bytes": mem_state,
        "state_mb": round(mem_state / 2**20, 1),
        "feature_tier_mb": round(per_frame_slab / 2**20, 1),
        "unbounded_design_feature_mb": round(unbounded_equiv / 2**20, 1),
        "ingest_s": round(ingest_s, 1),
        "vocab_words": int(voc.n_words),
        "closure_timings_s": {k: (round(v, 1) if isinstance(v, float) else v) for k, v in lc.timings.items()},
        "note": (
            "live SlamSession, loop closer attached, feature tier recycled "
            "over max_slots slots (poses persist per frame); "
            "device memory_stats unavailable on this backend — state_bytes "
            "is the analytic device-state footprint"
        ),
    }
    print(json.dumps(out))
    path = f"benchmarks/long_run_{dev.platform}.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, file=sys.stderr)
    # trajectory dump for offline error analysis (not committed)
    np.savez_compressed(
        os.path.join(DATA, f"long_run_traj_{dev.platform}.npz"),
        poses=poses, valid=valid, gt=gt,
        keyframes=np.asarray(sess.keyframes),
        closures=np.asarray(lc.closures or np.zeros((0, 2))),
    )


if __name__ == "__main__":
    main()
