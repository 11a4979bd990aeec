"""CLI entry point — the reference's `main.cpp` + `AppConfig` equivalent.

    python -m monocular_slam_tpu.run --dataset /path/to/rgbd_dataset_freiburg1_xyz \
        --start 0 --end 200 --step 2 --out out/

Runs the full SLAM pipeline on a TUM / KITTI / synthetic sequence, writes a
TUM-format trajectory, a PLY point cloud, an offline trajectory plot, and
(when ground truth exists) prints ATE/RPE. The default frame window
[0, 200) step 2 mirrors `src/main.cpp:35`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   help="TUM sequence dir, KITTI root, or 'synthetic'")
    p.add_argument("--kitti-seq", default="00")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=200)
    p.add_argument("--step", type=int, default=2)
    p.add_argument("--out", default="out")
    p.add_argument("--features", type=int, default=1000)
    p.add_argument("--max-frames", type=int, default=256)
    p.add_argument("--max-points", type=int, default=30000)
    p.add_argument("--no-ba", action="store_true", help="disable local BA")
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--vocab", default="default",
                   help="trained vocabulary npz for --loop-closure "
                        "(default: the bundled vocabulary)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument(
        "--profile", default=None, metavar="LOGDIR",
        help="capture a device trace of the main loop (TensorBoard format)",
    )
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import jax
    import numpy as np

    from monocular_slam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from monocular_slam_tpu.eval import ate as ate_mod
    from monocular_slam_tpu.io import ply, trajectory
    from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu.slam.session import SlamSession

    # --- dataset ------------------------------------------------------------
    gt_poses = None
    dist = None
    timestamps = []
    if args.dataset == "synthetic":
        from monocular_slam_tpu.datasets import synthetic

        seq = synthetic.feature_sequence(
            jax.random.PRNGKey(args.seed),
            n_frames=min(args.max_frames, (args.end - args.start) // max(args.step, 1)),
            n_features=args.features,
        )
        frames = [("features", f, seq.k, seq.timestamps[i]) for i, f in enumerate(seq.frames)]
        gt_poses = np.asarray(seq.poses_gt)
    elif os.path.isdir(os.path.join(args.dataset, "sequences")):
        from monocular_slam_tpu.datasets import kitti

        seq = kitti.load(args.dataset, args.kitti_seq, args.start, args.end, args.step)
        frames = [
            ("image", i, seq.k, seq.timestamps[i]) for i in range(len(seq.image_paths))
        ]
        loader = seq.load_image
        gt_poses = seq.poses_gt
    else:
        from monocular_slam_tpu.datasets import tum

        seq = tum.load(args.dataset, args.start, args.end, args.step)
        frames = [
            ("image", i, seq.k, fr.timestamp) for i, fr in enumerate(seq.frames)
        ]
        loader = seq.load_image
        dist = seq.dist
        if all(fr.pose_gt is not None for fr in seq.frames):
            gt_poses = np.stack([fr.pose_gt for fr in seq.frames])

    image = any(f[0] == "image" for f in frames)
    cfg = SlamConfig(
        max_frames=args.max_frames,
        max_points=args.max_points,
        # programs are compiled for the sequence's own resolution
        image_wh=loader(0).shape[::-1] if image else SlamConfig.image_wh,
        frontend=FrontendConfig(n_features=args.features),
    )

    # the closer is built before the session: the session wires its BoW
    # database into the fused per-frame step at construction
    lc = None
    if args.loop_closure:
        from monocular_slam_tpu.retrieval import vocabulary as vocab_mod
        from monocular_slam_tpu.slam.loop_closer import LoopCloser

        voc = (
            vocab_mod.load_default() if args.vocab == "default"
            else vocab_mod.load(args.vocab)
        )
        lc = LoopCloser(voc=voc, cfg=cfg)

    sess = SlamSession(cfg, seed=args.seed, run_ba=not args.no_ba, loop_closer=lc)

    # compile the per-frame programs in parallel before frame 0 (wall time
    # = max over programs, not sum)
    sess.prewarm(image=image)

    # --- main loop (the reference's per-frame stage loop, main.cpp:48-51) ---
    import contextlib

    from monocular_slam_tpu.utils.profiling import device_trace

    trace_cm = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with trace_cm:
      for idx, item in enumerate(frames):
          kind = item[0]
          if kind == "features":
              _, f, k, ts = item
              st = sess.add_frame_features(f, k, ts)
          else:
              _, i_img, k, ts = item
              st = sess.add_frame(loader(i_img), k, ts, dist=dist)
          timestamps.append(item[3])
          if args.verbose:
              print(
                  f"[{idx:4d}] tracked={st.tracked} inliers={st.n_inliers} "
                  f"new={st.n_new_points} map={sess.n_map_points}"
              )
    wall = time.perf_counter() - t0

    # --- outputs ------------------------------------------------------------
    poses, valid, ts = sess.trajectory()
    trajectory.write_tum(os.path.join(args.out, "trajectory.txt"), poses, ts, valid)
    ply.write_ply_points(os.path.join(args.out, "map.ply"), sess.map_points())
    try:
        from monocular_slam_tpu.viz import plots

        plots.plot_trajectory(
            os.path.join(args.out, "trajectory.png"), poses, valid, gt_poses
        )
    except Exception as e:  # viz is best-effort
        print(f"[run] plot skipped: {e}")

    summary = {
        "frames": int(len(frames)),
        "tracked": int(valid.sum()),
        "map_points": int(sess.n_map_points),
        "fps_incl_compile": round(len(frames) / wall, 2),
        "wall_s": round(wall, 1),
    }
    if gt_poses is not None:
        r = ate_mod.ate(poses[valid], gt_poses[: len(valid)][valid])
        summary["ate_rmse"] = round(float(r.rmse), 5)
        summary["rpe"] = round(ate_mod.rpe(poses[valid], gt_poses[: len(valid)][valid]), 5)
    if lc is not None:
        summary["loop_closures"] = lc.closures
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
