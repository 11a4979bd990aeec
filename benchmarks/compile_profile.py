"""Per-program compile-time breakdown for the SLAM session.

Times cold compile (no persistent cache) and steady-state execution of every
jitted stage the session dispatches, on the current default device, to see
where the cold-session warmup goes:

    python benchmarks/compile_profile.py            # persistent cache off: cold
    python benchmarks/compile_profile.py --warm     # through the persistent cache

Writes benchmarks/compile_profile_<platform>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", action="store_true",
                    help="compile through the persistent cache (default: off, true cold)")
    ap.add_argument("--n-feat", type=int, default=1000)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.warm:
        from monocular_slam_tpu.utils.cache import enable_compilation_cache

        cache = enable_compilation_cache()
    else:
        jax.config.update("jax_enable_compilation_cache", False)
        cache = None

    from functools import partial

    from monocular_slam_tpu.datasets import synthetic
    from monocular_slam_tpu.ops import features as features_mod
    from monocular_slam_tpu.slam import local_ba, mapping, session as session_mod, state as state_mod, tracker
    from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig

    dev = jax.devices()[0]
    print("device:", dev, " cache:", cache, file=sys.stderr)

    cfg = SlamConfig(
        max_frames=64, max_points=20000,
        frontend=FrontendConfig(n_features=args.n_feat),
    )
    seq = synthetic.feature_sequence(
        jax.random.PRNGKey(0), n_frames=12, n_world_points=2500,
        n_features=args.n_feat,
    )
    st = state_mod.empty_state(cfg)
    for i, f in enumerate(seq.frames):
        st = state_mod.add_frame_features(
            st, i, i, f.uv, f.scale, f.valid, f.desc, f.desc_pm1, seq.k
        )
    st = st._replace(
        poses=st.poses.at[:12].set(seq.poses_gt.astype(st.poses.dtype)),
        pose_valid=st.pose_valid.at[:12].set(True),
    )
    key = jax.random.PRNGKey(1)
    img = jax.random.uniform(key, (480, 640), jnp.float32) * 255.0

    m = cfg.mapping
    progs = {
        "extract_640x480": (
            jax.jit(partial(features_mod.extract, n_features=cfg.frontend.n_features,
                            n_levels=cfg.frontend.n_levels,
                            fast_threshold=cfg.frontend.fast_threshold)),
            (img,),
        ),
        "add_feats": (
            jax.jit(state_mod.add_frame_features),
            (st, 11, 11, seq.frames[0].uv, seq.frames[0].scale,
             seq.frames[0].valid, seq.frames[0].desc, seq.frames[0].desc_pm1,
             seq.k),
        ),
        "bootstrap": (
            jax.jit(lambda s, f0, f1, k: tracker.bootstrap(s, k, cfg, f0, f1)),
            (st, 0, 1, key),
        ),
        "track": (
            jax.jit(lambda s, i, k: tracker.track(s, i, k, cfg)),
            (st, 11, key),
        ),
        "local_ba": (
            jax.jit(lambda s, i: local_ba.local_bundle_adjust(s, i, cfg)),
            (st, 11),
        ),
        "fuse": (
            jax.jit(lambda s, i: mapping.fuse(s, i, radius_px=m.fuse_radius_px,
                                              max_hamming=m.fuse_max_hamming,
                                              image_wh=cfg.image_wh)),
            (st, 11),
        ),
        "cull": (
            jax.jit(lambda s, i: mapping.cull_points(s, i, min_obs=m.cull_min_obs,
                                                     grace=m.cull_grace)),
            (st, 11),
        ),
        "overlap": (jax.jit(mapping.frame_overlap), (st, 11, 5)),
        # the production per-frame program (track+BA+fuse+cull+keyframe)
        "session_step": (
            jax.jit(lambda s, i, lk, k: session_mod._session_step(
                s, i, lk, k, cfg, True)),
            (st, 11, jnp.asarray(5, jnp.int32), key),
        ),
    }

    out = {"device": str(dev), "cache_dir": cache, "n_feat": args.n_feat,
           "programs": {}}
    total_cold = 0.0
    for name, (fn, a) in progs.items():
        t0 = time.perf_counter()
        r = fn(*a)
        jax.block_until_ready(jax.tree_util.tree_leaves(r)[0])
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_rep = 5
        for _ in range(n_rep):
            r = fn(*a)
        jax.block_until_ready(jax.tree_util.tree_leaves(r)[0])
        steady = (time.perf_counter() - t0) / n_rep
        total_cold += cold
        out["programs"][name] = {
            "cold_s": round(cold, 2), "steady_ms": round(steady * 1e3, 2)
        }
        print(f"{name:16s} cold {cold:7.1f}s  steady {steady*1e3:8.2f} ms",
              file=sys.stderr, flush=True)
    out["total_cold_s"] = round(total_cold, 1)
    plat = dev.platform
    path = os.path.join(os.path.dirname(__file__), f"compile_profile_{plat}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"total_cold_s": out["total_cold_s"], "written": path}))


if __name__ == "__main__":
    main()
