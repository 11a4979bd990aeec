"""Sub-stage device/dispatch profile of the per-frame hot path. Separates three costs the single-program numbers in
compile_profile.py conflate:

  - per-dispatch host overhead (trivial-op round trip),
  - chained steady device time per program (N reps, one final block),
  - host-side dispatch cost alone (N async dispatches, no block).

Run on the GPU:  python benchmarks/step_profile.py
Writes benchmarks/step_profile_<platform>.json.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def chained(fn, state0, n=30, fold=None):
    """Steady per-call seconds: chain state through fn n times, block once."""
    import jax

    cur = fn(state0)
    jax.block_until_ready(jax.tree_util.tree_leaves(cur)[0])
    t0 = time.perf_counter()
    cur = state0
    for r in range(n):
        cur = fn(cur)
    jax.block_until_ready(jax.tree_util.tree_leaves(cur)[0])
    return (time.perf_counter() - t0) / n


def dispatch_only(fn, state0, n=30):
    """Host-side seconds per async dispatch (no device wait)."""
    import jax

    out = fn(state0)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    outs = [fn(state0) for _ in range(n)]
    dt = (time.perf_counter() - t0) / n
    jax.block_until_ready(jax.tree_util.tree_leaves(outs[-1])[0])
    return dt


def main():
    import jax
    import jax.numpy as jnp

    from monocular_slam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from functools import partial

    from monocular_slam_tpu.datasets import synthetic
    from monocular_slam_tpu.ops import features as features_mod
    from monocular_slam_tpu.slam import local_ba, mapping, state as state_mod, tracker
    from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu.slam import session as session_mod

    dev = jax.devices()[0]
    print("device:", dev, file=sys.stderr)
    out = {"device": str(dev)}

    n_feat = 1000
    cfg = SlamConfig(
        max_frames=64, max_points=20000, frontend=FrontendConfig(n_features=n_feat)
    )
    seq = synthetic.feature_sequence(
        jax.random.PRNGKey(0), n_frames=40, n_world_points=2500,
        n_features=n_feat, pix_noise=0.3, drop_prob=0.08,
    )
    sess = session_mod.SlamSession(cfg, seed=1, run_ba=True)
    for i, f in enumerate(seq.frames):
        sess.add_frame_features(f, seq.k, seq.timestamps[i])
    warm = sess.state
    key = jax.random.PRNGKey(7)
    i39 = jnp.asarray(39, jnp.int32)
    lkf = jnp.asarray(35, jnp.int32)

    # 1. trivial round trip: per-dispatch floor
    triv = jax.jit(lambda x: x + 1.0)
    x0 = jnp.zeros(())
    out["trivial_roundtrip_ms"] = chained(triv, x0, n=50) * 1e3
    out["trivial_dispatch_ms"] = dispatch_only(triv, x0, n=50) * 1e3

    # 2. extract: chained device time + dispatch-only host time
    img = jax.random.uniform(jax.random.PRNGKey(3), (480, 640), jnp.float32) * 255.0
    ext = jax.jit(
        partial(
            features_mod.extract,
            n_features=n_feat,
            n_levels=cfg.frontend.n_levels,
            fast_threshold=cfg.frontend.fast_threshold,
        )
    )
    # chain by feeding a negligible function of the output back into the image
    out["extract_chained_ms"] = chained(lambda im: im + ext(im).uv[0, 0] * 1e-12, img, n=20) * 1e3
    out["extract_dispatch_ms"] = dispatch_only(lambda im: ext(im).uv, img, n=20) * 1e3

    # 3. image transfer host->device: f32 vs uint8
    im_np_f32 = np.asarray(img)
    im_np_u8 = im_np_f32.astype(np.uint8)
    for name, arr in [("f32", im_np_f32), ("u8", im_np_u8)]:
        jax.block_until_ready(jnp.asarray(arr))
        t0 = time.perf_counter()
        for _ in range(20):
            jax.block_until_ready(jnp.asarray(arr))
        out[f"img_transfer_{name}_ms"] = (time.perf_counter() - t0) / 20 * 1e3

    # 4. full session step (track+BA+fuse+cull+kf), chained
    step = jax.jit(
        lambda st: session_mod._session_step(st, i39, lkf, key, cfg, True)[0]
    )
    out["session_step_chained_ms"] = chained(step, warm, n=30) * 1e3
    out["session_step_dispatch_ms"] = dispatch_only(step, warm, n=30) * 1e3

    # 5. track only
    trk = jax.jit(lambda st: tracker.track(st, i39, key, cfg).state)
    out["track_chained_ms"] = chained(trk, warm, n=30) * 1e3

    # 6. track w/o TrackLocalMap (isolates the slab/projection cost)
    from dataclasses import replace

    cfg_nolm = replace(cfg, track=replace(cfg.track, track_local_map=False))
    trk_nolm = jax.jit(lambda st: tracker.track(st, i39, key, cfg_nolm).state)
    out["track_no_localmap_chained_ms"] = chained(trk_nolm, warm, n=30) * 1e3

    # 7. local BA at various iteration counts
    for iters in (10, 5, 3):
        cfg_i = replace(cfg, ba=replace(cfg.ba, local_iters=iters))
        ba_i = jax.jit(
            lambda st, c=cfg_i: local_ba.local_bundle_adjust(st, i39, c).state
        )
        out[f"local_ba_{iters}it_chained_ms"] = chained(ba_i, warm, n=30) * 1e3

    # 8. fuse + cull + overlap (the mapping extras)
    fu = jax.jit(
        lambda st: mapping.fuse(
            st, i39, radius_px=cfg.mapping.fuse_radius_px,
            max_hamming=cfg.mapping.fuse_max_hamming, image_wh=cfg.image_wh,
        ).state
    )
    out["fuse_chained_ms"] = chained(fu, warm, n=20) * 1e3
    cu = jax.jit(
        lambda st: mapping.cull_points(
            st, i39, min_obs=cfg.mapping.cull_min_obs, grace=cfg.mapping.cull_grace
        )[0]
    )
    out["cull_chained_ms"] = chained(cu, warm, n=20) * 1e3

    # 9. add_feats chained
    f0 = seq.frames[0]
    af = jax.jit(
        lambda st: state_mod.add_frame_features(
            st, 63, 63, f0.uv, f0.scale, f0.valid, f0.desc, f0.desc_pm1,
            seq.k,
        )
    )
    out["add_feats_chained_ms"] = chained(af, warm, n=30) * 1e3

    for k, v in out.items():
        if isinstance(v, float):
            out[k] = round(v, 3)
        print(f"{k}: {out[k]}", file=sys.stderr)

    plat = dev.platform
    path = f"benchmarks/step_profile_{plat}.json"
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", path, file=sys.stderr)


if __name__ == "__main__":
    main()
