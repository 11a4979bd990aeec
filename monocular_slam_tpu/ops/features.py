"""Full ORB feature extraction over an image pyramid — the frontend stage.

Replaces `FeatureExtractor::process` (`src/FeatureExtractor.cpp:13-31`): fills
fixed-capacity per-frame keypoints, scales, and 32-byte descriptors. Keypoint
budget is split across pyramid levels proportional to level area (ORB's
per-level distribution), detection is branch-free FAST (ops/fast.py),
description is steered BRIEF (ops/orb.py) on the blurred level image.

The pyramid has static per-level shapes, so the whole extractor jit-compiles
to one program per image resolution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from monocular_slam_tpu.ops import fast, orb, pyramid


def _level_budgets(n_features: int, n_levels: int) -> list[int]:
    """Geometric split (factor 1/1.2) of the keypoint budget across levels."""
    inv = 1.0 / pyramid.SCALE_FACTOR
    raw = [inv**i for i in range(n_levels)]
    s = sum(raw)
    per = [max(8, int(round(n_features * r / s))) for r in raw]
    # trim/extend to match the exact total
    delta = n_features - sum(per)
    per[0] += delta
    return per


def extract(
    img: jnp.ndarray,
    n_features: int = 1000,
    n_levels: int = pyramid.N_LEVELS,
    fast_threshold: float = 20.0,
    steer_mode: str = "binned",
) -> orb.Features:
    """Extract ORB features from a grayscale (H, W) float image in [0, 255].

    Returns a fixed-capacity `Features` with exactly n_features slots (invalid
    slots masked)."""
    img = img.astype(jnp.float32)
    levels = pyramid.build_pyramid(img, n_levels)
    budgets = _level_budgets(n_features, n_levels)

    uvs, descs, pm1s, angles, scores, scales, valids = [], [], [], [], [], [], []
    for lvl, (im_l, budget) in enumerate(zip(levels, budgets)):
        sc = pyramid.level_scale(lvl)
        with jax.named_scope("fast_score_nms"):
            raw_map = fast.corner_score_raw(im_l)
            nms_map = fast.nms3(fast.threshold_score(raw_map, fast_threshold))
        vals, idx = jax.lax.top_k(nms_map.reshape(-1), budget)
        Hl, Wl = im_l.shape
        yx = jnp.stack([idx // Wl, idx % Wl], axis=-1).astype(img.dtype)
        # ORB's edge threshold: corners whose orientation/BRIEF patch leaves
        # the image get clipped samples (corrupted descriptors) — drop them
        eb = orb.PATCH_RADIUS
        valid = (
            (vals > 0)
            & (yx[:, 0] >= eb)
            & (yx[:, 0] < Hl - eb)
            & (yx[:, 1] >= eb)
            & (yx[:, 1] < Wl - eb)
        )
        blurred = pyramid.gaussian_blur(im_l, sigma=2.0, radius=3)
        ang = orb.orientations(im_l, yx)
        desc, pm1 = orb.descriptors_and_pm1(blurred, yx, ang, steer_mode=steer_mode)
        # sub-pixel corner localization (score-parabola) for the reported
        # positions; orientation/descriptor sampling stays on the integer
        # grid they were designed for
        yx_ref = yx + fast.subpixel_from_raw(raw_map, yx, fast_threshold)
        # positions back to level-0 pixels, as (x, y) to match uv convention
        uv = jnp.stack([yx_ref[:, 1], yx_ref[:, 0]], axis=-1) * sc
        uvs.append(uv)
        descs.append(desc)
        pm1s.append(pm1)
        angles.append(ang)
        scores.append(vals)
        scales.append(jnp.full(budget, sc, dtype=img.dtype))
        valids.append(valid)

    return orb.Features(
        uv=jnp.concatenate(uvs),
        desc=jnp.concatenate(descs),
        desc_pm1=jnp.concatenate(pm1s),
        angle=jnp.concatenate(angles),
        score=jnp.concatenate(scores),
        scale=jnp.concatenate(scales),
        valid=jnp.concatenate(valids),
    )
