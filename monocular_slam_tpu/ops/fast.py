"""Branch-free FAST-9/16 corner detection, whole-image vectorized.

Replaces OpenCV's FAST inside `OrbFeatureDetector` (`src/FeatureExtractor.cpp`).
The classic implementation early-exits per pixel on a 16-pixel Bresenham ring
test — data-dependent control flow that does not vectorize. Here EVERY pixel
evaluates the full ring simultaneously:

  - d_i = ring_i - center for the 16 ring offsets (static rolls of the image)
  - a pixel is a corner if some 9 contiguous d_i are all > t (bright arc) or
    all < -t (dark arc)
  - the "9 contiguous" test/score uses a log-step min-reduction over circular
    windows (min9_i = min(d_i..d_{i+8}) via min-roll doubling), the same
    doubling trick DBoW2 uses for popcount bytes (`FORB.cpp:81-100`) but with
    min instead of +
  - corner score = max_i min9_i (bright) or max_i min9(-d)_i (dark): the
    largest threshold at which the pixel would still be a corner — matches
    OpenCV's FAST score semantics
  - 3x3 NMS by max-pool equality, then top-K by lax.top_k

Output is fixed-capacity: exactly `max_corners` (y, x) positions + validity
mask, sorted by score.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock
# (dy, dx) offsets.
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BORDER = 3


def _ring_diffs(img: jnp.ndarray) -> jnp.ndarray:
    """(16, H, W) of ring minus center. Uses static rolls (no gathers)."""
    stack = [jnp.roll(img, (-dy, -dx), axis=(-2, -1)) for (dy, dx) in RING_OFFSETS]
    return jnp.stack(stack, axis=0) - img[None]


def _circular_min9(d: jnp.ndarray) -> jnp.ndarray:
    """min over each circular window of 9 consecutive entries along axis 0
    (length 16). Log-step doubling: 4 rolls instead of 9x16 comparisons."""
    m = jnp.minimum(d, jnp.roll(d, -1, axis=0))  # window 2
    m = jnp.minimum(m, jnp.roll(m, -2, axis=0))  # window 4
    m = jnp.minimum(m, jnp.roll(m, -4, axis=0))  # window 8
    return jnp.minimum(m, jnp.roll(d, -8, axis=0))  # window 9


def corner_score_raw(img: jnp.ndarray) -> jnp.ndarray:
    """Raw FAST-9 score per pixel: max over arcs of the circular min-9 — no
    threshold, no border mask (rolls wrap in the outer BORDER ring). The
    sub-pixel parabola fits on THIS field (clamping sub-threshold neighbours
    to zero would warp the vertex near the threshold boundary)."""
    d = _ring_diffs(img)
    bright = jnp.max(_circular_min9(d), axis=0)  # largest t with a bright arc
    dark = jnp.max(_circular_min9(-d), axis=0)
    return jnp.maximum(bright, dark)


def corner_score(img: jnp.ndarray, threshold: float = 20.0) -> jnp.ndarray:
    """FAST-9 corner score per pixel (0 where not a corner). img: (H, W)."""
    return threshold_score(corner_score_raw(img), threshold)


def threshold_score(raw: jnp.ndarray, threshold: float = 20.0) -> jnp.ndarray:
    """`corner_score` from a precomputed raw score map: zero below the
    threshold and in the border ring (where the rolls wrap around)."""
    score = jnp.where(raw > threshold, raw, 0.0)
    H, W = raw.shape[-2:]
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    interior = (
        (ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER)
    )
    return jnp.where(interior, score, 0.0)


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression via max-pool equality."""
    p = jnp.pad(score, ((1, 1), (1, 1)), constant_values=-jnp.inf)
    mx = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            mx = jnp.maximum(mx, p[1 + dy : 1 + dy + score.shape[0], 1 + dx : 1 + dx + score.shape[1]])
    return jnp.where(score >= mx, score, 0.0)


def subpixel_offsets(
    img: jnp.ndarray, yx: jnp.ndarray, threshold: float = 20.0
) -> jnp.ndarray:
    """(K, 2) sub-pixel (dy, dx) offsets for integer corner positions `yx`.

    Fits a 1D parabola per axis through the FAST-9 scores of the 3x3
    neighborhood (recomputed at just those pixels with one batched gather).
    FAST corners are integer-quantized; at pyramid level L the quantization
    is ~1.2^L level-0 pixels, which dominates triangulation depth error for
    fine features. OpenCV's ORB ships integer corners (the reference
    inherits that, `src/FeatureExtractor.cpp:13-31`); the parabola recovers
    ~3x tighter localization for one small gather.
    """
    H, W = img.shape[-2:]
    yi = yx[..., 0].astype(jnp.int32)
    xi = yx[..., 1].astype(jnp.int32)
    d1 = jnp.arange(-1, 2, dtype=jnp.int32)
    ys = yi[:, None, None] + d1[None, :, None]  # (K, 3, 1)
    xs = xi[:, None, None] + d1[None, None, :]  # (K, 1, 3)
    ys = jnp.clip(ys, 0, H - 1)
    xs = jnp.clip(xs, 0, W - 1)
    center = img[ys, xs]  # (K, 3, 3)
    ring = jnp.stack(
        [
            img[jnp.clip(ys + dy, 0, H - 1), jnp.clip(xs + dx, 0, W - 1)]
            for (dy, dx) in RING_OFFSETS
        ],
        axis=0,
    )  # (16, K, 3, 3)
    d = ring - center[None]
    bright = jnp.max(_circular_min9(d), axis=0)
    dark = jnp.max(_circular_min9(-d), axis=0)
    # Fit on the RAW score field: clamping neighbours just under the
    # threshold to zero would warp the parabola vertex near the threshold
    # boundary. The threshold participates only in the `ok` gate below.
    s = jnp.maximum(bright, dark)  # (K, 3, 3)

    dy_off = _parab(s[:, 0, 1], s[:, 1, 1], s[:, 2, 1])
    dx_off = _parab(s[:, 1, 0], s[:, 1, 1], s[:, 1, 2])
    # Suppress near the border where the clipped gather corrupts the ring.
    ok = (
        (yi >= BORDER + 1) & (yi < H - BORDER - 1)
        & (xi >= BORDER + 1) & (xi < W - BORDER - 1)
        & (s[:, 1, 1] > threshold)
    )
    off = jnp.stack([dy_off, dx_off], axis=-1)
    return jnp.where(ok[:, None], off, 0.0).astype(img.dtype)


def _parab(sm: jnp.ndarray, s0: jnp.ndarray, sp: jnp.ndarray) -> jnp.ndarray:
    """1D parabola vertex offset through (-1, sm), (0, s0), (+1, sp)."""
    denom = sm - 2.0 * s0 + sp
    off = 0.5 * (sm - sp) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1.0)
    return jnp.clip(jnp.where(jnp.abs(denom) > 1e-6, off, 0.0), -0.5, 0.5)


def subpixel_from_raw(
    raw: jnp.ndarray, yx: jnp.ndarray, threshold: float = 20.0
) -> jnp.ndarray:
    """(K, 2) sub-pixel (dy, dx) offsets for integer corner positions `yx`,
    read from a precomputed raw score map (`corner_score_raw`).

    Same parabola as `subpixel_offsets`, but as four shifted full-image maps
    + three (K,)-sized flat gathers instead of 17 (K, 3, 3) element-granular
    gathers.
    Bit-identical for every keypoint the `ok` gate accepts: the gate excludes
    the outer BORDER+1 ring, where (and only where) the map's wrap-around
    differs from the old clamped per-sample gathers."""
    H, W = raw.shape[-2:]
    p = jnp.pad(raw, ((1, 1), (1, 1)), mode="edge")
    offy = _parab(p[:-2, 1:-1], raw, p[2:, 1:-1])
    offx = _parab(p[1:-1, :-2], raw, p[1:-1, 2:])
    yi = yx[..., 0].astype(jnp.int32)
    xi = yx[..., 1].astype(jnp.int32)
    flat = jnp.clip(yi, 0, H - 1) * W + jnp.clip(xi, 0, W - 1)
    dy_off = offy.reshape(-1)[flat]
    dx_off = offx.reshape(-1)[flat]
    s0 = raw.reshape(-1)[flat]
    ok = (
        (yi >= BORDER + 1) & (yi < H - BORDER - 1)
        & (xi >= BORDER + 1) & (xi < W - BORDER - 1)
        & (s0 > threshold)
    )
    off = jnp.stack([dy_off, dx_off], axis=-1)
    return jnp.where(ok[:, None], off, 0.0).astype(raw.dtype)


class Corners(NamedTuple):
    yx: jnp.ndarray  # (K, 2) float — (y, x) positions at this level
    score: jnp.ndarray  # (K,)
    valid: jnp.ndarray  # (K,) bool


def detect(
    img: jnp.ndarray, max_corners: int, threshold: float = 20.0
) -> Corners:
    """Fixed-capacity FAST detection: top `max_corners` NMS survivors."""
    score = nms3(corner_score(img, threshold))
    flat = score.reshape(-1)
    vals, idx = jax.lax.top_k(flat, max_corners)
    W = img.shape[-1]
    yx = jnp.stack([idx // W, idx % W], axis=-1).astype(img.dtype)
    return Corners(yx=yx, score=vals, valid=vals > 0)
