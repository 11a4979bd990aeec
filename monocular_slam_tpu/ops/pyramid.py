"""Image pyramid + separable Gaussian blur, XLA-native.

Replaces the pyramid inside OpenCV's ORB (used via `OrbFeatureDetector` in
`src/FeatureExtractor.cpp:13-31`). Images are (H, W) float32 grayscale in
[0, 255]. All shapes static: pyramid levels are a Python-level tuple of
fixed-size arrays (scale factor 1.2, like ORB's default).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SCALE_FACTOR = 1.2
N_LEVELS = 8


def gaussian_blur(img: jnp.ndarray, sigma: float = 2.0, radius: int = 3) -> jnp.ndarray:
    """Separable Gaussian blur with reflect padding. (..., H, W)."""
    x = jnp.arange(-radius, radius + 1, dtype=img.dtype)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / jnp.sum(k)

    def conv1d(a, axis):
        a = jnp.moveaxis(a, axis, -1)
        pad = [(0, 0)] * (a.ndim - 1) + [(radius, radius)]
        ap = jnp.pad(a, pad, mode="reflect")
        out = jnp.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + k[i] * jax.lax.dynamic_slice_in_dim(ap, i, a.shape[-1], axis=-1)
        return jnp.moveaxis(out, -1, axis)

    return conv1d(conv1d(img, -1), -2)


def level_shape(shape, level: int) -> tuple[int, int]:
    """Static (h, w) of pyramid level `level` for a level-0 (h, w)."""
    s = SCALE_FACTOR**level
    return (max(int(round(shape[-2] / s)), 16), max(int(round(shape[-1] / s)), 16))


def resize_level(img: jnp.ndarray, level: int) -> jnp.ndarray:
    """Downscale to pyramid level (1.2^-level) with bilinear resize."""
    if level == 0:
        return img
    h, w = level_shape(img.shape, level)
    return jax.image.resize(img, img.shape[:-2] + (h, w), method="bilinear")


def build_pyramid(img: jnp.ndarray, n_levels: int = N_LEVELS):
    """Tuple of (n_levels) arrays, level i at scale 1.2^-i.

    Cascaded: level i resizes from level i-1, not from level 0 (XLA lowers
    bilinear resize to two matmuls whose cost scales with the SOURCE size;
    cascading shrinks the source geometrically). Target sizes are still
    computed from level 0, so level shapes are identical to the direct
    form; the interpolation differs by one bilinear re-sampling per level
    (sub-quantization at 8-bit image scale)."""
    levels = [img]
    for i in range(1, n_levels):
        h, w = level_shape(img.shape, i)
        levels.append(
            jax.image.resize(
                levels[-1], img.shape[:-2] + (h, w), method="bilinear"
            )
        )
    return tuple(levels)


def level_scale(level) -> float:
    return SCALE_FACTOR ** float(level)
