"""Matmul precision policy.

On a GPU, an f32 matmul/einsum without a pinned precision may run in TF32
(about three decimal digits) — harmless for exact integer matmuls, ruinous
for the small 3x3/6x6 geometry and normal-equation math. All small-matrix
math in this package goes through these helpers, which pin
`jax.lax.Precision.HIGHEST` (full f32). Matmuls that are exact at any
precision call jnp directly: the int8 ±1 Hamming matmuls (int32
accumulator) and the 0/1 incidence matmuls (f32 accumulator, exact for
counts below 2^24).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def einsum_hp(subscripts: str, *operands):
    """jnp.einsum pinned to highest precision."""
    return jnp.einsum(subscripts, *operands, precision=HIGHEST)


def matmul_hp(a, b):
    """jnp.matmul pinned to highest precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def small_mv(A, x):
    """Batched tiny matrix-vector product (..., m, k) @ (..., k) -> (..., m)
    expanded as broadcast multiply + sum: exact f32 elementwise math, no
    per-element tiny dot for contraction lengths of 3-4."""
    return jnp.sum(A * x[..., None, :], axis=-1)


def small_mm(A, B):
    """Batched tiny matmul (..., m, k) @ (..., k, n) -> (..., m, n) as
    broadcast multiply + sum over k (see `small_mv`). The (..., m, k, n)
    intermediate stays fused inside XLA."""
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def small_gram(A):
    """Batched tiny Gram matrix A^T A for (..., r, m) with small r: expanded
    outer-product sum over the r rows (see `small_mv` for why)."""
    return jnp.sum(A[..., :, :, None] * A[..., :, None, :], axis=-3)
