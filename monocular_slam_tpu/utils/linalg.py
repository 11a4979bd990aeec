"""Small-matrix linear algebra tuned for batched workloads.

Batched `eigh` can dominate RANSAC (512-2000 hypotheses x 9x9/12x12
nullspace problems can lower to slow per-matrix loops). For hypothesis
solving, the smallest eigenvector only needs enough accuracy to rank inlier
sets — shifted inverse power iteration (one batched Cholesky + a few
triangular solves) delivers that at a fraction of the cost; exact `eigh`
stays in the final refits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from monocular_slam_tpu.utils.precision import einsum_hp as _einsum


def smallest_eigvec_psd(A: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Approximate unit eigenvector of the smallest eigenvalue of a batched
    PSD matrix A (..., n, n) via shifted inverse power iteration.

    The shift (1e-6 * mean diagonal) regularizes the (near-singular) smallest
    eigenvalue so the Cholesky factorization exists; convergence is geometric
    in lambda_min/lambda_2 after shifting — a handful of iterations separates
    RANSAC inliers reliably.
    """
    n = A.shape[-1]
    diag_mean = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None] / n
    shift = 1e-6 * diag_mean + 1e-12
    M = A + shift * jnp.eye(n, dtype=A.dtype)
    L = jnp.linalg.cholesky(M)

    def solve(L, b):
        y = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)
        return jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(L, -1, -2), y, lower=False
        )[..., 0]

    x = jnp.ones(A.shape[:-1], dtype=A.dtype)
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    for _ in range(iters):
        x = solve(L, x)
        x = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    return x


def nullspace_vector(A: jnp.ndarray, method: str = "eigh", iters: int = 8) -> jnp.ndarray:
    """Unit vector minimizing |A x| given the normal matrix A^T A.

    A here IS the normal matrix (..., n, n). method: "eigh" (exact) or
    "inv_iter" (fast approximate for hypothesis batches).
    """
    if method == "eigh":
        _, V = jnp.linalg.eigh(A)
        return V[..., :, 0]
    return smallest_eigvec_psd(A, iters=iters)


def polar_orthogonalize(M: jnp.ndarray, iters: int = 4) -> jnp.ndarray:
    """Orthogonal (rotation) factor of batched 3x3 matrices via Higham's
    Newton iteration X <- (X + X^{-T})/2 — converges quadratically to the
    polar factor without SVD (batched 3x3 SVD can lower to slow per-matrix loops). Input must
    have det > 0 for a proper rotation."""
    X = M / jnp.maximum(
        jnp.linalg.norm(M, axis=(-2, -1), keepdims=True) / jnp.sqrt(3.0), 1e-12
    )
    for _ in range(iters):
        Xinv_T = jnp.swapaxes(jnp.linalg.inv(X), -1, -2)
        X = 0.5 * (X + Xinv_T)
    return X


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form cofactor inverse of batched 3x3 matrices.

    Replaces `jnp.linalg.inv` in the BA hot path: a batched LU is a loop per
    block where this is plain elementwise arithmetic, and an LU lowering
    has returned inf for well-conditioned near-identity inputs (see
    `geometry/sim3._inv3x3`). Intended for damped SPD blocks
    (Hll + lam*I), where the determinant floor never engages."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    eps = jnp.asarray(1e-30, M.dtype)
    det = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), (b * f - c * e)], axis=-1),
            jnp.stack([B, (a * i - c * g), -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), (a * e - b * d)], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]
