"""Two-view epipolar geometry: eight-point, Sampson, E decomposition, cheirality.

Vectorized replacement for the reference's two-view bootstrap
(`src/CameraPoseEstimator.cpp:264-376` and the from-scratch estimator at
`:596-786`). The reference runs a sequential 2000-iteration RANSAC loop with a
per-sample 8x9 SVD; here every hypothesis is a lane of a vmapped batch: one
batched constraint build, one batched 9x9 eigendecomposition, one batched
Sampson evaluation, one argmax. No Python-level data-dependent control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monocular_slam_tpu.utils.precision import (
    einsum_hp as _einsum,
    matmul_hp as _mm,
    small_gram,
    small_mm,
    small_mv,
)

from monocular_slam_tpu.geometry import camera as cam
from monocular_slam_tpu.geometry import se3, triangulate

_EPS = 1e-12


def hartley_normalize(uv: jnp.ndarray, mask: jnp.ndarray | None = None):
    """Hartley normalization (zero mean, RMS distance sqrt(2)) — the same
    conditioning step as the reference's scratch 8-point
    (`src/CameraPoseEstimator.cpp:609-623`). Returns (uv_norm, T) with T the
    3x3 transform s.t. uv_norm_h = T @ uv_h. Masked points are ignored in the
    statistics but still transformed."""
    if mask is None:
        mask = jnp.ones(uv.shape[:-1], dtype=bool)
    w = mask.astype(uv.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1.0)
    mean = jnp.sum(uv * w[..., None], axis=-2, keepdims=True) / n[..., None]
    d = jnp.linalg.norm(uv - mean, axis=-1)
    mean_d = jnp.sum(d * w, axis=-1, keepdims=True) / n
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, _EPS)
    uv_n = (uv - mean) * s[..., None]
    zeros = jnp.zeros_like(s[..., 0])
    ones = jnp.ones_like(s[..., 0])
    sx = s[..., 0]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    T = jnp.stack(
        [
            jnp.stack([sx, zeros, -sx * mx], axis=-1),
            jnp.stack([zeros, sx, -sx * my], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return uv_n, T


def _constraint_rows(uv1: jnp.ndarray, uv2: jnp.ndarray) -> jnp.ndarray:
    """Epipolar constraint rows a_i s.t. a_i . vec(F) = 0, vec row-major:
    [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1] (x2^T F x1 = 0)."""
    x1, y1 = uv1[..., 0], uv1[..., 1]
    x2, y2 = uv2[..., 0], uv2[..., 1]
    one = jnp.ones_like(x1)
    return jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )


def eight_point(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    solver: str = "eigh",
) -> jnp.ndarray:
    """(Weighted) eight-point algorithm with Hartley normalization and rank-2
    projection. uv1, uv2: (..., N, 2) pixel or normalized coords; weights
    (..., N) optional (inlier mask for refits). Returns F (..., 3, 3) with
    ||F|| = 1. Same math as `src/CameraPoseEstimator.cpp:672-713`, batched."""
    if weights is None:
        weights = jnp.ones(uv1.shape[:-1], dtype=uv1.dtype)
    mask = weights > 0
    uv1n, T1 = hartley_normalize(uv1, mask)
    uv2n, T2 = hartley_normalize(uv2, mask)
    A = _constraint_rows(uv1n, uv2n) * weights[..., None]
    # r=N-row Gram expanded to broadcast-multiply-sum (see
    # utils.precision.small_mv)
    AtA = small_gram(A)  # (..., 9, 9)
    from monocular_slam_tpu.utils.linalg import nullspace_vector

    f = nullspace_vector(AtA, method=solver)
    F = f.reshape(f.shape[:-1] + (3, 3))
    # Rank-2 projection (zero the smallest singular value) — the enforcement
    # step at `src/CameraPoseEstimator.cpp:700-708`.
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)
    F = small_mm(U * S[..., None, :], Vt)
    # Denormalize: F = T2^T Fn T1
    F = small_mm(small_mm(jnp.swapaxes(T2, -1, -2), F), T1)
    return F / jnp.maximum(jnp.linalg.norm(F, axis=(-2, -1), keepdims=True), _EPS)


def sampson_distance(F: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) distance per correspondence — the
    inlier metric of the reference's scratch RANSAC
    (`src/CameraPoseEstimator.cpp:715-763`). F: (..., 3, 3); uv: (..., N, 2)."""
    ones = jnp.ones(uv1.shape[:-1] + (1,), dtype=uv1.dtype)
    x1 = jnp.concatenate([uv1, ones], axis=-1)
    x2 = jnp.concatenate([uv2, ones], axis=-1)
    Fx1 = small_mv(F[..., None, :, :], x1)  # (..., N, 3), j=3 expanded
    Ftx2 = small_mv(jnp.swapaxes(F, -1, -2)[..., None, :, :], x2)
    num = jnp.square(jnp.sum(x2 * Fx1, axis=-1))
    den = (
        jnp.square(Fx1[..., 0])
        + jnp.square(Fx1[..., 1])
        + jnp.square(Ftx2[..., 0])
        + jnp.square(Ftx2[..., 1])
    )
    return num / jnp.maximum(den, _EPS)


def epipolar_line(F: jnp.ndarray, uv1: jnp.ndarray) -> jnp.ndarray:
    """Lines l2 = F x1 in image 2 (a, b, c) with ax+by+c=0 — the quantity the
    reference's debug tool draws (`src/SFMDebugging.cpp:21-40`)."""
    ones = jnp.ones(uv1.shape[:-1] + (1,), dtype=uv1.dtype)
    x1 = jnp.concatenate([uv1, ones], axis=-1)
    return small_mv(F[..., None, :, :], x1)


class RansacResult(NamedTuple):
    F: jnp.ndarray  # (3, 3) best model after inlier refit
    inliers: jnp.ndarray  # (N,) bool
    num_inliers: jnp.ndarray  # scalar int32
    best_score: jnp.ndarray  # scalar — inlier count of the best raw hypothesis


def _sample_indices(key, n_hyp: int, sample_size: int, mask: jnp.ndarray) -> jnp.ndarray:
    """Draw `n_hyp` samples of `sample_size` distinct indices restricted to
    `mask` via the Gumbel-top-k trick: one batched top_k instead of the
    reference's sequential rejection sampling (`CameraPoseEstimator.cpp:766-786`)."""
    n = mask.shape[-1]
    g = jax.random.uniform(key, (n_hyp, n), minval=1e-6, maxval=1.0)
    logits = jnp.log(g) + jnp.where(mask[None, :], 0.0, -1e30)
    _, idx = jax.lax.top_k(logits, sample_size)
    return idx  # (n_hyp, sample_size)


def ransac_fundamental(
    key: jax.Array,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    n_iters: int = 2000,
    thresh: float = 1.5,
) -> RansacResult:
    """Vmapped RANSAC for F. uv: (N, 2) pixels; mask: (N,) valid matches.

    `n_iters` hypotheses are evaluated simultaneously (default matches the
    reference's `ransac_iters = 2000`, `src/CameraPoseEstimator.cpp:26`).
    `thresh` is in pixels of Sampson error (sqrt of the squared distance).
    """
    idx = _sample_indices(key, n_iters, 8, mask)  # (K, 8)
    s1 = uv1[idx]  # (K, 8, 2)
    s2 = uv2[idx]
    # Hypothesis batch uses fast inverse iteration instead of batched eigh
    # (batched eigh on K x 9x9 is the RANSAC bottleneck); the refit below is
    # exact.
    F_h = eight_point(s1, s2, solver="inv_iter")  # (K, 3, 3)
    d2 = sampson_distance(F_h, uv1[None], uv2[None])  # (K, N)
    inl = (d2 < thresh * thresh) & mask[None]
    scores = jnp.sum(inl, axis=-1)
    best = jnp.argmax(scores)
    best_inl = inl[best]
    # Refit on the best hypothesis's inliers (the reference refits with the
    # 8-point on inliers, `src/CameraPoseEstimator.cpp:566-585`).
    F_fit = eight_point(uv1, uv2, weights=best_inl.astype(uv1.dtype))
    d2_fit = sampson_distance(F_fit, uv1, uv2)
    inl_fit = (d2_fit < thresh * thresh) & mask
    # Keep whichever of {refit, raw best} explains more points (refit can
    # regress when the inlier set is contaminated).
    use_fit = jnp.sum(inl_fit) >= scores[best]
    F_best = jnp.where(use_fit, F_fit, F_h[best])
    inliers = jnp.where(use_fit, inl_fit, best_inl)
    return RansacResult(F_best, inliers, jnp.sum(inliers), scores[best])


def essential_from_fundamental(F: jnp.ndarray, k1: jnp.ndarray, k2: jnp.ndarray) -> jnp.ndarray:
    """E = K2^T F K1 (`src/CameraPoseEstimator.cpp:180-182`)."""
    K1 = cam.intrinsics_to_matrix(k1)
    K2 = cam.intrinsics_to_matrix(k2)
    return _mm(_mm(jnp.swapaxes(K2, -1, -2), F), K1)


def decompose_essential(E: jnp.ndarray):
    """SVD decomposition of E into two rotations and a translation direction
    (Hartley-Zisserman result 9.19, as in `src/CameraPoseEstimator.cpp:154-174`).
    Returns (R1, R2, t) with det(R) = +1 enforced; candidates are
    (R1, t), (R1, -t), (R2, t), (R2, -t)."""
    U, _, Vt = jnp.linalg.svd(E)
    # Enforce proper rotations by sign-flipping U/Vt as needed.
    detU = jnp.linalg.det(U)
    detVt = jnp.linalg.det(Vt)
    U = U * jnp.where(detU < 0, -1.0, 1.0)
    Vt = Vt * jnp.where(detVt < 0, -1.0, 1.0)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = _mm(_mm(U, W), Vt)
    R2 = _mm(_mm(U, W.T), Vt)
    t = U[..., :, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), _EPS)
    return R1, R2, t


class TwoViewResult(NamedTuple):
    T_21: jnp.ndarray  # (3, 4) relative pose: cam1 frame -> cam2 frame
    points: jnp.ndarray  # (N, 3) triangulated in cam1 frame
    good: jnp.ndarray  # (N,) cheirality + used mask
    n_good: jnp.ndarray


def pose_from_essential(
    E: jnp.ndarray,
    k1: jnp.ndarray,
    k2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    min_depth: float = 1e-4,
    max_depth: float = 1e4,
) -> TwoViewResult:
    """Pick the (R, t) candidate with the best cheirality vote and return the
    relative pose + triangulated structure. Mirrors the reference's 4-candidate
    test (`src/CameraPoseEstimator.cpp:337-355`) but triangulates all points
    for all 4 candidates in one batched call."""
    R1, R2, t = decompose_essential(E)
    cands_R = jnp.stack([R1, R1, R2, R2])  # (4, 3, 3)
    cands_t = jnp.stack([t, -t, t, -t])  # (4, 3)
    T1 = se3.identity(E.dtype)  # cam1 at origin
    T2 = se3.from_Rt(cands_R, cands_t)  # (4, 3, 4)

    X = triangulate.triangulate_two_view(
        k1, jnp.broadcast_to(T1, (4, 3, 4)), k2, T2, uv1[None], uv2[None]
    )  # (4, N, 3)
    z1 = X[..., 2]
    z2 = triangulate.depths(T2, X)
    ok = (
        (z1 > min_depth)
        & (z1 < max_depth)
        & (z2 > min_depth)
        & (z2 < max_depth)
        & mask[None]
    )
    votes = jnp.sum(ok, axis=-1)
    best = jnp.argmax(votes)
    return TwoViewResult(T2[best], X[best], ok[best], votes[best])
