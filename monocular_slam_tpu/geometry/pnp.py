"""Perspective-n-Point: batched DLT minimal solver + vmapped RANSAC + LM refine.

Replaces the reference's `cv::solvePnPRansac` call in the tracking path
(`src/CameraPoseEstimator.cpp:462-474`). Shape: K hypothesis samples of 6
3D-2D correspondences are solved simultaneously (one batched 12x12
eigendecomposition), scored by reprojection inliers, and the winner is
polished with the Huber LM pose refiner (`optim/pose_ba.py`) on its inlier
set — which also replaces the pose-only BA the reference disabled
(`src/CameraPoseEstimator.cpp:482-483`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monocular_slam_tpu.geometry import camera as cam
from monocular_slam_tpu.geometry import se3, so3
from monocular_slam_tpu.geometry.epipolar import _sample_indices
from monocular_slam_tpu.optim import pose_ba
from monocular_slam_tpu.utils.precision import (
    einsum_hp as _einsum,
    matmul_hp as _mm,
    small_gram,
    small_mv,
)

_EPS = 1e-12
MIN_SAMPLE = 6


def pnp_dlt(
    X: jnp.ndarray,
    xy: jnp.ndarray,
    w: jnp.ndarray | None = None,
    solver: str = "eigh",
) -> jnp.ndarray:
    """DLT PnP from n >= 6 points. X: (..., n, 3) world points; xy: (..., n, 2)
    NORMALIZED image coords (K^-1 pixels); w: optional (..., n) weights.
    Returns (..., 3, 4) world->camera pose with R projected to SO(3).
    """
    if w is None:
        w = jnp.ones(X.shape[:-1], dtype=X.dtype)
    n = X.shape[-2]
    Xh = jnp.concatenate([X, jnp.ones(X.shape[:-1] + (1,), X.dtype)], axis=-1)  # (..., n, 4)
    zeros = jnp.zeros_like(Xh)
    x, y = xy[..., 0:1], xy[..., 1:2]
    rows1 = jnp.concatenate([Xh, zeros, -x * Xh], axis=-1)  # (..., n, 12)
    rows2 = jnp.concatenate([zeros, Xh, -y * Xh], axis=-1)
    A = jnp.concatenate([rows1 * w[..., None], rows2 * w[..., None]], axis=-2)  # (..., 2n, 12)
    AtA = small_gram(A)  # 2n rows expanded (see utils.precision)
    from monocular_slam_tpu.utils.linalg import nullspace_vector

    p = nullspace_vector(AtA, method=solver)
    P = p.reshape(p.shape[:-1] + (3, 4))
    # Fix sign: points must have positive depth on average.
    depth = small_mv(P[..., None, :, :], Xh)[..., 2]
    sgn = jnp.where(jnp.sum(jnp.sign(depth) * w, axis=-1) < 0, -1.0, 1.0)
    P = P * sgn[..., None, None]
    M = P[..., :3, :3]
    if solver == "inv_iter":
        # SVD-free fast path for hypothesis batches: scale from det(M)^(1/3)
        # (det = s^3 for a scaled rotation), rotation via Newton polar
        # iteration. Exact-path refits keep the SVD forms.
        from monocular_slam_tpu.utils.linalg import polar_orthogonalize

        det = jnp.linalg.det(M)
        scale = jnp.cbrt(jnp.maximum(det, _EPS))
        R = polar_orthogonalize(M / jnp.maximum(scale, _EPS)[..., None, None])
    else:
        # Scale so that M is a rotation: divide by the mean singular value.
        s = jnp.linalg.svd(M, compute_uv=False)
        scale = jnp.mean(s, axis=-1)
        R = so3.project_to_so3(M)
    t = P[..., :3, 3] / jnp.maximum(scale, _EPS)[..., None]
    return se3.from_Rt(R, t)


class PnPResult(NamedTuple):
    T: jnp.ndarray  # (3, 4) world->camera
    inliers: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray
    ok: jnp.ndarray  # bool — solution trustworthy (enough inliers)


def _score_pose(T, X, uv, k, mask, px_thresh):
    """Inlier mask + count of one pose hypothesis (broadcasts over leading
    hypothesis axes of T)."""
    Xc = se3.apply(T[..., None, :, :], X)  # (..., N, 3)
    proj = cam.project(k, Xc)
    err2 = jnp.sum((proj - uv) ** 2, axis=-1)
    inl = (err2 < px_thresh * px_thresh) & (Xc[..., 2] > 0) & mask
    return inl, jnp.sum(inl, axis=-1)


def solve_pnp_ransac(
    key: jax.Array,
    X: jnp.ndarray,
    uv: jnp.ndarray,
    k: jnp.ndarray,
    mask: jnp.ndarray,
    n_iters: int = 512,
    px_thresh: float = 3.0,
    min_inliers: int = 10,
    refine: bool = True,
    T_init: jnp.ndarray | None = None,
    lo_rounds: int = 2,
) -> PnPResult:
    """LO-RANSAC PnP. X: (N, 3) map points; uv: (N, 2) pixels; k: (4,);
    mask: (N,).

    Replaces `cv::solvePnPRansac` (`src/CameraPoseEstimator.cpp:472`). The
    reference hardcodes TUM-F1 distortion there for every dataset (SURVEY 2.4
    bug) — here the caller undistorts once upstream instead.

    Robustness structure (each step measured against seed-flakiness on the
    rendered bench, where plain 6-pt-DLT RANSAC tracked 10/60 frames on an
    unlucky PRNG seed):
      * `T_init` (e.g. the tracker's constant-velocity prediction) rides the
        hypothesis pool for free — tracking never does worse than the motion
        model's own consensus.
      * LO (locally-optimized) rounds: the best minimal hypothesis is refit
        with the EXACT weighted DLT over its full inlier set and re-scored,
        twice. A noisy 6-point hypothesis that captures only part of its
        true consensus gets pulled onto all of it — removing the key-to-key
        variance of minimal-sample RANSAC (a weak-but-right hypothesis now
        converges to the pose a lucky draw would have found directly).
    """
    N = X.shape[0]
    xy = cam.normalize_points(k, uv)  # (N, 2)

    idx = _sample_indices(key, n_iters, MIN_SAMPLE, mask)  # (K, 6)
    # Fast approximate nullspace for the hypothesis batch; the LM refinement
    # below polishes the winner exactly.
    T_h = pnp_dlt(X[idx], xy[idx], solver="inv_iter")  # (K, 3, 4)
    if T_init is not None:
        T_h = jnp.concatenate([T_h, T_init[None]], axis=0)

    # Score: reprojection error of ALL points under each hypothesis.
    inl, scores = _score_pose(T_h, X[None], uv[None], k, mask[None], px_thresh)
    best = jnp.argmax(scores)
    T_best = T_h[best]
    inl_best = inl[best]
    n_best = scores[best]

    for _ in range(lo_rounds):
        w = (inl_best & mask).astype(X.dtype)
        T_lo = pnp_dlt(X, xy, w=w, solver="eigh")
        inl_lo, n_lo = _score_pose(T_lo, X, uv, k, mask, px_thresh)
        use = n_lo > n_best
        T_best = jnp.where(use, T_lo, T_best)
        inl_best = jnp.where(use, inl_lo, inl_best)
        n_best = jnp.where(use, n_lo, n_best)

    if refine:
        res = pose_ba.refine_pose(
            T_best, X, uv, k, inl_best.astype(X.dtype), n_rounds=2,
            solver="gn",
        )
        # Accept the refinement only if it keeps at least as many inliers.
        use = res.n_inliers >= jnp.sum(inl_best)
        T_fin = jnp.where(use, res.T, T_best)
        inl_fin = jnp.where(use, res.inliers, inl_best)
    else:
        T_fin, inl_fin = T_best, inl_best

    n_inl = jnp.sum(inl_fin)
    return PnPResult(T_fin, inl_fin, n_inl, n_inl >= min_inliers)
