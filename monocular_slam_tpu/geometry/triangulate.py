"""DLT triangulation, batched over points (and over candidate poses).

Replaces `TriangulateSinglePointFromTwoView` / `TriangulateMultiplePoints-
FromTwoView` in the reference (`src/CameraPoseEstimator.cpp:86-152`), which
loop a 4x4 SVD per point. Here the per-point 4x4 nullspace problem is solved
for ALL points at once with a batched eigendecomposition of A^T A (4x4
symmetric — cheap, vmappable, and far friendlier to XLA than per-point SVD
loops).
"""

from __future__ import annotations

import jax.numpy as jnp

from monocular_slam_tpu.utils.precision import (
    einsum_hp as _einsum,
    matmul_hp as _mm,
    small_gram,
)

from monocular_slam_tpu.geometry import camera as cam

_EPS = 1e-12


def projection_matrix(k: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    """P = K [R | t] : intrinsics (...,4) + pose (...,3,4) -> (...,3,4)."""
    return _mm(cam.intrinsics_to_matrix(k), T)


def triangulate_dlt(
    P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray
) -> jnp.ndarray:
    """Two-view DLT. P1, P2: (..., 3, 4) projection matrices; uv1, uv2:
    (..., N, 2) pixels. Returns world points (..., N, 3).

    Builds the classic 4x4 DLT system per point (same construction as
    `src/CameraPoseEstimator.cpp:96-107`) and takes the eigenvector of
    A^T A with the smallest eigenvalue (equivalent to the SVD nullspace used
    by `CommonMath::solveHLS`, `src/CommonMath.cpp:17-22`).
    """
    # rows: u*P[2] - P[0], v*P[2] - P[1] for each view
    def rows(P, uv):
        P = P[..., None, :, :]  # broadcast over N
        u = uv[..., 0:1]
        v = uv[..., 1:2]
        r0 = u * P[..., 2, :] - P[..., 0, :]
        r1 = v * P[..., 2, :] - P[..., 1, :]
        return r0, r1

    a0, a1 = rows(P1, uv1)
    a2, a3 = rows(P2, uv2)
    A = jnp.stack([a0, a1, a2, a3], axis=-2)  # (..., N, 4, 4)

    # Row-normalize for conditioning, then smallest eigenvector of A^T A.
    A = A / jnp.maximum(jnp.linalg.norm(A, axis=-1, keepdims=True), _EPS)
    AtA = small_gram(A)  # r=4 rows expanded (see utils.precision)
    _, V = jnp.linalg.eigh(AtA)  # ascending eigenvalues
    Xh = V[..., :, 0]
    w = Xh[..., 3]
    w_safe = jnp.where(jnp.abs(w) < _EPS, jnp.where(w < 0, -_EPS, _EPS), w)
    return Xh[..., :3] / w_safe[..., None]


def triangulate_two_view(
    k1: jnp.ndarray,
    T1: jnp.ndarray,
    k2: jnp.ndarray,
    T2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
) -> jnp.ndarray:
    """Convenience wrapper taking intrinsics + world->camera poses."""
    return triangulate_dlt(projection_matrix(k1, T1), projection_matrix(k2, T2), uv1, uv2)


def depths(T: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """z-coordinates of world points in the camera frame of pose T (...,3,4)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return jnp.sum(R[..., None, 2, :] * X, axis=-1) + t[..., 2:3]


def reprojection_error(
    k: jnp.ndarray, T: jnp.ndarray, X: jnp.ndarray, uv: jnp.ndarray
) -> jnp.ndarray:
    """Per-point pixel reprojection error norm; the metric the reference
    prints per frame (`src/CameraPoseEstimator.cpp:56-78`)."""
    from monocular_slam_tpu.geometry import se3

    proj = cam.project(k, se3.apply(T[..., None, :, :] if T.ndim == X.ndim else T, X))
    return jnp.linalg.norm(proj - uv, axis=-1)


def parallax_cosine(
    T1: jnp.ndarray, T2: jnp.ndarray, X: jnp.ndarray
) -> jnp.ndarray:
    """cos of the ray angle between the two camera centers and each point —
    used to gate triangulation quality (low parallax -> unstable depth)."""
    from monocular_slam_tpu.geometry import se3

    c1 = se3.camera_center(T1)[..., None, :]
    c2 = se3.camera_center(T2)[..., None, :]
    r1 = X - c1
    r2 = X - c2
    num = jnp.sum(r1 * r2, axis=-1)
    den = jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1)
    return num / jnp.maximum(den, _EPS)
