"""Reprojection residuals with hand-coded analytic Jacobians.

The batched replacement for g2o's `EdgeSE3ProjectXYZ` / `EdgeSE3ProjectXYZOnlyPose`
(`types/types_six_dof_expmap.cpp:103-139`): residual r = pi(K, T X) - uv, with
the classic 2x6 pose Jacobian (for a LEFT-multiplied twist update
T <- exp(xi) T, xi = (omega, upsilon) — the same update g2o's VertexSE3Expmap
applies in `types_six_dof_expmap.h:73-76`) and the 2x3 point Jacobian
dr/dX = dr/dXc @ R.

Everything is per-edge and batch-leading: shapes (..., ) broadcast, so the BA
engines call these once over the whole edge array.
"""

from __future__ import annotations

import jax.numpy as jnp

from monocular_slam_tpu.geometry import se3
from monocular_slam_tpu.geometry.so3 import hat
from monocular_slam_tpu.utils.precision import small_mm

_EPS = 1e-8


def project_point(T: jnp.ndarray, X: jnp.ndarray, k: jnp.ndarray):
    """Camera-frame point and projection. T: (...,3,4), X: (...,3), k: (...,4).
    Returns (Xc, uv_hat)."""
    Xc = se3.apply(T, X)
    z = Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < _EPS, jnp.where(z < 0, -_EPS, _EPS), z)
    u = k[..., 0] * Xc[..., 0] / z_safe + k[..., 2]
    v = k[..., 1] * Xc[..., 1] / z_safe + k[..., 3]
    return Xc, jnp.stack([u, v], axis=-1)


def residual(T: jnp.ndarray, X: jnp.ndarray, k: jnp.ndarray, uv: jnp.ndarray):
    """r = projection - observation, shape (..., 2)."""
    _, uv_hat = project_point(T, X, k)
    return uv_hat - uv


def _dproj_dXc(Xc: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """d pi / d Xc: (..., 2, 3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < _EPS, jnp.where(z < 0, -_EPS, _EPS), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    fx, fy = k[..., 0], k[..., 1]
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1)
    row1 = jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def linearize(T: jnp.ndarray, X: jnp.ndarray, k: jnp.ndarray, uv: jnp.ndarray):
    """Residual + analytic Jacobians.

    Returns (r (...,2), Jp (...,2,6), Jl (...,2,3)) where Jp is w.r.t. the
    left twist xi = (omega, upsilon) of the pose update exp(xi) T and Jl is
    w.r.t. the world point. Equivalent to the closed forms in
    `types_six_dof_expmap.cpp:103-139` (up to the error-sign convention:
    we use r = proj - obs, g2o uses obs - proj, so J here = -J_g2o — the
    normal equations J^T J dx = -J^T r are identical).
    """
    Xc = se3.apply(T, X)
    z = Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < _EPS, jnp.where(z < 0, -_EPS, _EPS), z)
    u = k[..., 0] * Xc[..., 0] / z_safe + k[..., 2]
    v = k[..., 1] * Xc[..., 1] / z_safe + k[..., 3]
    r = jnp.stack([u, v], axis=-1) - uv

    A = _dproj_dXc(Xc, k)  # (..., 2, 3)
    # Left-multiplied twist: dXc/d(omega) = -hat(Xc), dXc/d(upsilon) = I
    dXc_dxi = jnp.concatenate(
        [-hat(Xc), jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape + (3,))],
        axis=-1,
    )  # (..., 3, 6)
    # expanded tiny matmuls (see utils.precision.small_mm): exact f32
    # elementwise math, no per-edge tiny dot
    Jp = small_mm(A, dXc_dxi)  # (..., 2, 6)
    Jl = small_mm(A, se3.rotation(T))  # (..., 2, 3)
    return r, Jp, Jl


def chi2(r: jnp.ndarray, info: jnp.ndarray | None = None) -> jnp.ndarray:
    """Squared Mahalanobis error per edge. info: scalar information weight
    per edge (the reference uses I_2 / scale, `src/Util.cpp:141-153`)."""
    e2 = jnp.sum(r * r, axis=-1)
    return e2 if info is None else e2 * info
