"""SO(3) rotation group: exp/log maps, quaternion conversions.

Vectorized replacement for the rotation handling scattered through the
reference (quaternion->R in `src/FrameLoader.cpp:97-114`, g2o
`types/se3quat.h` exp/log). All functions are elementwise-safe (no
data-dependent branches — `jnp.where` with Taylor fallbacks) so they can be
vmapped and jitted with static shapes.

Conventions: rotation matrices are world->camera unless stated otherwise;
quaternions are (x, y, z, w) to match TUM groundtruth files.
"""

from __future__ import annotations

import jax.numpy as jnp

from monocular_slam_tpu.utils.precision import einsum_hp as _einsum, matmul_hp as _mm, small_mm

_EPS = 1e-8  # floor for safe divisions


def _small_thresh(dtype) -> float:
    """Angle^2 below which Taylor series replace trig ratios: theta < eps^(1/4)
    (~1.9e-2 in f32, ~1.2e-4 in f64) — where series truncation error and
    cancellation error in the closed forms cross over."""
    import numpy as _np

    return float(_np.sqrt(_np.finfo(_np.dtype(dtype).name).eps))


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula, exp: so(3) -> SO(3). (..., 3) -> (..., 3, 3).

    Uses sinc-style Taylor fallbacks near theta = 0 so gradients are finite.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _small_thresh(w.dtype)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallback.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS * _EPS))
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * small_mm(W, W)


def log(R: jnp.ndarray) -> jnp.ndarray:
    """log: SO(3) -> so(3). (..., 3, 3) -> (..., 3).

    Stable for theta near 0 and near pi (uses the diagonal for the axis
    magnitude when sin(theta) is tiny).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    antisym = vee(R - jnp.swapaxes(R, -1, -2))
    # theta via atan2(sin, cos) rather than arccos: arccos has a NaN/inf
    # tangent at cos = 1 (identity rotation) which poisons autodiff through
    # log — e.g. pose-graph Jacobians evaluated at zero residual. atan2 is
    # smooth there. |vee(R - R^T)| = 2 sin(theta).
    # Guard must be a NORMAL number in the working dtype: 1e-40 underflows to
    # a (often flushed-to-zero) denormal in f32, making d/dq sqrt(q+guard)
    # infinite at q == 0 — exactly-symmetric residual rotations then poison
    # every pose-graph Jacobian with NaN (seen in f32).
    tiny = jnp.finfo(R.dtype).tiny
    sin_t = 0.5 * jnp.sqrt(jnp.sum(antisym * antisym, axis=-1) + tiny)
    theta = jnp.arctan2(sin_t, cos_t)

    # Generic branch: w = theta/(2 sin t) * vee(R - R^T)
    small = jnp.abs(sin_t) < _EPS
    factor = jnp.where(
        small, 0.5 + theta * theta / 12.0, theta / jnp.where(small, 1.0, 2.0 * sin_t)
    )
    w_generic = factor[..., None] * antisym

    # Near pi the antisymmetric part cancels catastrophically. Instead recover
    # the axis exactly from the symmetric part:
    #   (R + R^T)/2 = cos(t) I + (1 - cos(t)) a a^T
    # so N = ((R + R^T)/2 - cos(t) I) / (1 - cos(t)) = a a^T with no
    # sin-magnitude contamination; take the column with the largest diagonal.
    near_pi = cos_t < -0.9
    one_minus_cos = jnp.maximum(1.0 - cos_t, _EPS)
    sym = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    N = (sym - cos_t[..., None, None] * eye) / one_minus_cos[..., None, None]
    diag = jnp.stack([N[..., 0, 0], N[..., 1, 1], N[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(N, k[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    axis = col / jnp.maximum(jnp.linalg.norm(col, axis=-1, keepdims=True), _EPS)
    # Sign from the antisymmetric part (sign-stable even when its magnitude
    # isn't); exactly at pi the sign is genuinely free (R(pi,a) == R(pi,-a)).
    sign = jnp.where(jnp.sum(axis * antisym, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign

    return jnp.where(near_pi[..., None], w_pi, w_generic)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix. Mirrors the reference's
    TUM groundtruth conversion (`src/FrameLoader.cpp:97-114`) but normalized
    and batched."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), branch-free.

    Computes all four Shepperd candidates and selects the best-conditioned via
    argmax, so it vmaps cleanly.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS * _EPS))

    # Candidate 0: w largest
    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = jnp.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], axis=-1)
    # Candidate 1: x largest
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], axis=-1)
    # Candidate 2: y largest
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = jnp.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], axis=-1)
    # Candidate 3: z largest
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = jnp.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], axis=-1)

    scores = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1)
    cands = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4, 4)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)


def project_to_so3(M: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD, det = +1 enforced."""
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(_mm(U, Vt))
    D = jnp.ones(M.shape[:-2] + (3,), dtype=M.dtype)
    D = D.at[..., 2].set(det)
    return _mm(U * D[..., None, :], Vt)
