"""Sim(3) similarity transforms for monocular loop closure.

Replaces g2o's `types/sim3.h` (vendored in the reference for the never-
finished `LoopCloser::ComputeSim3`, `src/LoopCloser.cpp:147-150`). A Sim3 is
represented as a pytree-friendly tuple of arrays ``(R, t, s)`` packed into a
single (..., 3, 5) array: columns 0:3 = R, column 3 = t, column 4 row 0 = s
(rows 1, 2 of column 4 are zero padding). Helpers pack/unpack so downstream
code can treat Sim3 like the (3, 4) SE3 arrays.

exp/log follow the standard Sim(3) formulas (omega, upsilon, sigma) with
sigma = log s.
"""

from __future__ import annotations

import jax.numpy as jnp

from monocular_slam_tpu.utils.precision import einsum_hp as _einsum, matmul_hp as _mm

from monocular_slam_tpu.geometry import so3

_EPS = 1e-8


def pack(R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """(...,3,3), (...,3), (...,) -> (..., 3, 5)."""
    s_col = jnp.zeros(R.shape[:-2] + (3, 1), dtype=R.dtype)
    s_col = s_col.at[..., 0, 0].set(s)
    return jnp.concatenate([R, t[..., None], s_col], axis=-1)


def unpack(S: jnp.ndarray):
    return S[..., :3, :3], S[..., :3, 3], S[..., 0, 4]


def identity(dtype=jnp.float32, batch_shape=()) -> jnp.ndarray:
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), tuple(batch_shape) + (3, 3))
    t = jnp.zeros(tuple(batch_shape) + (3,), dtype=dtype)
    s = jnp.ones(tuple(batch_shape), dtype=dtype)
    return pack(R, t, s)


def from_se3(T: jnp.ndarray, s=None) -> jnp.ndarray:
    """Lift an SE3 (..., 3, 4) to Sim3 with scale s (default 1)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    if s is None:
        s = jnp.ones(T.shape[:-2], dtype=T.dtype)
    return pack(R, t, s)


def to_se3(S: jnp.ndarray) -> jnp.ndarray:
    """Project to SE3: keep R, scale the translation by 1/s (the ORB-SLAM
    convention for applying a loop-closure Sim3 correction to keyframe poses)."""
    R, t, s = unpack(S)
    return jnp.concatenate([R, (t / jnp.maximum(s, _EPS)[..., None])[..., None]], axis=-1)


def apply(S: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """x -> s R x + t."""
    R, t, s = unpack(S)
    return s[..., None] * _einsum("...ij,...j->...i", R, X) + t


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """A after B: (sA RA)(sB RB x + tB) + tA."""
    Ra, ta, sa = unpack(A)
    Rb, tb, sb = unpack(B)
    return pack(_mm(Ra, Rb), sa[..., None] * _einsum("...ij,...j->...i", Ra, tb) + ta, sa * sb)


def inverse(S: jnp.ndarray) -> jnp.ndarray:
    R, t, s = unpack(S)
    Rt = jnp.swapaxes(R, -1, -2)
    sinv = 1.0 / jnp.maximum(s, _EPS)
    return pack(Rt, -sinv[..., None] * _einsum("...ij,...j->...i", Rt, t), sinv)


def _V_matrix(omega: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """The sim(3) translation mixing matrix V(omega, sigma) with
    t = V upsilon (Strasdat's thesis / Sophus). Shared by exp and log so the
    two are exact inverses by construction."""
    s = jnp.exp(sigma)
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    W = so3.hat(omega)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)

    # W(sigma, theta) matrix coefficients (Strasdat's thesis / Sophus):
    # V = A*I + B*W + C*W2 with
    #   s = e^sigma;
    #   A = (s-1)/sigma                                     [-> 1 at sigma=0]
    #   B = (sigma*s*sin + (1 - s*cos)*theta)/(th*(s2+th2)) [-> (1-cos)/th2]
    #   C = (A - ((s*cos - 1)*sigma + s*sin*theta)/(s2+th2)) / th2
    #
    # Branch thresholds MUST be dtype-aware (eps^(1/4), same rule as
    # `so3._small_angle_threshold`): the generic formulas divide O(eps)
    # rounding error by th*(s2+th2). With the old fixed 1e-8/1e-6 cutoffs a
    # theta ~ 1.5e-4 rotation in f32 (trig error ~1e-7 absolute) made V
    # wrong by factors of 10-1000 and pose-graph residual upsilons exploded.
    # Cancellation-stable pieces: s-1 via expm1, 1 - s*cos via
    # 2 sin^2(th/2) - (s-1) cos.
    eps4 = jnp.sqrt(jnp.sqrt(jnp.finfo(omega.dtype).eps))  # ~1.9e-2 f32
    small_sig = jnp.abs(sigma) < eps4
    small_th = theta < eps4
    sig_safe = jnp.where(small_sig, 1.0, sigma)
    th_safe = jnp.where(small_th, 1.0, theta)
    s2t2 = sigma * sigma + theta2
    s2t2_safe = jnp.where(small_sig & small_th, 1.0, s2t2)

    s_m1 = jnp.expm1(sigma)  # s - 1, exact near sigma = 0
    A = jnp.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, s_m1 / sig_safe)

    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    half_sin = jnp.sin(0.5 * theta)
    one_m_scos = 2.0 * half_sin * half_sin - s_m1 * cos_t  # 1 - s cos(theta)

    B_gen = (sigma * s * sin_t + one_m_scos * theta) / jnp.where(
        small_th, 1.0, th_safe * s2t2_safe
    )
    # theta -> 0 limit of B: ((sigma - 1) s + 1)/sigma^2
    B_sig = jnp.where(
        small_sig,
        0.5 + sigma / 3.0 + sigma * sigma / 8.0,
        (sig_safe * s - s_m1) / (sig_safe * sig_safe),
    )
    B = jnp.where(small_th, B_sig, B_gen)

    C_gen = (
        A - (s * sin_t * theta - one_m_scos * sigma) / s2t2_safe
    ) / jnp.where(small_th, 1.0, theta2)
    # theta -> 0 limit of C: (s*(0.5 sigma^2 - sigma + 1) - 1)/sigma^3
    C_sig = jnp.where(
        small_sig,
        1.0 / 6.0 + sigma / 8.0 + sigma * sigma / 20.0,
        (s * (0.5 * sig_safe * sig_safe - sig_safe + 1.0) - 1.0) / (sig_safe**3),
    )
    C = jnp.where(small_th, C_sig, C_gen)

    return A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2


def _inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form cofactor inverse of a batched 3x3 matrix.

    Used instead of jnp.linalg.solve/inv in the exp/log hot path: an LU
    lowering has returned inf for well-conditioned near-identity V
    matrices (every pose-graph residual upsilon became inf), while the
    cofactor form is plain elementwise arithmetic and exact to f32
    rounding."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < _EPS, jnp.where(det < 0, -_EPS, _EPS), det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), (b * f - c * e)], axis=-1),
            jnp.stack([B, (a * i - c * g), -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), (a * e - b * d)], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """exp: sim(3) -> Sim(3). xi = (..., 7) as (omega[3], upsilon[3], sigma)."""
    omega, upsilon, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    V = _V_matrix(omega, sigma)
    t = _einsum("...ij,...j->...i", V, upsilon)
    return pack(so3.exp(omega), t, jnp.exp(sigma))


def log(S: jnp.ndarray) -> jnp.ndarray:
    """log: Sim(3) -> sim(3). upsilon = V^{-1} t with V rebuilt from
    (omega, sigma) by the same `_V_matrix` used in exp, so exp/log are exact
    inverses by construction; V is inverted in closed form (`_inv3x3`)."""
    R, t, s = unpack(S)
    omega = so3.log(R)
    sigma = jnp.log(jnp.maximum(s, _EPS))
    V = _V_matrix(omega, sigma)
    upsilon = _einsum("...ij,...j->...i", _inv3x3(V), t)
    return jnp.concatenate([omega, upsilon, sigma[..., None]], axis=-1)
