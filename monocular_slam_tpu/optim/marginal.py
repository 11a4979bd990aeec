"""Marginal covariance recovery from the BA normal equations.

Covers g2o's `MarginalCovarianceCholesky`
(`ThirdParty/g2o/g2o/core/marginal_covariance_cholesky.{h,cpp}`, 222 LoC cpp):
given the optimized graph, recover per-vertex covariance blocks of H^{-1}
without inverting the full (F*6 + P*3) system. g2o walks the sparse Cholesky
factor of the REDUCED pose system with a recursive formula; here the same
quantities fall out of the blocked Schur identities directly:

    H = [ Hpp  W  ]        S = Hpp - W Hll^{-1} W^T   (the Schur complement
        [ W^T  Hll ]                                    the solver already forms)

    (H^{-1})_pp      = S^{-1}                            pose-pose marginals
    (H^{-1})_ll,l    = Hll_l^{-1} + Hll_l^{-1} (W^T S^{-1} W)_l Hll_l^{-1}
                                                         landmark marginals
    (H^{-1})_pl      = -S^{-1} W Hll^{-1}                pose-landmark cross

All three are batched dense-block ops (one Cholesky of S + two matmuls) —
no sparse factor traversal. Gauge-fixed poses get zero covariance (they are
constants, exactly as g2o's fixed vertices are excluded from the factor).

Sized for the windows the solver itself runs at (S materializes F*6 x P*3,
like `_schur_solve` does); the million-edge CG path has no dense S and no
covariance consumer.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monocular_slam_tpu.optim import ba as ba_mod
from monocular_slam_tpu.utils.linalg import inv3x3
from monocular_slam_tpu.utils.precision import einsum_hp, matmul_hp as _mm


class MarginalCovariance(NamedTuple):
    pose_cov: jnp.ndarray  # (F, 6, 6) diagonal blocks of (H^-1)_pp
    point_cov: jnp.ndarray  # (P, 3, 3) diagonal blocks of (H^-1)_ll
    pose_cov_full: jnp.ndarray  # (F, 6, F, 6) full pose-pose marginal
    # validity masks: a block is meaningful only if its vertex is free and
    # actually constrained by edges
    pose_ok: jnp.ndarray  # (F,)
    point_ok: jnp.ndarray  # (P,)


def marginal_covariance(
    prob: ba_mod.BAProblem,
    delta: float = ba_mod.THRESH_HUBER_FULL_BA,
    damping: float = 1e-9,
) -> MarginalCovariance:
    """Marginal covariance blocks of the (robustly weighted) BA Hessian at
    the problem's current estimate. Call AFTER optimization — covariances at
    a non-converged state are not meaningful (same contract as g2o's
    `computeMarginals`).

    The gauge must be FULLY fixed for the covariance to exist: a monocular
    graph has a 7-dof gauge (6 pose + global scale), so fix at least two
    poses (or one pose + a scale constraint) via `prob.fixed`. With only
    frame 0 fixed the scale mode makes H singular and the recovered blocks
    blow up — exactly as in g2o, whose users hit the same requirement."""
    F = prob.poses.shape[0]
    P = prob.points.shape[0]
    lin = ba_mod._linearize_graph(prob, prob.poses, prob.points, delta)
    dtype = lin["Hpp"].dtype
    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)

    # constrained-vertex masks (padding slots have zero blocks)
    pose_deg = jax.ops.segment_sum(
        prob.valid.astype(jnp.int32), prob.cam_idx, num_segments=F
    )
    point_deg = jax.ops.segment_sum(
        prob.valid.astype(jnp.int32), prob.pt_idx, num_segments=P
    )
    pose_ok = (pose_deg > 0) & ~prob.fixed
    point_ok = point_deg > 0

    # tiny damping keeps padding/weak blocks factorizable without moving
    # well-conditioned covariances (g2o factors the exact H — its graphs
    # have no padding slots)
    Hll_d = lin["Hll"] + damping * eye3
    # unconstrained landmark slots get identity (inverted harmlessly below)
    Hll_d = jnp.where(point_ok[:, None, None], Hll_d, eye3)
    Hll_inv = inv3x3(Hll_d)

    from monocular_slam_tpu.utils.precision import small_mm

    Y_e = small_mm(lin["W_e"], Hll_inv[prob.pt_idx])  # (E, 6, 3)

    def scatter_fp(blocks):  # (E, 6, 3) -> (F, 6, P, 3)
        out = jnp.zeros((F, 6, P, 3), dtype=dtype)
        return out.at[prob.cam_idx, :, prob.pt_idx, :].add(blocks)

    U = scatter_fp(lin["W_e"]).reshape(F * 6, P * 3)
    Y = scatter_fp(Y_e).reshape(F * 6, P * 3)

    S = jnp.zeros((F, 6, F, 6), dtype=dtype)
    S = S.at[jnp.arange(F), :, jnp.arange(F), :].set(
        lin["Hpp"] + damping * eye6
    )
    S = S.reshape(F * 6, F * 6) - _mm(Y, U.T)

    # gauge: fixed/unconstrained poses -> identity rows (their covariance is
    # zeroed afterwards; they are constants, not estimates)
    free6 = jnp.repeat(pose_ok, 6)
    mask2d = free6[:, None] & free6[None, :]
    S = jnp.where(mask2d, S, 0.0) + jnp.diag(jnp.where(free6, 0.0, 1.0))

    cf = jax.scipy.linalg.cho_factor(S, lower=True)
    S_inv = jax.scipy.linalg.cho_solve(cf, jnp.eye(F * 6, dtype=dtype))
    S_inv = jnp.where(mask2d, S_inv, 0.0)  # constants carry zero covariance

    pose_cov_full = S_inv.reshape(F, 6, F, 6)
    pose_cov = pose_cov_full[jnp.arange(F), :, jnp.arange(F), :]

    # landmark marginals: Hll^{-1} + Hll^{-1} (U^T S^{-1} U)_ll Hll^{-1},
    # with (U^T S^{-1} U) needed only in its (P, 3, 3) diagonal blocks
    M = _mm(S_inv, U)  # (F*6, P*3)
    G = einsum_hp(
        "ipa,ipb->pab",
        U.reshape(F * 6, P, 3),
        M.reshape(F * 6, P, 3),
    )
    point_cov = Hll_inv + small_mm(small_mm(Hll_inv, G), Hll_inv)
    point_cov = jnp.where(point_ok[:, None, None], point_cov, 0.0)
    pose_cov = jnp.where(pose_ok[:, None, None], pose_cov, 0.0)
    return MarginalCovariance(
        pose_cov=pose_cov,
        point_cov=point_cov,
        pose_cov_full=pose_cov_full,
        pose_ok=pose_ok,
        point_ok=point_ok,
    )
