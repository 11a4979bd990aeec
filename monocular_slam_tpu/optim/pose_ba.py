"""Pose-only bundle adjustment (motion-only BA).

Batched replacement for `Util::PoseBundleAdjustment` (`src/Util.cpp:222-358`)
+ g2o's `EdgeSE3ProjectXYZOnlyPose`: refine one camera pose against fixed 3D
map points. The whole solver is a fixed-trip-count `lax.while_loop` over a
6x6 damped normal-equation solve — and it vmaps over a batch of frames, so
"pose-BA every frame" (which the reference designed but disabled with a debug
break, `src/Util.cpp:312`) costs one batched kernel launch.

Unlike the reference, the outlier re-classification loop actually runs: after
each round, edges with chi2 > gate are down-weighted to zero and the pose is
re-seeded (the reference re-seeds at `src/Util.cpp:307-308` but breaks out
before round 2 — SURVEY.md 2.4 says not to replicate that bug).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monocular_slam_tpu.geometry import se3
from monocular_slam_tpu.optim import lm, residuals, robust
from monocular_slam_tpu.utils.precision import einsum_hp as _einsum

# Reference hyperparameters (`src/ParamConfig.h`)
THRESH_HUBER = 5.991**0.5  # :10
CHI2_GATE = 5.991  # :12
POSE_BA_ITER = 10  # :15
POSE_BA_ROUNDS = 4  # `src/Util.cpp:236` n_round = 4 (intended)


class PoseBAResult(NamedTuple):
    T: jnp.ndarray  # (3, 4) refined pose
    inliers: jnp.ndarray  # (N,) bool — chi2 <= gate at the solution
    chi2: jnp.ndarray  # scalar robust chi2 at the solution
    n_inliers: jnp.ndarray


def _linearize(T, X, k, uv, w):
    """Weighted residual/Jacobian + normal equations for one pose."""
    r, Jp, _ = residuals.linearize(T, X, k, uv)
    e2 = jnp.sum(r * r, axis=-1)
    rho, w_rob = robust.huber(e2, THRESH_HUBER)
    wt = w * w_rob  # (N,)
    H = _einsum("nai,naj,n->ij", Jp, Jp, wt)  # (6, 6)
    b = -_einsum("nai,na,n->i", Jp, r, wt)  # (6,)
    chi2 = jnp.sum(rho * w)
    return H, b, chi2, e2


def _chi2_only(T, X, k, uv, w):
    r = residuals.residual(T, X, k, uv)
    e2 = jnp.sum(r * r, axis=-1)
    rho, _ = robust.huber(e2, THRESH_HUBER)
    return jnp.sum(rho * w), e2


def refine_pose(
    T0: jnp.ndarray,
    X: jnp.ndarray,
    uv: jnp.ndarray,
    k: jnp.ndarray,
    weights: jnp.ndarray,
    n_iters: int = POSE_BA_ITER,
    n_rounds: int = POSE_BA_ROUNDS,
    chi2_gate: float = CHI2_GATE,
    tau: float = 1e-5,
    min_points: int = 3,
    solver: str = "lm",
) -> PoseBAResult:
    """Motion-only BA of a single pose.

    Args:
      T0: (3, 4) initial world->camera pose (e.g. from PnP).
      X: (N, 3) fixed map points; uv: (N, 2) observations; k: (4,) intrinsics.
      weights: (N,) >= 0 — 0 masks an edge out (fixed capacity + mask).
      n_iters: LM iterations per round (`POSE_BA_ITER`).
      n_rounds: outlier re-classification rounds.
      chi2_gate: inlier gate between rounds (`CHI2_THRESH`).
      min_points: below this many active edges the input pose is returned
        unchanged (the reference's early return, `src/Util.cpp:300-303`).
      solver: "lm" (g2o's damped trust-region schedule — the accuracy
        reference) or "gn" (plain Gauss-Newton, min(n_iters, 3) fixed
        steps with one final monotonicity guard instead of a per-step
        chi2 accept pass). The tracker's per-frame polish sits close to
        the optimum already (LO-RANSAC seeds it), where GN converges in
        2-3 steps; dropping the per-iteration accept/reject halves the
        linearization count and cuts the sequential tiny-kernel chain
        that dominated the fused step's latency.

    Fully jittable; vmap over a leading batch dim of (T0, X, uv, weights)
    to solve many frames at once.
    """
    dtype = T0.dtype
    valid = weights > 0

    def gn_round(T_in, w):
        def body(j, T):
            H, b, _, _ = _linearize(T, X, k, uv, w)
            Hd = H + tau * jnp.eye(6, dtype=dtype)
            dx = jnp.linalg.solve(Hd, b)
            dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
            return se3.compose(se3.exp(dx), T)

        T_new = jax.lax.fori_loop(0, min(n_iters, 3), body, T_in)
        # one monotonicity guard for the whole round (GN can overshoot on
        # degenerate geometry; LM's per-step accept is overkill here)
        chi2_0, _ = _chi2_only(T_in, X, k, uv, w)
        chi2_n, _ = _chi2_only(T_new, X, k, uv, w)
        ok = jnp.isfinite(chi2_n) & (chi2_n <= chi2_0)
        return jnp.where(ok, T_new, T_in), jnp.where(ok, chi2_n, chi2_0)

    def lm_round(T_in, w):
        H0, b0, chi2_0, _ = _linearize(T_in, X, k, uv, w)
        lam0 = lm.init_lambda(jnp.diagonal(H0), tau)

        def body(carry):
            T, st = carry
            H, b, chi2_cur, _ = _linearize(T, X, k, uv, w)
            Hd = H + st.lam * jnp.eye(6, dtype=dtype)
            dx = jnp.linalg.solve(Hd, b)
            T_new = se3.compose(se3.exp(dx), T)
            chi2_new, _ = _chi2_only(T_new, X, k, uv, w)
            rho = lm.gain_ratio(chi2_cur, chi2_new, dx, b, st.lam)
            accept = (chi2_new < chi2_cur) & jnp.isfinite(chi2_new)
            lam_new, nu_new = lm.lm_step_accept(st.lam, st.nu, rho, accept)
            T_next = jnp.where(accept, T_new, T)
            chi2_next = jnp.where(accept, chi2_new, chi2_cur)
            # Terminate when the improvement stalls (g2o's extra stop rule,
            # `optimization_algorithm_levenberg.cpp:154-161`).
            done = st.done | (accept & (chi2_cur - chi2_new < 1e-9 * chi2_cur))
            return T_next, lm.LMState(lam_new, nu_new, chi2_next, st.it + 1, done)

        def cond(carry):
            _, st = carry
            return (st.it < n_iters) & ~st.done

        st0 = lm.LMState(
            lam0,
            jnp.asarray(2.0, dtype),
            chi2_0,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
        )
        T_out, st = jax.lax.while_loop(cond, body, (T_in, st0))
        return T_out, st.chi2

    # Outlier re-classification rounds: re-seed from the running estimate,
    # gate edges by chi2 (the loop the reference designed at
    # `src/Util.cpp:314-341` but short-circuited).
    step_round = gn_round if solver == "gn" else lm_round

    def round_body(i, carry):
        T, w = carry
        T_new, _ = step_round(T, w)
        _, e2 = _chi2_only(T_new, X, k, uv, jnp.ones_like(weights))
        w_new = jnp.where(valid & (e2 <= chi2_gate), weights, 0.0)
        # Keep at least min_points edges: if gating starved the system,
        # fall back to the pre-gate weights.
        enough = jnp.sum(w_new > 0) >= min_points
        w_new = jnp.where(enough, w_new, w)
        return T_new, w_new

    n_active = jnp.sum(valid)
    T_fin, w_fin = jax.lax.fori_loop(0, n_rounds, round_body, (T0, weights))
    # Not enough correspondences: return the input unchanged.
    T_fin = jnp.where(n_active >= min_points, T_fin, T0)

    chi2_fin, e2_fin = _chi2_only(T_fin, X, k, uv, w_fin)
    inl = valid & (e2_fin <= chi2_gate)
    return PoseBAResult(T_fin, inl, chi2_fin, jnp.sum(inl))


refine_poses_batched = jax.vmap(refine_pose, in_axes=(0, 0, 0, None, 0))
"""Batched motion-only BA: refine F poses at once (T0 (F,3,4), X (F,N,3),
uv (F,N,2), k (4,), weights (F,N))."""
