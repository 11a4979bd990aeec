"""Full bundle adjustment with a dense-blocked Schur complement.

Batched replacement for `Util::BundleAdjustment` (`src/Util.cpp:34-220`) on
g2o's `BlockSolver_6_3` (`core/block_solver.hpp:353-479`) and LM driver
(`core/optimization_algorithm_levenberg.cpp:61-164`):

  reference (sequential, sparse-CCS)          here (batched, matmul-shaped)
  ------------------------------------------  --------------------------------
  per-edge linearizeOplus + JtWJ scatter      one batched analytic linearize
                                              over the edge array + segment_sum
  per-landmark Schur elimination loop         dense Hpl scatter + ONE matmul
  (block_solver.hpp:373-439, OpenMP)          [F*6, P*3] @ [P*3, F*6]
  sparse Cholesky on Hschur                   dense Cholesky (cho_solve)
  LM accept/reject loop                       lax.while_loop, same schedule

The graph is fixed-capacity and mask-padded: E edge slots with a `valid`
mask, F pose slots, P landmark slots. Landmarks with no valid edges get
lambda-floored diagonal blocks and zero updates. Fixed poses (gauge) are
pinned by identity rows in the reduced system — the reference fixes frame 0
(`src/Util.cpp:69-77`).

This dense-S path targets windowed local BA and small/medium global BA
(F up to a few hundred). The sharded, matrix-free CG path for huge maps
lives in `monocular_slam_tpu/parallel/sharded_ba.py` and reuses the
linearization here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monocular_slam_tpu.geometry import se3
from monocular_slam_tpu.optim import lm, residuals, robust
from monocular_slam_tpu.utils.linalg import inv3x3
from monocular_slam_tpu.utils.precision import einsum_hp as _einsum, matmul_hp as _mm

# Reference hyperparameters (`src/ParamConfig.h:7-8,17-18`)
THRESH_HUBER_FULL_BA = 5.99**0.5
FULL_BA_ITER = 15


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment graph (the reference builds the same
    graph from DataManager in `src/Util.cpp:62-176`)."""

    poses: jnp.ndarray  # (F, 3, 4) world->camera
    points: jnp.ndarray  # (P, 3)
    k: jnp.ndarray  # (F, 4) per-frame intrinsics (fx, fy, cx, cy)
    cam_idx: jnp.ndarray  # (E,) int32
    pt_idx: jnp.ndarray  # (E,) int32
    uv: jnp.ndarray  # (E, 2) observations
    info: jnp.ndarray  # (E,) information weight — reference uses 1/scale
    valid: jnp.ndarray  # (E,) bool
    fixed: jnp.ndarray  # (F,) bool — gauge-fixed poses


class BAResult(NamedTuple):
    poses: jnp.ndarray
    points: jnp.ndarray
    chi2_initial: jnp.ndarray  # robust chi2 of the input state
    chi2_history: jnp.ndarray  # (n_iters,) accepted robust chi2 per iteration
    lambda_history: jnp.ndarray  # (n_iters,)
    accepted: jnp.ndarray  # (n_iters,) bool
    n_iters_run: jnp.ndarray


def _edge_weights(prob: BAProblem, r: jnp.ndarray, delta: float):
    """Robust IRLS weight per edge: info * huber'(chi2)."""
    e2 = jnp.sum(r * r, axis=-1) * prob.info
    rho, w_rob = robust.huber(e2, delta)
    w = jnp.where(prob.valid, prob.info * w_rob, 0.0)
    chi2 = jnp.sum(jnp.where(prob.valid, rho, 0.0))
    return w, chi2


def _linearize_graph(prob: BAProblem, poses, points, delta: float):
    """Batched linearization of every edge + block normal equations."""
    F = poses.shape[0]
    P = points.shape[0]
    Tc = poses[prob.cam_idx]  # (E, 3, 4)
    Xp = points[prob.pt_idx]  # (E, 3)
    ke = prob.k[prob.cam_idx]  # (E, 4)
    r, Jp, Jl = residuals.linearize(Tc, Xp, ke, prob.uv)
    w, chi2 = _edge_weights(prob, r, delta)

    # Weighted block products per edge. The a=2 contraction is expanded to
    # broadcast-multiply-sum (see utils.precision.small_mm).
    def outer2(A, B):  # (E, 2, m), (E, 2, n) -> (E, m, n) weighted by w
        Aw = A * w[:, None, None]
        return jnp.sum(Aw[..., :, None] * B[..., None, :], axis=-3)

    Hpp_e = outer2(Jp, Jp)  # (E, 6, 6)
    Hll_e = outer2(Jl, Jl)  # (E, 3, 3)
    W_e = outer2(Jp, Jl)  # (E, 6, 3)  pose-landmark
    bp_e = -jnp.sum(Jp * (r * w[:, None])[..., None], axis=-2)  # (E, 6)
    bl_e = -jnp.sum(Jl * (r * w[:, None])[..., None], axis=-2)  # (E, 3)

    seg_f = lambda x: jax.ops.segment_sum(x, prob.cam_idx, num_segments=F)
    seg_p = lambda x: jax.ops.segment_sum(x, prob.pt_idx, num_segments=P)
    return dict(
        chi2=chi2,
        Hpp=seg_f(Hpp_e),  # (F, 6, 6)
        Hll=seg_p(Hll_e),  # (P, 3, 3)
        bp=seg_f(bp_e),  # (F, 6)
        bl=seg_p(bl_e),  # (P, 3)
        W_e=W_e,
    )


def _chi2_graph(prob: BAProblem, poses, points, delta: float):
    Tc = poses[prob.cam_idx]
    Xp = points[prob.pt_idx]
    ke = prob.k[prob.cam_idx]
    r = residuals.residual(Tc, Xp, ke, prob.uv)
    _, chi2 = _edge_weights(prob, r, delta)
    return chi2


def _schur_solve(prob: BAProblem, lin, lam):
    """Damped Schur-reduced solve. Returns (dxp (F,6), dxl (P,3), b_full)."""
    F = lin["Hpp"].shape[0]
    P = lin["Hll"].shape[0]
    dtype = lin["Hpp"].dtype
    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)

    Hpp_d = lin["Hpp"] + lam * eye6  # (F, 6, 6)
    Hll_d = lin["Hll"] + lam * eye3  # (P, 3, 3) — lambda floor keeps
    # zero-observation landmark blocks invertible; their bl is 0 so dxl = 0.
    Hll_inv = inv3x3(Hll_d)  # batched closed-form 3x3 inverse

    # Y_e = W_e Hll^{-1}[pt(e)] — g2o's per-landmark elimination
    # (`block_solver.hpp:381-432`) becomes a batched 6x3 @ 3x3 (expanded).
    from monocular_slam_tpu.utils.precision import small_mm, small_mv

    Y_e = small_mm(lin["W_e"], Hll_inv[prob.pt_idx])  # (E, 6, 3)

    def scatter_fp(blocks):  # (E, 6, 3) -> (F, 6, P, 3)
        out = jnp.zeros((F, 6, P, 3), dtype=dtype)
        return out.at[prob.cam_idx, :, prob.pt_idx, :].add(blocks)

    U = scatter_fp(lin["W_e"]).reshape(F * 6, P * 3)
    Y = scatter_fp(Y_e).reshape(F * 6, P * 3)
    # b_red = bp - sum_l Y_il bl_l (edge-wise segment sum)
    yb_e = small_mv(Y_e, lin["bl"][prob.pt_idx])  # (E, 6)
    b_red = lin["bp"] - jax.ops.segment_sum(yb_e, prob.cam_idx, num_segments=F)

    # ONE matmul for the Schur cross terms: S -= Y U^T.
    S = jnp.zeros((F, 6, F, 6), dtype=dtype)
    S = S.at[jnp.arange(F), :, jnp.arange(F), :].set(Hpp_d)
    S = S.reshape(F * 6, F * 6) - _mm(Y, U.T)

    # Gauge fixing: identity rows/cols for fixed poses (frame 0 in the
    # reference, `src/Util.cpp:69-77`).
    free = ~prob.fixed  # (F,)
    free6 = jnp.repeat(free, 6)  # (F*6,)
    mask2d = free6[:, None] & free6[None, :]
    S = jnp.where(mask2d, S, 0.0)
    S = S + jnp.diag(jnp.where(free6, 0.0, 1.0))
    b_red = jnp.where(free[:, None], b_red, 0.0).reshape(F * 6)

    dxp = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S, lower=True), b_red
    ).reshape(F, 6)

    # Back-substitution: dxl = Hll^{-1} (bl - W^T dxp) (`block_solver.hpp:459-479`)
    wt_dxp_e = jnp.sum(lin["W_e"] * dxp[prob.cam_idx][..., None], axis=-2)  # (E, 3)
    rhs_l = lin["bl"] - jax.ops.segment_sum(wt_dxp_e, prob.pt_idx, num_segments=P)
    dxl = small_mv(Hll_inv, rhs_l)
    return dxp, dxl, b_red.reshape(F, 6)


def bundle_adjust(
    prob,
    n_iters: int = FULL_BA_ITER,
    delta: float = THRESH_HUBER_FULL_BA,
    tau: float = 1e-5,
    solve_fn=None,
    linearize_fn=None,
) -> BAResult:
    """Run damped LM bundle adjustment. Fully jittable; fixed trip count with
    early-stall freeze (g2o terminates when chi2 improves < 1e-3 relative for
    consecutive iterations, `optimization_algorithm_levenberg.cpp:154-161`).

    solve_fn(prob, lin, lam) -> (dxp, dxl, b_red) computes the damped Schur
    step; defaults to the dense-S Cholesky (`_schur_solve`). The matrix-free
    PCG solver in `optim/cg_ba.py` plugs in here for large graphs; the
    scatter-free observation-grid layout in `optim/window_ba.py` plugs in its
    own linearize/solve pair (same `lin` dict contract: chi2, Hpp, Hll,
    bp, bl, W_e).

    The loop carries the current linearization: each iteration solves from
    the carried `lin`, linearizes at the CANDIDATE state (whose chi2 is a
    byproduct), and keeps the candidate linearization iff the step is
    accepted. One linearize per iteration, no separate chi2 pass — vs g2o's
    computeActiveErrors + buildSystem per trial
    (`sparse_optimizer.cpp:354-419`)."""
    dtype = prob.poses.dtype
    if solve_fn is None:
        solve_fn = _schur_solve
    if linearize_fn is None:
        linearize_fn = _linearize_graph

    lin0 = linearize_fn(prob, prob.poses, prob.points, delta)
    diag0 = jnp.concatenate(
        [
            jnp.diagonal(lin0["Hpp"], axis1=-2, axis2=-1).reshape(-1),
            jnp.diagonal(lin0["Hll"], axis1=-2, axis2=-1).reshape(-1),
        ]
    )
    lam0 = lm.init_lambda(diag0, tau)

    def body(carry, _):
        poses, points, lin, st = carry

        def step(operand):
            poses, points, lin, st = operand
            dxp, dxl, _ = solve_fn(prob, lin, st.lam)
            poses_new = se3.compose(se3.exp(dxp), poses)
            points_new = points + dxl
            lin_new = linearize_fn(prob, poses_new, points_new, delta)
            chi2_new = lin_new["chi2"]
            dx_all = jnp.concatenate([dxp.reshape(-1), dxl.reshape(-1)])
            b_all = jnp.concatenate([lin["bp"].reshape(-1), lin["bl"].reshape(-1)])
            rho = lm.gain_ratio(lin["chi2"], chi2_new, dx_all, b_all, st.lam)
            accept = (chi2_new < lin["chi2"]) & jnp.isfinite(chi2_new)
            lam_new, nu_new = lm.lm_step_accept(st.lam, st.nu, rho, accept)
            poses_out = jnp.where(accept, poses_new, poses)
            points_out = jnp.where(accept, points_new, points)
            lin_out = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), lin_new, lin
            )
            chi2_out = jnp.where(accept, chi2_new, lin["chi2"])
            stall = accept & (lin["chi2"] - chi2_new < 1e-6 * lin["chi2"])
            st_new = lm.LMState(lam_new, nu_new, chi2_out, st.it + 1, st.done | stall)
            return (poses_out, points_out, lin_out, st_new), accept

        def frozen(operand):
            poses, points, lin, st = operand
            return (poses, points, lin, st._replace(it=st.it + 1)), jnp.asarray(False)

        (poses, points, lin, st), accept = jax.lax.cond(
            st.done, frozen, step, (poses, points, lin, st)
        )
        return (poses, points, lin, st), (st.chi2, st.lam, accept)

    st0 = lm.LMState(
        lam0, jnp.asarray(2.0, dtype), lin0["chi2"], jnp.asarray(0, jnp.int32), jnp.asarray(False)
    )
    (poses, points, _, st), (chi2_h, lam_h, acc_h) = jax.lax.scan(
        body, (prob.poses, prob.points, lin0, st0), None, length=n_iters
    )
    return BAResult(poses, points, lin0["chi2"], chi2_h, lam_h, acc_h, st.it)


def global_bundle_adjust(prob: BAProblem, n_iters: int = FULL_BA_ITER) -> BAResult:
    """All-frames/all-points wrapper — the reference's `GlobalBundleAdjustemnt`
    [sic] (`src/Util.h:24`, `src/Util.cpp:28-32`; typo not replicated)."""
    return bundle_adjust(prob, n_iters=n_iters)


def _hessian_vecprod(prob: BAProblem, lin, xp, xl):
    """(H x) from the block linearization, never materializing H:
    (Hx)_p = Hpp x_p + sum_e W_e x_l(e); (Hx)_l = Hll x_l + sum_e W_e^T x_p."""
    F = lin["Hpp"].shape[0]
    P = lin["Hll"].shape[0]
    from monocular_slam_tpu.utils.precision import small_mv

    hp = small_mv(lin["Hpp"], xp)  # (F, 6)
    hl = small_mv(lin["Hll"], xl)  # (P, 3)
    wx_e = small_mv(lin["W_e"], xl[prob.pt_idx])  # (E, 6)
    hp = hp + jax.ops.segment_sum(wx_e, prob.cam_idx, num_segments=F)
    wtx_e = jnp.sum(lin["W_e"] * xp[prob.cam_idx][..., None], axis=-2)  # (E, 3)
    hl = hl + jax.ops.segment_sum(wtx_e, prob.pt_idx, num_segments=P)
    return hp, hl


def bundle_adjust_gn(
    prob: BAProblem,
    n_iters: int = FULL_BA_ITER,
    delta: float = THRESH_HUBER_FULL_BA,
    solve_fn=None,
    linearize_fn=None,
) -> BAResult:
    """Gauss-Newton bundle adjustment — g2o's
    `OptimizationAlgorithmGaussNewton` (`core/optimization_algorithm_gauss_
    newton.cpp`): the undamped normal-equations step applied unconditionally
    each iteration (no trust region; diverges on poorly initialized graphs,
    converges quadratically near the optimum). A vanishing damping floor
    (1e-12 x max diag) keeps padding landmark blocks factorizable — their
    rhs is zero, so their update stays exactly zero."""
    dtype = prob.poses.dtype
    if solve_fn is None:
        solve_fn = _schur_solve
    if linearize_fn is None:
        linearize_fn = _linearize_graph

    lin0 = linearize_fn(prob, prob.poses, prob.points, delta)
    diag0 = jnp.concatenate(
        [
            jnp.diagonal(lin0["Hpp"], axis1=-2, axis2=-1).reshape(-1),
            jnp.diagonal(lin0["Hll"], axis1=-2, axis2=-1).reshape(-1),
        ]
    )
    lam_floor = 1e-12 * jnp.maximum(jnp.max(diag0), 1.0)

    def body(carry, _):
        poses, points, lin, st = carry

        def step(operand):
            poses, points, lin, st = operand
            dxp, dxl, _ = solve_fn(prob, lin, lam_floor)
            poses_new = se3.compose(se3.exp(dxp), poses)
            points_new = points + dxl
            lin_new = linearize_fn(prob, poses_new, points_new, delta)
            chi2_new = lin_new["chi2"]
            # GN applies the step unconditionally; a non-finite candidate
            # freezes the run (g2o aborts on solver failure)
            ok = jnp.isfinite(chi2_new)
            poses_out = jnp.where(ok, poses_new, poses)
            points_out = jnp.where(ok, points_new, points)
            lin_out = jax.tree_util.tree_map(
                lambda a, b: jnp.where(ok, a, b), lin_new, lin
            )
            chi2_out = jnp.where(ok, chi2_new, lin["chi2"])
            stall = (~ok) | (
                jnp.abs(lin["chi2"] - chi2_out) < 1e-9 * (lin["chi2"] + 1e-30)
            )
            st_new = lm.LMState(
                st.lam, st.nu, chi2_out, st.it + 1, st.done | stall
            )
            return (poses_out, points_out, lin_out, st_new), ok

        def frozen(operand):
            poses, points, lin, st = operand
            return (
                poses, points, lin, st._replace(it=st.it + 1)
            ), jnp.asarray(False)

        (poses, points, lin, st), accept = jax.lax.cond(
            st.done, frozen, step, (poses, points, lin, st)
        )
        return (poses, points, lin, st), (st.chi2, st.lam, accept)

    st0 = lm.LMState(
        jnp.asarray(0.0, dtype), jnp.asarray(2.0, dtype), lin0["chi2"],
        jnp.asarray(0, jnp.int32), jnp.asarray(False),
    )
    (poses, points, _, st), (chi2_h, lam_h, acc_h) = jax.lax.scan(
        body, (prob.poses, prob.points, lin0, st0), None, length=n_iters
    )
    return BAResult(poses, points, lin0["chi2"], chi2_h, lam_h, acc_h, st.it)


def bundle_adjust_dogleg(
    prob: BAProblem,
    n_iters: int = FULL_BA_ITER,
    delta: float = THRESH_HUBER_FULL_BA,
    radius0: float = 1.0,
    solve_fn=None,
    linearize_fn=None,
) -> BAResult:
    """Powell dogleg bundle adjustment — g2o's `OptimizationAlgorithmDogleg`
    (`core/optimization_algorithm_dogleg.cpp:1-229`): blend the Cauchy
    (steepest-descent) point and the Gauss-Newton step inside a trust region
    of radius Delta, growing Delta on good gain ratios and shrinking it on
    bad ones (the same update rule as g2o: rho > 0.75 -> Delta = max(Delta,
    3|h|), rho < 0.25 -> Delta /= 2). The lambda slot of the history records
    Delta."""
    dtype = prob.poses.dtype
    if solve_fn is None:
        solve_fn = _schur_solve
    if linearize_fn is None:
        linearize_fn = _linearize_graph

    lin0 = linearize_fn(prob, prob.poses, prob.points, delta)
    diag0 = jnp.concatenate(
        [
            jnp.diagonal(lin0["Hpp"], axis1=-2, axis2=-1).reshape(-1),
            jnp.diagonal(lin0["Hll"], axis1=-2, axis2=-1).reshape(-1),
        ]
    )
    lam_floor = 1e-12 * jnp.maximum(jnp.max(diag0), 1.0)

    def body(carry, _):
        poses, points, lin, st = carry
        radius = st.lam  # trust-region radius rides the lambda slot

        def step(operand):
            poses, points, lin, st = operand
            radius = st.lam
            # Gauss-Newton step
            gp, gl, _ = solve_fn(prob, lin, lam_floor)
            # Cauchy point: alpha = |b|^2 / (b^T H b), h_sd = alpha b
            bp, bl = lin["bp"], lin["bl"]
            hb_p, hb_l = _hessian_vecprod(prob, lin, bp, bl)
            b2 = jnp.sum(bp * bp) + jnp.sum(bl * bl)
            bHb = jnp.sum(bp * hb_p) + jnp.sum(bl * hb_l) + 1e-30
            alpha = b2 / bHb
            sp, sl = alpha * bp, alpha * bl

            norm = lambda xp, xl: jnp.sqrt(
                jnp.sum(xp * xp) + jnp.sum(xl * xl)
            )
            n_gn = norm(gp, gl)
            n_sd = norm(sp, sl)

            # dogleg blend (`optimization_algorithm_dogleg.cpp` hdl cases)
            dp_gn_ok, dl_gn_ok = gp, gl  # case 1: GN inside the region
            scale_sd = radius / jnp.maximum(n_sd, 1e-30)
            dp_sd, dl_sd = scale_sd * sp, scale_sd * sl  # case 2
            # case 3: h = h_sd + beta (h_gn - h_sd), |h| = radius
            ap, al = gp - sp, gl - sl
            a2 = jnp.sum(ap * ap) + jnp.sum(al * al) + 1e-30
            c = jnp.sum(sp * ap) + jnp.sum(sl * al)
            disc = jnp.sqrt(
                jnp.maximum(c * c + a2 * (radius**2 - n_sd**2), 0.0)
            )
            beta = jnp.where(
                c <= 0, (-c + disc) / a2, (radius**2 - n_sd**2) / (c + disc)
            )
            dp_bl, dl_bl = sp + beta * ap, sl + beta * al

            use_gn = n_gn <= radius
            use_sd = (~use_gn) & (n_sd >= radius)
            dxp = jnp.where(
                use_gn, dp_gn_ok, jnp.where(use_sd, dp_sd, dp_bl)
            )
            dxl = jnp.where(
                use_gn, dl_gn_ok, jnp.where(use_sd, dl_sd, dl_bl)
            )

            poses_new = se3.compose(se3.exp(dxp), poses)
            points_new = points + dxl
            lin_new = linearize_fn(prob, poses_new, points_new, delta)
            chi2_new = lin_new["chi2"]
            # gain ratio with the quadratic-model denominator
            hd_p, hd_l = _hessian_vecprod(prob, lin, dxp, dxl)
            pred = (
                jnp.sum(dxp * bp) + jnp.sum(dxl * bl)
                - 0.5 * (jnp.sum(dxp * hd_p) + jnp.sum(dxl * hd_l))
            )
            rho = (lin["chi2"] - chi2_new) / (pred + 1e-30)
            accept = (chi2_new < lin["chi2"]) & jnp.isfinite(chi2_new)
            h_norm = norm(dxp, dxl)
            radius_new = jnp.where(
                rho > 0.75, jnp.maximum(radius, 3.0 * h_norm), radius
            )
            radius_new = jnp.where(rho < 0.25, radius_new * 0.5, radius_new)

            poses_out = jnp.where(accept, poses_new, poses)
            points_out = jnp.where(accept, points_new, points)
            lin_out = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), lin_new, lin
            )
            chi2_out = jnp.where(accept, chi2_new, lin["chi2"])
            stall = (
                accept & (lin["chi2"] - chi2_new < 1e-9 * lin["chi2"])
            ) | (radius_new < 1e-12)
            st_new = lm.LMState(
                radius_new, st.nu, chi2_out, st.it + 1, st.done | stall
            )
            return (poses_out, points_out, lin_out, st_new), accept

        def frozen(operand):
            poses, points, lin, st = operand
            return (
                poses, points, lin, st._replace(it=st.it + 1)
            ), jnp.asarray(False)

        (poses, points, lin, st), accept = jax.lax.cond(
            st.done, frozen, step, (poses, points, lin, st)
        )
        return (poses, points, lin, st), (st.chi2, st.lam, accept)

    st0 = lm.LMState(
        jnp.asarray(radius0, dtype), jnp.asarray(2.0, dtype), lin0["chi2"],
        jnp.asarray(0, jnp.int32), jnp.asarray(False),
    )
    (poses, points, _, st), (chi2_h, rad_h, acc_h) = jax.lax.scan(
        body, (prob.poses, prob.points, lin0, st0), None, length=n_iters
    )
    return BAResult(poses, points, lin0["chi2"], chi2_h, rad_h, acc_h, st.it)


ALGORITHMS = {
    "lm": bundle_adjust,
    "gn": bundle_adjust_gn,
    "dogleg": bundle_adjust_dogleg,
}


def bundle_adjust_with(algorithm: str, prob: BAProblem, **kw) -> BAResult:
    """Algorithm-selectable entry — the role of g2o's
    `OptimizationAlgorithmFactory` ("lm" / "gn" / "dogleg"); the reference's
    `src/` only ever instantiates LM (`src/Util.cpp:43-52`)."""
    return ALGORITHMS[algorithm](prob, **kw)
