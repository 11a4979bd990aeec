"""Gather/scatter-free bundle adjustment in a landmark-major (P, F) layout.

Every BA problem in this system derives its edges from the per-frame feature
table `feat_point` (F, N): each edge IS a (frame, feature) cell and each
(frame, landmark) pair has at most one edge. So the whole window graph fits a
dense (P, F) observation grid: cell (p, f) is frame f's (unique) observation
of landmark p, or masked.

`build` converts the (F, N) feature tables into that grid with ONE scatter +
ONE gather. After that the 10-iteration LM hot loop touches no gather and no
scatter at all:

  residual/Jacobian per cell     pure broadcasting over (P, F, ...)
  camera-side reduction (Hpp,bp) einsum reduce over the P axis
  landmark-side reduction (Hll,  einsum reduce over the F axis
  bl) — g2o's per-edge scatters
  (block_solver.hpp:373-439)
  Schur cross term               ONE (F*6, P*3) x (P*3, F*6) matmul

The edge-list engine (`optim/ba.py`) spends its time in dense (F,6,P,3)
scatter-adds, and an earlier gather-based variant of this module in
gathering (P, F) rows; this layout removes both.

The grid also deduplicates edges: if two features of one frame point at the
same landmark (possible after `mapping.fuse`), exactly one cell survives —
g2o would have double-counted identical information.

The LM trust-region loop, lambda schedule, and gauge handling are shared with
`optim/ba.py` (`bundle_adjust(..., linearize_fn, solve_fn)`), so the two
engines are numerically interchangeable (see tests/test_window_ba.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from monocular_slam_tpu.optim import ba as ba_mod
from monocular_slam_tpu.optim import residuals, robust
from monocular_slam_tpu.utils.linalg import inv3x3
from monocular_slam_tpu.utils.precision import einsum_hp as _einsum


class WindowBAProblem(NamedTuple):
    """Structured BA graph in both layouts: the (F, N) feature-table view
    (kept for write-back/debugging) and the dense (P, F) observation grid the
    solver runs on. Same graph the reference builds by iterating MapPoint
    observation maps (`src/Util.cpp:87-169`)."""

    poses: jnp.ndarray  # (F, 3, 4) world->camera
    points: jnp.ndarray  # (P, 3)
    k: jnp.ndarray  # (F, 4)
    pt_slot: jnp.ndarray  # (F, N) int32 landmark slot (post-dedup)
    uv: jnp.ndarray  # (F, N, 2)
    info: jnp.ndarray  # (F, N)
    valid: jnp.ndarray  # (F, N) bool (post-dedup)
    fixed: jnp.ndarray  # (F,) bool
    obs_table: jnp.ndarray  # (P, F) int32 flat edge id f*N+n, or -1
    uv_pf: jnp.ndarray  # (P, F, 2) observation grid
    info_pf: jnp.ndarray  # (P, F)
    valid_pf: jnp.ndarray  # (P, F) bool


def build(poses, points, k, pt_slot, uv, info, valid, fixed) -> WindowBAProblem:
    """Assemble the observation grid: one scatter (the table) + one gather
    (uv/info into (P, F) layout). LM iterations touch neither."""
    F, N = pt_slot.shape
    P = points.shape[0]
    flat = jnp.arange(F * N, dtype=jnp.int32)
    cam_of = jnp.repeat(jnp.arange(F, dtype=jnp.int32), N)
    slot = jnp.where(valid.reshape(-1), pt_slot.reshape(-1), P)
    table = (
        jnp.full((P + 1, F), -1, jnp.int32)
        .at[slot, cam_of]
        .set(flat, mode="drop")[:P]
    )
    # Dedup: an edge survives iff the table points back at it (two features
    # of one frame on the same landmark -> one edge, arbitrary winner).
    slot_safe = jnp.minimum(slot, P - 1)
    valid = valid & (table[slot_safe, cam_of] == flat).reshape(F, N) & (slot < P).reshape(F, N)
    pt_slot = jnp.where(valid, pt_slot, 0).astype(jnp.int32)

    # (P, F) grid: the one gather, at build time
    eid = jnp.maximum(table, 0)  # (P, F)
    valid_pf = table >= 0
    uv_pf = jnp.where(valid_pf[..., None], uv.reshape(F * N, 2)[eid], 0.0)
    info_pf = jnp.where(valid_pf, info.reshape(F * N)[eid], 0.0)
    return WindowBAProblem(
        poses, points, k, pt_slot, uv, info, valid, fixed,
        table, uv_pf, info_pf, valid_pf,
    )


def _linearize(prob: WindowBAProblem, poses, points, delta: float):
    """Batched linearization over the (P, F) grid -> the `lin` dict contract
    of `optim/ba.py` (chi2, Hpp, Hll, bp, bl, W_e). Pure broadcasting +
    einsum reductions; W_e comes out landmark-major (P, F, 6, 3)."""
    r, Jp, Jl = residuals.linearize(
        poses[None], points[:, None], prob.k[None], prob.uv_pf
    )  # (P, F, 2), (P, F, 2, 6), (P, F, 2, 3)
    # Mask at source: invalid cells can sit at z ~ 0 and overflow f32 in the
    # quadratic products below (0 * inf = NaN would poison the reductions).
    m2 = prob.valid_pf[..., None]
    r = jnp.where(m2, r, 0.0)
    Jp = jnp.where(m2[..., None], Jp, 0.0)
    Jl = jnp.where(m2[..., None], Jl, 0.0)
    e2 = jnp.sum(r * r, axis=-1) * prob.info_pf
    rho, w_rob = robust.huber(e2, delta)
    w = jnp.where(prob.valid_pf, prob.info_pf * w_rob, 0.0)
    chi2 = jnp.sum(jnp.where(prob.valid_pf, rho, 0.0))

    # Contraction-length rule: long contractions (over the P axis) stay
    # einsums (true matmuls); short ones (a=2, j=3) are expanded to
    # broadcast-multiply-sum (see utils.precision.small_mm).
    wJp = Jp * w[..., None, None]  # (P, F, 2, 6)
    Hpp = _einsum("pfai,pfaj->fij", wJp, Jp)  # contract (p, a): matmul
    bp = -_einsum("pfai,pfa->fi", wJp, r)
    wJl = Jl * w[..., None, None]  # (P, F, 2, 3)
    # landmark-side: expand the a=2 axis, reduce over f (elementwise + sum)
    Hll = jnp.sum(wJl[..., :, None] * Jl[..., None, :], axis=(1, 2))  # (P, 3, 3)
    bl = -jnp.sum(wJl * r[..., None], axis=(1, 2))  # (P, 3)
    W_pf = (
        wJp[..., 0, :, None] * Jl[..., 0, None, :]
        + wJp[..., 1, :, None] * Jl[..., 1, None, :]
    )  # (P, F, 6, 3)
    return dict(chi2=chi2, Hpp=Hpp, Hll=Hll, bp=bp, bl=bl, W_e=W_pf)


def _chi2(prob: WindowBAProblem, poses, points, delta: float):
    r = residuals.residual(poses[None], points[:, None], prob.k[None], prob.uv_pf)
    r = jnp.where(prob.valid_pf[..., None], r, 0.0)
    e2 = jnp.sum(r * r, axis=-1) * prob.info_pf
    rho, _ = robust.huber(e2, delta)
    return jnp.sum(jnp.where(prob.valid_pf, rho, 0.0))


def _schur_solve(prob: WindowBAProblem, lin, lam):
    """Dense Schur-reduced solve on the observation grid. Same algebra as
    `optim/ba.py:_schur_solve` (g2o `block_solver.hpp:373-479`) with zero
    gathers/scatters: the cross-term operand IS lin["W_e"]."""
    F = prob.poses.shape[0]
    P = lin["Hll"].shape[0]
    dtype = lin["Hpp"].dtype
    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)

    Hpp_d = lin["Hpp"] + lam * eye6
    Hll_d = lin["Hll"] + lam * eye3
    Hll_inv = inv3x3(Hll_d)  # (P, 3, 3)

    from monocular_slam_tpu.utils.precision import small_mm, small_mv

    U_pf = lin["W_e"]  # (P, F, 6, 3)
    Y_pf = small_mm(U_pf, Hll_inv[:, None])  # (P, F, 6, 3), j=3 expanded

    # b_red = bp - sum_p Y_pf bl_p
    b_red = lin["bp"] - _einsum("pfij,pj->fi", Y_pf, lin["bl"])

    # Schur cross term as ONE matmul over the (P*3) inner axis.
    U = jnp.transpose(U_pf, (1, 2, 0, 3)).reshape(F * 6, P * 3)
    Y = jnp.transpose(Y_pf, (1, 2, 0, 3)).reshape(F * 6, P * 3)
    S = jnp.zeros((F, 6, F, 6), dtype=dtype)
    S = S.at[jnp.arange(F), :, jnp.arange(F), :].set(Hpp_d)
    S = S.reshape(F * 6, F * 6) - _einsum("ip,jp->ij", Y, U)

    # gauge pinning: identity rows/cols for fixed poses (`src/Util.cpp:69-77`)
    free = ~prob.fixed
    free6 = jnp.repeat(free, 6)
    mask2d = free6[:, None] & free6[None, :]
    S = jnp.where(mask2d, S, 0.0) + jnp.diag(jnp.where(free6, 0.0, 1.0))
    b_red = jnp.where(free[:, None], b_red, 0.0).reshape(F * 6)

    import jax.scipy.linalg as jsl

    dxp = jsl.cho_solve(jsl.cho_factor(S, lower=True), b_red).reshape(F, 6)

    # back-substitution: dxl = Hll^{-1}(bl - W^T dxp) (`block_solver.hpp:459-479`)
    wt_dxp = _einsum("pfij,fi->pj", U_pf, dxp)  # (P, 3), contract (f, i): matmul
    dxl = small_mv(Hll_inv, lin["bl"] - wt_dxp)
    return dxp, dxl, b_red.reshape(F, 6)


def bundle_adjust(
    prob: WindowBAProblem,
    n_iters: int = ba_mod.FULL_BA_ITER,
    delta: float = ba_mod.THRESH_HUBER_FULL_BA,
    tau: float = 1e-5,
) -> ba_mod.BAResult:
    """LM bundle adjustment on the observation-grid layout — identical
    schedule and results to `ba.bundle_adjust`, gather/scatter-free hot loop."""
    return ba_mod.bundle_adjust(
        prob,
        n_iters=n_iters,
        delta=delta,
        tau=tau,
        solve_fn=_schur_solve,
        linearize_fn=_linearize,
    )
