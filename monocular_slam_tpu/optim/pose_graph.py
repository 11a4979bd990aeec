"""Sim(3) pose-graph optimization (essential-graph optimization).

The loop-closure back-end the reference's UML diagram promises
(`Util::poseGraphOptimisation`, `LoopCloser::essentialGraphOptimisation` in
ORBSLAM.png) but whose code never existed; g2o ships the types
(`types/types_seven_dof_expmap.h:48-175`, BlockSolver_7_3) the reference
never calls.

Design: vertices are per-frame Sim3 (world->camera) as (F, 3, 5) packed
arrays; edges carry relative measurements S_meas_ij with residual

    e_ij = log( S_meas_ij o S_j o S_i^{-1} )   in sim(3), 7-dim

(zero when S_i o S_j^{-1} == S_meas_ij — the g2o EdgeSim3 convention).
Jacobians come from jax.jacfwd through our exact exp/log (7x7 per edge,
batched) — no hand-derived Sim3 adjoints to get wrong. The Hessian is dense
(7F x 7F): trajectory-scale graphs (hundreds of keyframes) stay tiny for a
dense Cholesky; huge graphs go through the sharded CG path later.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monocular_slam_tpu.geometry import sim3
from monocular_slam_tpu.optim import lm
from monocular_slam_tpu.utils.precision import einsum_hp as _einsum


class PoseGraph(NamedTuple):
    vertices: jnp.ndarray  # (F, 3, 5) Sim3 world->camera
    i_idx: jnp.ndarray  # (E,) int32 edge endpoints
    j_idx: jnp.ndarray  # (E,)
    meas: jnp.ndarray  # (E, 3, 5) measured S_ij = S_i o S_j^{-1}
    weight: jnp.ndarray  # (E,) information weight
    valid: jnp.ndarray  # (E,) bool
    fixed: jnp.ndarray  # (F,) bool
    # edges eligible for the robust kernel (odometry). Loop edges are
    # RANSAC-verified and START at a large residual by design (they encode
    # the drift the graph must remove) — Huber-crushing them neuters the
    # correction (measured: 1000-frame ATE 0.38 -> 1.80 m when the kernel
    # hit loop edges too).
    robust: jnp.ndarray = None  # (E,) bool; None = all edges robust


class PoseGraphResult(NamedTuple):
    vertices: jnp.ndarray
    chi2_initial: jnp.ndarray
    chi2_history: jnp.ndarray
    # LM iterations actually EXECUTED: the scan freezes into a no-op branch
    # once improvement stalls (g2o's extra stop rule), so wall-time must be
    # divided by this, not by the requested n_iters
    n_iters_run: jnp.ndarray = None


def edge_residual(S_i, S_j, S_meas):
    """e = log(S_meas o S_j o S_i^{-1}), (…, 7)."""
    return sim3.log(sim3.compose(S_meas, sim3.compose(S_j, sim3.inverse(S_i))))


def _residual_wrt_updates(xi_i, xi_j, S_i, S_j, S_meas):
    """Residual after left-multiplied tangent updates on both endpoints."""
    return edge_residual(
        sim3.compose(sim3.exp(xi_i), S_i),
        sim3.compose(sim3.exp(xi_j), S_j),
        S_meas,
    )


_jac_i = jax.vmap(jax.jacfwd(_residual_wrt_updates, argnums=0), in_axes=(None, None, 0, 0, 0))
_jac_j = jax.vmap(jax.jacfwd(_residual_wrt_updates, argnums=1), in_axes=(None, None, 0, 0, 0))
_res_batch = jax.vmap(edge_residual, in_axes=(0, 0, 0))


def _edge_weights(g: PoseGraph, r, huber_delta):
    """Per-edge effective weight + robust chi2. With `huber_delta`, edges
    whose weighted squared residual exceeds delta^2 are Huber-downweighted
    (IRLS) — g2o attaches RobustKernelHuber to graph edges for exactly this:
    ONE garbage vertex (e.g. a mis-relocalized keyframe) otherwise bakes a
    wild odometry measurement into the graph and LM smears its error over
    the whole trajectory (measured ~0.4 m of uniform ATE deformation on the
    1000-frame course from a single 10 m pose excursion)."""
    w = jnp.where(g.valid, g.weight, 0.0)
    e2 = jnp.sum(r * r, axis=-1) * w
    if huber_delta is None:
        return w, jnp.sum(e2)
    from monocular_slam_tpu.optim import robust

    rho, w_rob = robust.huber(e2, huber_delta)
    if g.robust is not None:
        w_rob = jnp.where(g.robust, w_rob, 1.0)
        rho = jnp.where(g.robust, rho, e2)
    return w * w_rob, jnp.sum(jnp.where(g.valid, rho, 0.0))


def _linearize(g: PoseGraph, verts, huber_delta=None):
    F = verts.shape[0]
    S_i = verts[g.i_idx]
    S_j = verts[g.j_idx]
    r = _res_batch(S_i, S_j, g.meas)  # (E, 7)
    z7 = jnp.zeros(7, dtype=verts.dtype)
    Ji = _jac_i(z7, z7, S_i, S_j, g.meas)  # (E, 7, 7)
    Jj = _jac_j(z7, z7, S_i, S_j, g.meas)
    w, chi2 = _edge_weights(g, r, huber_delta)

    # Dense H (F,7,F,7) and gradient b (F,7) by scatter-add of edge blocks.
    Hii = _einsum("eai,eaj,e->eij", Ji, Ji, w)
    Hjj = _einsum("eai,eaj,e->eij", Jj, Jj, w)
    Hij = _einsum("eai,eaj,e->eij", Ji, Jj, w)
    bi = -_einsum("eai,ea,e->ei", Ji, r, w)
    bj = -_einsum("eai,ea,e->ei", Jj, r, w)

    H = jnp.zeros((F, 7, F, 7), dtype=verts.dtype)
    H = H.at[g.i_idx, :, g.i_idx, :].add(Hii)
    H = H.at[g.j_idx, :, g.j_idx, :].add(Hjj)
    H = H.at[g.i_idx, :, g.j_idx, :].add(Hij)
    H = H.at[g.j_idx, :, g.i_idx, :].add(jnp.swapaxes(Hij, -1, -2))
    b = jnp.zeros((F, 7), dtype=verts.dtype)
    b = b.at[g.i_idx].add(bi)
    b = b.at[g.j_idx].add(bj)
    return H, b, chi2


def _chi2(g: PoseGraph, verts, huber_delta=None):
    r = _res_batch(verts[g.i_idx], verts[g.j_idx], g.meas)
    _, chi2 = _edge_weights(g, r, huber_delta)
    return chi2


def optimize(
    g: PoseGraph, n_iters: int = 20, tau: float = 1e-5, huber_delta=None
) -> PoseGraphResult:
    """Damped LM on the Sim3 pose graph; fixed vertices pinned by identity
    rows (the loop-closure fixpoint). `huber_delta` robustifies every edge
    (g2o RobustKernelHuber semantics, `robust_kernel_impl.h:76-85`)."""
    F = g.vertices.shape[0]
    dtype = g.vertices.dtype
    free7 = jnp.repeat(~g.fixed, 7)

    H0, b0, chi2_0 = _linearize(g, g.vertices, huber_delta)
    lam0 = lm.init_lambda(jnp.diagonal(H0.reshape(F * 7, F * 7)), tau)

    def body(carry, _):

        def step(op):
            verts, st = op
            H, b, chi2_cur = _linearize(g, verts, huber_delta)
            Hm = H.reshape(F * 7, F * 7) + st.lam * jnp.eye(F * 7, dtype=dtype)
            mask2d = free7[:, None] & free7[None, :]
            Hm = jnp.where(mask2d, Hm, 0.0) + jnp.diag(jnp.where(free7, 0.0, 1.0))
            bv = jnp.where(free7, b.reshape(-1), 0.0)
            dx = jax.scipy.linalg.cho_solve(
                jax.scipy.linalg.cho_factor(Hm, lower=True), bv
            ).reshape(F, 7)
            verts_new = sim3.compose(sim3.exp(dx), verts)
            chi2_new = _chi2(g, verts_new, huber_delta)
            rho = lm.gain_ratio(chi2_cur, chi2_new, dx.reshape(-1), bv, st.lam)
            accept = (chi2_new < chi2_cur) & jnp.isfinite(chi2_new)
            lam_n, nu_n = lm.lm_step_accept(st.lam, st.nu, rho, accept)
            verts_o = jnp.where(accept, verts_new, verts)
            chi2_o = jnp.where(accept, chi2_new, chi2_cur)
            stall = accept & (chi2_cur - chi2_new < 1e-9 * (chi2_cur + 1e-30))
            return verts_o, lm.LMState(lam_n, nu_n, chi2_o, st.it + 1, st.done | stall)

        def frozen(op):
            verts, st = op
            return verts, st._replace(it=st.it + 1)

        verts, st, n_run = carry
        n_run = n_run + jnp.where(st.done, 0, 1)
        verts, st = jax.lax.cond(st.done, frozen, step, (verts, st))
        return (verts, st, n_run), st.chi2

    st0 = lm.LMState(lam0, jnp.asarray(2.0, dtype), chi2_0, jnp.asarray(0, jnp.int32), jnp.asarray(False))
    (verts, st, n_run), chi2_h = jax.lax.scan(
        body, (g.vertices, st0, jnp.asarray(0, jnp.int32)), None, length=n_iters
    )
    return PoseGraphResult(verts, chi2_0, chi2_h, n_run)


def _linearize_blocks(g: PoseGraph, verts, huber_delta=None):
    """Edge-block linearization for the matrix-free path: returns residuals,
    per-edge Jacobians, weights, gradient b (F,7), block-diagonal of H
    (F,7,7), and chi2 — never materializing the (F*7)^2 Hessian."""
    F = verts.shape[0]
    S_i = verts[g.i_idx]
    S_j = verts[g.j_idx]
    r = _res_batch(S_i, S_j, g.meas)  # (E, 7)
    z7 = jnp.zeros(7, dtype=verts.dtype)
    Ji = _jac_i(z7, z7, S_i, S_j, g.meas)  # (E, 7, 7)
    Jj = _jac_j(z7, z7, S_i, S_j, g.meas)
    w, chi2 = _edge_weights(g, r, huber_delta)

    bi = -_einsum("eai,ea,e->ei", Ji, r, w)
    bj = -_einsum("eai,ea,e->ei", Jj, r, w)
    b = jnp.zeros((F, 7), dtype=verts.dtype)
    b = b.at[g.i_idx].add(bi).at[g.j_idx].add(bj)

    Hii = _einsum("eai,eaj,e->eij", Ji, Ji, w)
    Hjj = _einsum("eai,eaj,e->eij", Jj, Jj, w)
    D = jnp.zeros((F, 7, 7), dtype=verts.dtype)
    D = D.at[g.i_idx].add(Hii).at[g.j_idx].add(Hjj)
    return dict(r=r, Ji=Ji, Jj=Jj, w=w, chi2=chi2, b=b, D=D)


def _hessian_matvec(g: PoseGraph, lin, lam, free, x):
    """y = (H + lam I) x, gauge-masked, as two edge-batched scatter-adds.
    O(E) work and memory — the pose-graph analog of `cg_ba.schur_matvec`."""
    F = x.shape[0]
    xf = jnp.where(free[:, None], x, 0.0)
    # g_e = w * (Ji x_i + Jj x_j): the edge's contribution in residual space
    ge = lin["w"][:, None] * (
        _einsum("eai,ei->ea", lin["Ji"], xf[g.i_idx])
        + _einsum("eai,ei->ea", lin["Jj"], xf[g.j_idx])
    )  # (E, 7)
    yi = _einsum("eai,ea->ei", lin["Ji"], ge)
    yj = _einsum("eai,ea->ei", lin["Jj"], ge)
    y = jnp.zeros_like(x).at[g.i_idx].add(yi).at[g.j_idx].add(yj) + lam * xf
    y = jnp.where(free[:, None], y, 0.0)
    return y + jnp.where(free[:, None], 0.0, x)


def optimize_cg(
    g: PoseGraph,
    n_iters: int = 20,
    tau: float = 1e-5,
    max_cg_iters: int = 100,
    rtol: float = 1e-8,
    huber_delta=None,
) -> PoseGraphResult:
    """Large-scale pose-graph LM: block-Jacobi PCG on (H + lam I) dx = b,
    matrix-free. Handles KITTI-scale graphs (10k+ keyframes) where the dense
    (7F)^2 Cholesky of `optimize` cannot (SURVEY.md §5.7). Same LM schedule."""
    from monocular_slam_tpu.optim import cg_ba  # local import: avoid cycle

    dtype = g.vertices.dtype
    free = ~g.fixed
    eye7 = jnp.eye(7, dtype=dtype)

    lin0 = _linearize_blocks(g, g.vertices, huber_delta)
    lam0 = lm.init_lambda(jnp.diagonal(lin0["D"], axis1=-2, axis2=-1).reshape(-1), tau)

    def solve(lin, lam):
        D = lin["D"] + lam * eye7
        D = jnp.where(free[:, None, None], D, eye7[None])
        D_inv = jnp.linalg.inv(D)
        matvec = lambda x: _hessian_matvec(g, lin, lam, free, x)
        precond = lambda r: jnp.where(
            free[:, None], _einsum("fij,fj->fi", D_inv, r), 0.0
        )
        b = jnp.where(free[:, None], lin["b"], 0.0)
        dx, _ = cg_ba.pcg(matvec, precond, b, max_cg_iters, rtol)
        return dx, b

    def body(carry, _):

        def step(op):
            verts, st = op
            lin = _linearize_blocks(g, verts, huber_delta)
            dx, b = solve(lin, st.lam)
            verts_new = sim3.compose(sim3.exp(dx), verts)
            chi2_new = _chi2(g, verts_new, huber_delta)
            rho = lm.gain_ratio(lin["chi2"], chi2_new, dx.reshape(-1), b.reshape(-1), st.lam)
            accept = (chi2_new < lin["chi2"]) & jnp.isfinite(chi2_new)
            lam_n, nu_n = lm.lm_step_accept(st.lam, st.nu, rho, accept)
            verts_o = jnp.where(accept, verts_new, verts)
            chi2_o = jnp.where(accept, chi2_new, lin["chi2"])
            stall = accept & (lin["chi2"] - chi2_new < 1e-9 * (lin["chi2"] + 1e-30))
            return verts_o, lm.LMState(lam_n, nu_n, chi2_o, st.it + 1, st.done | stall)

        def frozen(op):
            verts, st = op
            return verts, st._replace(it=st.it + 1)

        verts, st, n_run = carry
        n_run = n_run + jnp.where(st.done, 0, 1)
        verts, st = jax.lax.cond(st.done, frozen, step, (verts, st))
        return (verts, st, n_run), st.chi2

    st0 = lm.LMState(lam0, jnp.asarray(2.0, dtype), lin0["chi2"], jnp.asarray(0, jnp.int32), jnp.asarray(False))
    (verts, st, n_run), chi2_h = jax.lax.scan(
        body, (g.vertices, st0, jnp.asarray(0, jnp.int32)), None, length=n_iters
    )
    return PoseGraphResult(verts, lin0["chi2"], chi2_h, n_run)


def sequential_graph(
    poses_sim3: jnp.ndarray,
    valid: jnp.ndarray,
    extra_i=None,
    extra_j=None,
    extra_meas=None,
    extra_weight=None,
    extra_valid=None,
    loop_weight: float = 5.0,
) -> PoseGraph:
    """Build the standard loop-closing graph: odometry edges between
    consecutive valid frames (measured from current estimates) + optional
    loop edges with their measured Sim3. `extra_valid` masks padded loop
    edges (fixed-capacity edge lists compile once per bucket)."""
    F = poses_sim3.shape[0]
    i_idx = jnp.arange(F - 1, dtype=jnp.int32)
    j_idx = i_idx + 1
    meas = sim3.compose(poses_sim3[i_idx], sim3.inverse(poses_sim3[j_idx]))
    w = jnp.ones(F - 1, dtype=poses_sim3.dtype)
    v = valid[i_idx] & valid[j_idx]
    rob = jnp.ones(F - 1, bool)  # odometry edges take the robust kernel
    if extra_i is not None:
        extra_i = jnp.asarray(extra_i, jnp.int32)
        i_idx = jnp.concatenate([i_idx, extra_i])
        j_idx = jnp.concatenate([j_idx, jnp.asarray(extra_j, jnp.int32)])
        meas = jnp.concatenate([meas, extra_meas])
        ew = (
            jnp.asarray(extra_weight)
            if extra_weight is not None
            else jnp.full(extra_i.shape[0], loop_weight, dtype=poses_sim3.dtype)
        )
        w = jnp.concatenate([w, ew])
        ev = (
            jnp.asarray(extra_valid, bool)
            if extra_valid is not None
            else jnp.ones(extra_i.shape[0], dtype=bool)
        )
        v = jnp.concatenate([v, ev])
        # loop edges are exempt: RANSAC-verified, and their initial
        # residual IS the drift being corrected
        rob = jnp.concatenate([rob, jnp.zeros(extra_i.shape[0], bool)])
    fixed = jnp.zeros(F, bool).at[0].set(True)
    return PoseGraph(
        vertices=poses_sim3, i_idx=i_idx, j_idx=j_idx, meas=meas, weight=w,
        valid=v, fixed=fixed, robust=rob,
    )
