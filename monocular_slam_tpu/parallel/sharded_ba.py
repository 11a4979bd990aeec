"""Distributed global bundle adjustment: landmark-sharded Schur reduction.

The distributed replacement for the one parallel region the reference has —
g2o's OpenMP Schur loop (`ThirdParty/g2o/g2o/core/block_solver.hpp:378-431`)
— scaled out over a device mesh (BASELINE.json configs[4]):

  - map points are partitioned into contiguous slabs, one per device on the
    mesh's "model" axis; every BA edge lives with the device that owns its
    landmark, so Hll and the landmark back-substitution are entirely local;
  - pose blocks are replicated: Hpp, the reduced gradient, and the Schur
    cross-term S are assembled with `psum` over the model axis (the
    "reduce" of the distributed Schur reduction);
  - each device solves the same reduced pose system (F*6 x F*6 Cholesky) —
    replicated deterministic solve, no broadcast needed;
  - the LM trust-region loop runs inside `shard_map`, collectives in-loop.

Communication per LM iteration: one psum of (F*6)^2 + O(F) floats —
independent of the number of landmarks, which is what makes the landmark
axis scale.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from monocular_slam_tpu.geometry import se3
from monocular_slam_tpu.optim import ba as ba_mod
from monocular_slam_tpu.optim import cg_ba
from monocular_slam_tpu.optim import lm
from monocular_slam_tpu.utils.linalg import inv3x3
from monocular_slam_tpu.utils.precision import einsum_hp as _einsum, matmul_hp as _mm


class ShardedBAResult(NamedTuple):
    poses: jnp.ndarray
    points: jnp.ndarray  # in ORIGINAL point order
    chi2_initial: jnp.ndarray
    chi2_history: jnp.ndarray
    n_iters_run: jnp.ndarray


def partition_problem(prob: ba_mod.BAProblem, n_shards: int):
    """Host-side repartition: pad points to a multiple of n_shards; group
    edges by owning landmark slab, pad each group to equal length.

    Returns (prob_padded, perm) where perm is unused (points keep their ids —
    slabs are by id range)."""
    P_ = prob.points.shape[0]
    P_pad = ((P_ + n_shards - 1) // n_shards) * n_shards
    slab = P_pad // n_shards

    pt = np.asarray(prob.pt_idx)
    valid = np.asarray(prob.valid)
    owner = np.clip(pt // slab, 0, n_shards - 1)

    counts = np.bincount(owner[valid], minlength=n_shards)
    e_max = int(counts.max()) if counts.size else 1
    e_max = max(e_max, 1)

    def pad_field(arr, fill):
        arr = np.asarray(arr)
        out_shape = (n_shards * e_max,) + arr.shape[1:]
        out = np.full(out_shape, fill, dtype=arr.dtype)
        for s in range(n_shards):
            sel = np.where(valid & (owner == s))[0]
            out[s * e_max : s * e_max + len(sel)] = arr[sel]
        return out

    pts_pad = np.zeros((P_pad, 3), np.asarray(prob.points).dtype)
    pts_pad[:P_] = np.asarray(prob.points)

    new = ba_mod.BAProblem(
        poses=prob.poses,
        points=jnp.asarray(pts_pad),
        k=prob.k,
        cam_idx=jnp.asarray(pad_field(prob.cam_idx, 0)),
        pt_idx=jnp.asarray(pad_field(prob.pt_idx, 0)),
        uv=jnp.asarray(pad_field(prob.uv, 0.0)),
        info=jnp.asarray(pad_field(prob.info, 0.0)),
        valid=jnp.asarray(pad_field(prob.valid, False)),
        fixed=prob.fixed,
    )
    return new, P_


def _sharded_lm(
    poses, points_l, k, cam_idx_l, pt_idx_l, uv_l, info_l, valid_l, fixed,
    *, n_iters: int, delta: float, tau: float, slab: int,
    solver: str = "dense", max_cg_iters: int = 100, cg_rtol: float = 1e-8,
):
    """shard_map body: everything suffixed _l is the device-local block."""
    dtype = poses.dtype
    F = poses.shape[0]
    me = jax.lax.axis_index("model")
    # Edge pt ids -> local slab coordinates; foreign edges are invalid by
    # construction (partition_problem groups edges with their owner).
    pt_local = pt_idx_l - me * slab
    in_slab = (pt_local >= 0) & (pt_local < slab)
    valid_l = valid_l & in_slab
    pt_local = jnp.clip(pt_local, 0, slab - 1)

    local_prob = ba_mod.BAProblem(
        poses=poses, points=points_l, k=k,
        cam_idx=cam_idx_l, pt_idx=pt_local, uv=uv_l, info=info_l,
        valid=valid_l, fixed=fixed,
    )

    def lin_graph(poses_c, points_c):
        lin = ba_mod._linearize_graph(local_prob, poses_c, points_c, delta)
        lin["chi2"] = jax.lax.psum(lin["chi2"], "model")
        lin["Hpp"] = jax.lax.psum(lin["Hpp"], "model")
        lin["bp"] = jax.lax.psum(lin["bp"], "model")
        return lin

    def chi2_graph(poses_c, points_c):
        return jax.lax.psum(
            ba_mod._chi2_graph(local_prob, poses_c, points_c, delta), "model"
        )

    def schur_solve(lin, lam):
        eye6 = jnp.eye(6, dtype=dtype)
        eye3 = jnp.eye(3, dtype=dtype)
        Hpp_d = lin["Hpp"] + lam * eye6
        Hll_d = lin["Hll"] + lam * eye3  # (slab, 3, 3) local
        Hll_inv = inv3x3(Hll_d)
        Y_e = _mm(lin["W_e"], Hll_inv[pt_local])  # (E_l, 6, 3)

        def scatter_fp(blocks):
            out = jnp.zeros((F, 6, slab, 3), dtype=dtype)
            return out.at[cam_idx_l, :, pt_local, :].add(
                jnp.where(valid_l[:, None, None], blocks, 0.0)
            )

        U = scatter_fp(lin["W_e"]).reshape(F * 6, slab * 3)
        Y = scatter_fp(Y_e).reshape(F * 6, slab * 3)
        S_cross = jax.lax.psum(_mm(Y, U.T), "model")

        S = jnp.zeros((F, 6, F, 6), dtype=dtype)
        S = S.at[jnp.arange(F), :, jnp.arange(F), :].set(Hpp_d)
        S = S.reshape(F * 6, F * 6) - S_cross

        yb_e = _einsum("eij,ej->ei", Y_e, lin["bl"][pt_local])
        b_red = lin["bp"] - jax.lax.psum(
            jax.ops.segment_sum(
                jnp.where(valid_l[:, None], yb_e, 0.0), cam_idx_l, num_segments=F
            ),
            "model",
        )

        free = ~fixed
        free6 = jnp.repeat(free, 6)
        mask2d = free6[:, None] & free6[None, :]
        S = jnp.where(mask2d, S, 0.0) + jnp.diag(jnp.where(free6, 0.0, 1.0))
        b_vec = jnp.where(free[:, None], b_red, 0.0).reshape(F * 6)
        dxp = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S, lower=True), b_vec
        ).reshape(F, 6)

        wt_dxp = _einsum("eij,ei->ej", lin["W_e"], dxp[cam_idx_l])
        rhs_l = lin["bl"] - jax.ops.segment_sum(
            jnp.where(valid_l[:, None], wt_dxp, 0.0), pt_local, num_segments=slab
        )
        dxl = _einsum("pij,pj->pi", Hll_inv, rhs_l)
        return dxp, dxl

    def schur_solve_cg(lin, lam):
        """Matrix-free distributed Schur solve: block-Jacobi PCG where each
        S-matvec costs ONE psum of an (F, 6) vector — communication is
        independent of landmark count AND of F^2 (the dense path psums the
        full (F*6)^2 cross term every LM iteration). This is the KITTI-scale
        path (SURVEY.md §5.7, BASELINE.json configs[3-4])."""
        eye3 = jnp.eye(3, dtype=dtype)
        eye6 = jnp.eye(6, dtype=dtype)
        free = ~fixed
        Hll_inv = inv3x3(lin["Hll"] + lam * eye3)  # (slab, 3, 3) local

        # Invalid/padded edges already have W_e == bl == 0 (their IRLS weight
        # is zeroed in _edge_weights), so no extra masking is needed.
        yb_p = _einsum("pij,pj->pi", Hll_inv, lin["bl"])  # (slab, 3)
        wy_e = _einsum("eij,ej->ei", lin["W_e"], yb_p[pt_local])  # (E_l, 6)
        b_red = lin["bp"] - jax.lax.psum(
            jax.ops.segment_sum(wy_e, cam_idx_l, num_segments=F), "model"
        )
        b_red = jnp.where(free[:, None], b_red, 0.0)

        # Block-Jacobi preconditioner: exact S diagonal blocks, one psum.
        WHW_e = _mm(_mm(lin["W_e"], Hll_inv[pt_local]), jnp.swapaxes(lin["W_e"], -1, -2))
        D = lin["Hpp"] + lam * eye6 - jax.lax.psum(
            jax.ops.segment_sum(WHW_e, cam_idx_l, num_segments=F), "model"
        )
        D = jnp.where(free[:, None, None], D, eye6[None])
        D_inv = jnp.linalg.inv(D)

        def matvec(x):
            xf = jnp.where(free[:, None], x, 0.0)
            t1 = _einsum("fij,fj->fi", lin["Hpp"], xf) + lam * xf
            u_e = _einsum("eij,ei->ej", lin["W_e"], xf[cam_idx_l])  # (E_l, 3)
            s_p = jax.ops.segment_sum(u_e, pt_local, num_segments=slab)
            y_p = _einsum("pij,pj->pi", Hll_inv, s_p)
            v_e = _einsum("eij,ej->ei", lin["W_e"], y_p[pt_local])  # (E_l, 6)
            t2 = jax.lax.psum(
                jax.ops.segment_sum(v_e, cam_idx_l, num_segments=F), "model"
            )
            y = jnp.where(free[:, None], t1 - t2, 0.0)
            return y + jnp.where(free[:, None], 0.0, x)

        precond = lambda r: jnp.where(
            free[:, None], _einsum("fij,fj->fi", D_inv, r), 0.0
        )
        dxp, _stats = cg_ba.pcg(matvec, precond, b_red, max_cg_iters, cg_rtol)

        wt_dxp = _einsum("eij,ei->ej", lin["W_e"], dxp[cam_idx_l])
        rhs_l = lin["bl"] - jax.ops.segment_sum(wt_dxp, pt_local, num_segments=slab)
        dxl = _einsum("pij,pj->pi", Hll_inv, rhs_l)
        return dxp, dxl

    solve = schur_solve if solver == "dense" else schur_solve_cg

    lin0 = lin_graph(poses, points_l)
    diag0 = jnp.concatenate([
        jnp.diagonal(lin0["Hpp"], axis1=-2, axis2=-1).reshape(-1),
        jax.lax.pmax(
            jnp.max(jnp.diagonal(lin0["Hll"], axis1=-2, axis2=-1)).reshape(1), "model"
        ),
    ])
    lam0 = lm.init_lambda(diag0, tau)

    def body(carry, _):
        poses_c, points_c, st = carry

        def step(op):
            poses_c, points_c, st = op
            lin = lin_graph(poses_c, points_c)
            dxp, dxl = solve(lin, st.lam)
            poses_n = se3.compose(se3.exp(dxp), poses_c)
            points_n = points_c + dxl
            chi2_n = chi2_graph(poses_n, points_n)
            dx2 = jnp.sum(dxp * dxp) + jax.lax.psum(jnp.sum(dxl * dxl), "model")
            db = jnp.sum(dxp * lin["bp"]) + jax.lax.psum(
                jnp.sum(dxl * lin["bl"]), "model"
            )
            rho = (lin["chi2"] - chi2_n) / (st.lam * dx2 + db + 1e-30)
            accept = (chi2_n < lin["chi2"]) & jnp.isfinite(chi2_n)
            lam_n, nu_n = lm.lm_step_accept(st.lam, st.nu, rho, accept)
            poses_o = jnp.where(accept, poses_n, poses_c)
            points_o = jnp.where(accept, points_n, points_c)
            chi2_o = jnp.where(accept, chi2_n, lin["chi2"])
            stall = accept & (lin["chi2"] - chi2_n < 1e-6 * lin["chi2"])
            return (poses_o, points_o, lm.LMState(lam_n, nu_n, chi2_o, st.it + 1, st.done | stall))

        def frozen(op):
            poses_c, points_c, st = op
            return (poses_c, points_c, st._replace(it=st.it + 1))

        poses_c, points_c, st = jax.lax.cond(st.done, frozen, step, (poses_c, points_c, st))
        return (poses_c, points_c, st), st.chi2

    st0 = lm.LMState(lam0, jnp.asarray(2.0, dtype), lin0["chi2"], jnp.asarray(0, jnp.int32), jnp.asarray(False))
    (poses_f, points_f, st), chi2_h = jax.lax.scan(body, (poses, points_l, st0), None, length=n_iters)
    return poses_f, points_f, lin0["chi2"], chi2_h, st.it


def distributed_bundle_adjust(
    prob: ba_mod.BAProblem,
    mesh: Mesh,
    n_iters: int = ba_mod.FULL_BA_ITER,
    delta: float = ba_mod.THRESH_HUBER_FULL_BA,
    tau: float = 1e-5,
    solver: str = "auto",
    max_cg_iters: int = 100,
    cg_rtol: float = 1e-8,
) -> ShardedBAResult:
    """Global BA with landmarks sharded over mesh axis "model".

    Host-side entry: partitions the problem, runs the sharded LM program,
    restores original point order.

    solver="dense": replicated (F*6)^2 Cholesky per LM iteration — exact,
    right for up to a few hundred keyframes at SMALL shard counts: its
    per-iteration collective is the full (F*6, F*6) reduced system, an
    O(F^2) psum repeated on every device, so throughput DEGRADES with the
    shard count (4.9 -> 2.6 iters/s from 1 -> 8 shards at F=32, measured on virtual
    CPU devices, not on GPUs).
    solver="cg": matrix-free block-Jacobi PCG (`optim/cg_ba.py`) — one (F,6)
    psum per CG step, no F^2 communication; the KITTI-scale path (measured
    2.7 -> 4.4 iters/s over the same sweep).
    solver="auto" (default): dense on <= 2 shards, cg beyond — the measured
    crossover.
    """
    if solver == "auto":
        n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        solver = "dense" if n_shards <= 2 else "cg"
    fn, args, P_orig = build_sharded_fn(
        prob, mesh, n_iters=n_iters, delta=delta, tau=tau, solver=solver,
        max_cg_iters=max_cg_iters, cg_rtol=cg_rtol,
    )
    poses, points, chi2_0, chi2_h, it = fn(*args)
    return ShardedBAResult(poses, points[:P_orig], chi2_0, chi2_h, it)


def build_sharded_fn(
    prob: ba_mod.BAProblem,
    mesh: Mesh,
    n_iters: int = ba_mod.FULL_BA_ITER,
    delta: float = ba_mod.THRESH_HUBER_FULL_BA,
    tau: float = 1e-5,
    solver: str = "dense",
    max_cg_iters: int = 100,
    cg_rtol: float = 1e-8,
):
    """(jitted fn, args, P_orig) for the sharded LM program — split out so
    tests can `fn.lower(*args)` and machine-check the compiled collectives
    (communication-volume contract) without running it."""
    n_shards = mesh.shape["model"]
    pprob, P_orig = partition_problem(prob, n_shards)
    slab = pprob.points.shape[0] // n_shards

    fn = jax.jit(
        jax.shard_map(
            partial(
                _sharded_lm, n_iters=n_iters, delta=delta, tau=tau, slab=slab,
                solver=solver, max_cg_iters=max_cg_iters, cg_rtol=cg_rtol,
            ),
            mesh=mesh,
            in_specs=(
                P(),  # poses replicated
                P("model"),  # points sharded by slab
                P(),  # k
                P("model"),  # cam_idx (edge-sharded, aligned with owner)
                P("model"),  # pt_idx
                P("model"),  # uv
                P("model"),  # info
                P("model"),  # valid
                P(),  # fixed
            ),
            out_specs=(P(), P("model"), P(), P(), P()),
        )
    )
    args = (
        pprob.poses, pprob.points, pprob.k, pprob.cam_idx, pprob.pt_idx,
        pprob.uv, pprob.info, pprob.valid, pprob.fixed,
    )
    return fn, args, P_orig
