"""Parity tests: the scatter-free (frame x feature)-structured BA engine
(`optim/window_ba.py`) against the generic edge-list engine (`optim/ba.py`).
Both implement the same g2o algebra (`block_solver.hpp:373-479`, LM schedule
`optimization_algorithm_levenberg.cpp:61-164`), so on identical graphs the
chi2 trajectories and solutions must agree to solver precision."""

import jax
import jax.numpy as jnp
import numpy as np

from monocular_slam_tpu.geometry import camera, se3, so3
from monocular_slam_tpu.optim import ba, window_ba

K = jnp.array([517.3, 516.5, 318.6, 255.3])


def make_problem(key, F=6, N=48, P=64, noise=0.5, drop=0.2, perturb=0.02):
    """A structured scene: F frames x N feature slots over P landmarks, with
    dropout, returned as BOTH a generic BAProblem and a WindowBAProblem."""
    kp, kperm, kn, kd, kx, kt = jax.random.split(key, 6)
    X = jax.random.uniform(kp, (P, 3), minval=-2, maxval=2) + jnp.array([0, 0, 6.0])
    poses = jnp.stack(
        [
            se3.from_Rt(
                so3.exp(jnp.array([0.0, 0.12 * i, 0.0])),
                jnp.array([-0.3 * i, 0.02 * i, 0.05 * i]),
            )
            for i in range(F)
        ]
    )
    # each frame observes a random subset of landmarks, one per feature slot,
    # WITHOUT duplicates inside a frame (the structured layout's invariant)
    pt_slot = jnp.stack(
        [
            jax.random.permutation(jax.random.fold_in(kperm, i), P)[:N]
            for i in range(F)
        ]
    ).astype(jnp.int32)
    uv_true = camera.project(K, se3.apply(poses[:, None], X[pt_slot]))
    uv = uv_true + noise * jax.random.normal(kn, uv_true.shape)
    valid = jax.random.uniform(kd, (F, N)) > drop
    info = jnp.ones((F, N), jnp.float32)
    fixed = jnp.zeros(F, bool).at[0].set(True)

    poses0 = se3.compose(
        se3.exp(perturb * jax.random.normal(kt, (F, 6))), poses
    ).at[0].set(poses[0])
    X0 = X + perturb * jax.random.normal(kx, X.shape)

    wprob = window_ba.build(
        poses0.astype(jnp.float32), X0.astype(jnp.float32),
        jnp.broadcast_to(K, (F, 4)).astype(jnp.float32),
        pt_slot, uv.astype(jnp.float32), info, valid, fixed,
    )
    gprob = ba.BAProblem(
        poses=wprob.poses,
        points=wprob.points,
        k=wprob.k,
        cam_idx=jnp.repeat(jnp.arange(F, dtype=jnp.int32), N),
        pt_idx=pt_slot.reshape(-1),
        uv=uv.reshape(-1, 2).astype(jnp.float32),
        info=info.reshape(-1),
        valid=valid.reshape(-1),
        fixed=fixed,
    )
    return wprob, gprob, poses, X


def _to64(p):
    """Cast a BA problem's float leaves to f64 for strict algebraic parity
    (both engines are identical algebra; f32 differences are conditioning)."""
    return p._replace(
        **{
            f: getattr(p, f).astype(jnp.float64)
            for f in ("poses", "points", "k", "uv", "info")
        }
    )


class TestParity:
    def test_linearize_matches_generic(self):
        wprob, gprob, _, _ = make_problem(jax.random.PRNGKey(0))
        wprob, gprob = _to64(wprob), _to64(gprob)
        lw = window_ba._linearize(wprob, wprob.poses, wprob.points, 2.45)
        lg = ba._linearize_graph(gprob, gprob.poses, gprob.points, 2.45)
        np.testing.assert_allclose(lw["chi2"], lg["chi2"], rtol=1e-12)
        np.testing.assert_allclose(lw["Hpp"], lg["Hpp"], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(lw["Hll"], lg["Hll"], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(lw["bp"], lg["bp"], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(lw["bl"], lg["bl"], rtol=1e-9, atol=1e-9)

    def test_solve_matches_generic(self):
        wprob, gprob, _, _ = make_problem(jax.random.PRNGKey(1))
        wprob, gprob = _to64(wprob), _to64(gprob)
        lam = jnp.asarray(1e-4, jnp.float64)
        lw = window_ba._linearize(wprob, wprob.poses, wprob.points, 2.45)
        lg = ba._linearize_graph(gprob, gprob.poses, gprob.points, 2.45)
        dxp_w, dxl_w, _ = window_ba._schur_solve(wprob, lw, lam)
        dxp_g, dxl_g, _ = ba._schur_solve(gprob, lg, lam)
        np.testing.assert_allclose(dxp_w, dxp_g, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(dxl_w, dxl_g, rtol=1e-6, atol=1e-9)

    def test_full_lm_matches_generic(self):
        wprob, gprob, poses_gt, X_gt = make_problem(jax.random.PRNGKey(2))
        wprob, gprob = _to64(wprob), _to64(gprob)
        rw = window_ba.bundle_adjust(wprob, n_iters=10)
        rg = ba.bundle_adjust(gprob, n_iters=10)
        np.testing.assert_allclose(rw.chi2_initial, rg.chi2_initial, rtol=1e-12)
        np.testing.assert_allclose(rw.chi2_history, rg.chi2_history, rtol=1e-6)
        np.testing.assert_allclose(rw.poses, rg.poses, atol=1e-7)
        # and it actually converges toward the ground truth
        assert float(rw.chi2_history[-1]) < 0.7 * float(rw.chi2_initial)

    def test_full_lm_f32_converges_like_f64(self):
        """The f32 path (what runs on the GPU) must reach the same chi2 basin as
        the f64 oracle even though individual steps differ in the noise."""
        wprob, _, _, _ = make_problem(jax.random.PRNGKey(2))
        r32 = window_ba.bundle_adjust(wprob, n_iters=10)
        r64 = window_ba.bundle_adjust(_to64(wprob), n_iters=10)
        assert float(r32.chi2_history[-1]) < 1.05 * float(r64.chi2_history[-1])

    def test_improves_noisy_geometry(self):
        wprob, _, poses_gt, X_gt = make_problem(
            jax.random.PRNGKey(3), noise=0.2, perturb=0.05
        )
        err0 = float(jnp.abs(wprob.poses[1:] - poses_gt[1:]).max())
        res = window_ba.bundle_adjust(wprob, n_iters=15)
        err1 = float(jnp.abs(res.poses[1:] - poses_gt[1:]).max())
        assert err1 < 0.3 * err0


class TestDedup:
    def test_duplicate_feature_edges_collapse(self):
        """Two features of one frame pointing at the same landmark must
        contribute exactly one edge (g2o would double-count)."""
        wprob, _, _, _ = make_problem(jax.random.PRNGKey(4), F=3, N=16, P=32)
        # force a duplicate: feature 1 of frame 1 points at feature 0's landmark
        pt_dup = wprob.pt_slot.at[1, 1].set(wprob.pt_slot[1, 0])
        valid = wprob.valid.at[1, 0].set(True).at[1, 1].set(True)
        dup = window_ba.build(
            wprob.poses, wprob.points, wprob.k, pt_dup, wprob.uv,
            wprob.info, valid, wprob.fixed,
        )
        both = dup.valid[1, 0] & dup.valid[1, 1]
        assert not bool(both)
        assert bool(dup.valid[1, 0] | dup.valid[1, 1])

    def test_table_roundtrip(self):
        wprob, _, _, _ = make_problem(jax.random.PRNGKey(5))
        F, N = wprob.pt_slot.shape
        table = np.asarray(wprob.obs_table)
        valid = np.asarray(wprob.valid)
        pt = np.asarray(wprob.pt_slot)
        for f in range(F):
            for n in range(0, N, 7):
                if valid[f, n]:
                    assert table[pt[f, n], f] == f * N + n
