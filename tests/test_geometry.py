"""Unit tests for SO3/SE3/Sim3/camera — closed-form and round-trip oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monocular_slam_tpu.geometry import camera, se3, sim3, so3


def rand_rotations(key, n):
    w = jax.random.normal(key, (n, 3)) * 1.5
    return so3.exp(w)


class TestSO3:
    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(0)
        w = jax.random.normal(key, (64, 3)) * 2.0
        R = so3.exp(w)
        # Valid rotations
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.det(R)), np.ones(64), atol=1e-9
        )
        w2 = so3.log(R)
        R2 = so3.exp(w2)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-8)

    def test_exp_small_angle(self):
        w = jnp.array([[1e-10, 0.0, 0.0], [0.0, 0.0, 0.0]])
        R = so3.exp(w)
        np.testing.assert_allclose(np.asarray(R[1]), np.eye(3), atol=1e-12)
        assert np.all(np.isfinite(np.asarray(jax.jacobian(lambda x: so3.exp(x))(w[1]))))

    def test_log_near_pi(self):
        axis = jnp.array([1.0, 2.0, -0.5])
        axis = axis / jnp.linalg.norm(axis)
        for theta in [np.pi - 1e-5, np.pi - 1e-9]:
            R = so3.exp(axis * theta)
            w = so3.log(R)
            np.testing.assert_allclose(np.asarray(so3.exp(w)), np.asarray(R), atol=1e-6)

    def test_quat_roundtrip(self):
        key = jax.random.PRNGKey(1)
        R = rand_rotations(key, 32)
        q = so3.matrix_to_quat(R)
        R2 = so3.quat_to_matrix(q)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-9)

    def test_quat_matches_scipy(self):
        from scipy.spatial.transform import Rotation

        key = jax.random.PRNGKey(2)
        R = np.asarray(rand_rotations(key, 16))
        q_ours = np.asarray(so3.matrix_to_quat(jnp.asarray(R)))
        q_sp = Rotation.from_matrix(R).as_quat()  # (x,y,z,w)
        # Same up to sign
        for a, b in zip(q_ours, q_sp):
            assert np.allclose(a, b, atol=1e-9) or np.allclose(a, -b, atol=1e-9)

    def test_project_to_so3(self):
        key = jax.random.PRNGKey(3)
        M = jax.random.normal(key, (8, 3, 3))
        R = so3.project_to_so3(M)
        np.testing.assert_allclose(
            np.asarray(R @ jnp.swapaxes(R, -1, -2)), np.tile(np.eye(3), (8, 1, 1)), atol=1e-9
        )
        np.testing.assert_allclose(np.asarray(jnp.linalg.det(R)), np.ones(8), atol=1e-9)


class TestSE3:
    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(4)
        xi = jax.random.normal(key, (64, 6))
        T = se3.exp(xi)
        xi2 = se3.log(T)
        np.testing.assert_allclose(np.asarray(xi), np.asarray(xi2), atol=1e-8)

    def test_compose_inverse(self):
        key = jax.random.PRNGKey(5)
        k1, k2 = jax.random.split(key)
        A, B = se3.exp(jax.random.normal(k1, (16, 6))), se3.exp(jax.random.normal(k2, (16, 6)))
        AB = se3.compose(A, B)
        X = jax.random.normal(jax.random.PRNGKey(6), (16, 3))
        np.testing.assert_allclose(
            np.asarray(se3.apply(AB, X)), np.asarray(se3.apply(A, se3.apply(B, X))), atol=1e-9
        )
        ident = se3.compose(A, se3.inverse(A))
        np.testing.assert_allclose(np.asarray(ident), np.asarray(se3.identity(jnp.float64, (16,))), atol=1e-9)

    def test_camera_center(self):
        key = jax.random.PRNGKey(7)
        T = se3.exp(jax.random.normal(key, (8, 6)))
        C = se3.camera_center(T)
        # The camera center maps to the origin.
        np.testing.assert_allclose(np.asarray(se3.apply(T, C)), np.zeros((8, 3)), atol=1e-9)

    def test_exp_matches_matrix_expm(self):
        from scipy.linalg import expm

        xi = np.array([0.3, -0.2, 0.5, 1.0, -2.0, 0.25])
        M = np.zeros((4, 4))
        M[:3, :3] = np.asarray(so3.hat(jnp.asarray(xi[:3])))
        M[:3, 3] = xi[3:]
        T_ref = expm(M)
        T = np.asarray(se3.exp(jnp.asarray(xi)))
        np.testing.assert_allclose(T, T_ref[:3, :4], atol=1e-9)


class TestSim3:
    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(8)
        xi = jax.random.normal(key, (32, 7))
        xi = xi.at[:, 6].multiply(0.3)  # keep scales sane
        S = sim3.exp(xi)
        xi2 = sim3.log(S)
        np.testing.assert_allclose(np.asarray(xi), np.asarray(xi2), atol=1e-7)

    def test_compose_inverse_apply(self):
        key = jax.random.PRNGKey(9)
        k1, k2, k3 = jax.random.split(key, 3)
        A = sim3.exp(jax.random.normal(k1, (8, 7)) * 0.5)
        B = sim3.exp(jax.random.normal(k2, (8, 7)) * 0.5)
        X = jax.random.normal(k3, (8, 3))
        np.testing.assert_allclose(
            np.asarray(sim3.apply(sim3.compose(A, B), X)),
            np.asarray(sim3.apply(A, sim3.apply(B, X))),
            atol=1e-9,
        )
        ident = sim3.compose(A, sim3.inverse(A))
        np.testing.assert_allclose(np.asarray(sim3.apply(ident, X)), np.asarray(X), atol=1e-8)

    def test_identity_scale(self):
        S = sim3.identity(jnp.float64)
        R, t, s = sim3.unpack(S)
        assert float(s) == 1.0
        np.testing.assert_allclose(np.asarray(R), np.eye(3))


class TestCamera:
    K = jnp.array([517.3, 516.5, 318.6, 255.3])  # TUM fr1 (FrameLoader.cpp:171-238)

    def test_project_backproject(self):
        key = jax.random.PRNGKey(10)
        X = jax.random.normal(key, (128, 3)) * jnp.array([1.0, 1.0, 0.1]) + jnp.array([0, 0, 3.0])
        uv = camera.project(self.K, X)
        X2 = camera.backproject(self.K, uv, X[..., 2])
        np.testing.assert_allclose(np.asarray(X), np.asarray(X2), atol=1e-9)

    def test_project_matches_matrix(self):
        X = jnp.array([0.2, -0.1, 2.0])
        Km = camera.intrinsics_to_matrix(self.K)
        expected = np.asarray(Km @ X)
        expected = expected[:2] / expected[2]
        np.testing.assert_allclose(np.asarray(camera.project(self.K, X)), expected, atol=1e-9)

    def test_distort_undistort(self):
        # Real TUM fr1 coefficients (strong distortion) — same family the
        # reference hardcodes in CameraPoseEstimator.cpp:462-469.
        dist = jnp.array([0.262383, -0.953104, -0.005358, 0.002628, 1.163314])
        key = jax.random.PRNGKey(11)
        xy = jnp.tanh(jax.random.normal(key, (64, 2))) * 0.45  # |xy| < 0.45
        xy_d = camera.distort_radtan(dist, xy)
        xy_u = camera.undistort_radtan(dist, xy_d, iters=25)
        np.testing.assert_allclose(np.asarray(xy), np.asarray(xy_u), atol=1e-6)

    def test_undistort_matches_opencv(self):
        import cv2

        dist = np.array([0.262383, -0.953104, -0.005358, 0.002628, 1.163314])
        K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1.0]])
        uv = np.array([[100.0, 100.0], [320.0, 240.0], [600.0, 50.0], [50.0, 430.0]])
        ref = cv2.undistortPoints(uv.reshape(-1, 1, 2), K, dist).reshape(-1, 2)
        k = jnp.array([517.3, 516.5, 318.6, 255.3])
        xy_d = camera.normalize_points(k, jnp.asarray(uv))
        ours = np.asarray(camera.undistort_radtan(jnp.asarray(dist), xy_d, iters=30))
        np.testing.assert_allclose(ours, ref, atol=1e-5)

    def test_in_image(self):
        uv = jnp.array([[0.0, 0.0], [639.0, 479.0], [-1.0, 5.0], [640.0, 100.0]])
        mask = camera.in_image(uv, 640, 480)
        assert np.asarray(mask).tolist() == [True, True, False, False]

    def test_intrinsics_matrix_roundtrip(self):
        Km = camera.intrinsics_to_matrix(self.K)
        np.testing.assert_allclose(np.asarray(camera.matrix_to_intrinsics(Km)), np.asarray(self.K))


def test_jit_and_vmap_compose():
    """Everything must be jit/vmap-composable (the device contract)."""
    f = jax.jit(jax.vmap(lambda xi, X: camera.project(TestCamera.K, se3.apply(se3.exp(xi), X))))
    xi = jnp.zeros((4, 6))
    X = jnp.ones((4, 3))
    out = f(xi, X)
    assert out.shape == (4, 2)
    assert np.all(np.isfinite(np.asarray(out)))
