"""The port's SO3/SE3 maps against sos_slam_tpu.utils.lie."""

import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.utils import lie as JL
from sos_slam_tpu_torch.utils import lie as TL
from tests.test_torch_helpers import close, t


def _xis(seed, scale):
    r = np.random.RandomState(seed)
    xi = (r.randn(16, 6) * scale).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = 1e-5          # below the small-angle switch
    return xi


@pytest.mark.parametrize("scale", [1e-4, 0.05, 0.8])
def test_se3_exp_log_inv_adj(scale):
    xi = _xis(int(scale * 1e4), scale)
    T_j = JL.se3_exp(jnp.asarray(xi))
    T_t = TL.se3_exp(t(xi))
    close(T_j, T_t, tol=1e-5)
    close(JL.se3_log(T_j), TL.se3_log(t(np.asarray(T_j))), tol=2e-4)
    close(JL.se3_inv(T_j), TL.se3_inv(t(np.asarray(T_j))), tol=1e-5)
    close(JL.se3_adj(T_j), TL.se3_adj(t(np.asarray(T_j))), tol=1e-5)
    close(JL.so3_exp(jnp.asarray(xi[:, 3:])), TL.so3_exp(t(xi[:, 3:])),
          tol=1e-5)


def test_so3_log_near_pi():
    w = np.array([[np.pi - 1e-4, 0, 0], [0, 3.1, 0.1]], np.float32)
    R = np.asarray(JL.so3_exp(jnp.asarray(w)))
    close(JL.so3_log(jnp.asarray(R)), TL.so3_log(t(R)), tol=2e-4)


def test_numpy_twins_match():
    xi = np.array([0.1, -0.2, 0.3, 0.05, -0.02, 0.3])
    np.testing.assert_allclose(TL.np_se3_exp(xi), JL.np_se3_exp(xi))
    np.testing.assert_allclose(TL.np_se3_log(JL.np_se3_exp(xi)),
                               JL.np_se3_log(JL.np_se3_exp(xi)))
    q = np.array([0.9, 0.1, -0.2, 0.3])
    np.testing.assert_allclose(TL.np_quat_to_rot(q), JL.np_quat_to_rot(q))



def _xis7(seed, scale, sig_scale):
    r = np.random.RandomState(seed)
    xi = (r.randn(16, 7) * scale).astype(np.float32)
    xi[:, 6] = (r.randn(16) * sig_scale).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:7] = [1e-5, 1e-5, 1e-5, 0.2]     # small angle, sigma > 0
    xi[2, 6] = 3e-5                            # below the small-sigma switch
    xi[3, 3:7] = [1e-5, 0.0, 0.0, 2e-5]
    xi[4, 3:7] = [1e-5, 1e-5, 1e-5, -0.3]    # small angle, sigma < 0
    return xi


def _jax_c_fault(xi):
    """Rows where the JAX package's _sim3_W is wrong: theta below the
    small-angle switch and sigma < -1e-4 (it clamps 2 sigma^3 from below,
    so C comes out near -1e19)."""
    return (np.sum(xi[:, 3:6].astype(np.float64) ** 2, -1) < 1e-6) \
        & (xi[:, 6] < -1e-4)


def _W64(w, sig):
    """float64 reference of the sim3 translation integral
    W = int_0^1 exp(tau sigma) R(tau w) dtau (Gauss-Legendre)."""
    x, wt = np.polynomial.legendre.leggauss(24)
    tau, wt = 0.5 * (x + 1.0), 0.5 * wt
    out = np.zeros((len(w), 3, 3))
    for k in range(len(w)):
        for tk, wk in zip(tau, wt):
            out[k] += wk * np.exp(tk * sig[k]) * JL.np_so3_exp(tk * w[k])
    return out


@pytest.mark.parametrize("scale,sig_scale", [(1e-4, 1e-5), (0.05, 0.1),
                                             (0.8, 0.5)])
def test_sim3_exp_log_inv(scale, sig_scale):
    xi = _xis7(int(scale * 1e4), scale, sig_scale)
    ok = ~_jax_c_fault(xi)
    assert ok.sum() >= 12
    T_j = JL.sim3_exp(jnp.asarray(xi[ok]))
    close(T_j, TL.sim3_exp(t(xi[ok])), tol=1e-5)
    Tn = np.asarray(T_j)
    close(JL.sim3_log(T_j), TL.sim3_log(t(Tn)), tol=2e-4)
    close(JL.sim3_inv(T_j), TL.sim3_inv(t(Tn)), tol=1e-5)
    close(JL._sim3_W(jnp.asarray(xi[ok, 3:6]), jnp.asarray(xi[ok, 6])),
          TL._sim3_W(t(xi[ok, 3:6]), t(xi[ok, 6])), tol=1e-5)


@pytest.mark.parametrize("scale,sig_scale", [(1e-4, 1e-5), (0.05, 0.1),
                                             (0.8, 0.5)])
def test_sim3_against_float64(scale, sig_scale):
    """Every row, those where the JAX package's W is wrong included: W
    against its float64 integral, and exp -> log -> xi, exp -> inv."""
    xi = _xis7(int(scale * 1e4), scale, sig_scale)
    assert _jax_c_fault(xi).any()
    W = TL._sim3_W(t(xi[:, 3:6]), t(xi[:, 6]))
    close(_W64(xi[:, 3:6].astype(np.float64), xi[:, 6].astype(np.float64)),
          W, tol=1e-5)
    T = TL.sim3_exp(t(xi))
    close(xi, TL.sim3_log(T), tol=1e-4)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), T.shape)
    close(eye, TL.sim3_inv(T) @ T, tol=1e-5)


def test_sim3_log_near_pi():
    xi = np.array([[0.1, -0.2, 0.3, np.pi - 1e-4, 0, 0, 0.3],
                   [0.0, 0.1, 0.0, 0, 3.1, 0.1, -0.2]], np.float32)
    T = np.asarray(JL.sim3_exp(jnp.asarray(xi)))
    close(JL.sim3_log(jnp.asarray(T)), TL.sim3_log(t(T)), tol=2e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_from_rt_and_quat_to_rot(seed):
    r = np.random.RandomState(seed)
    q = r.randn(16, 4).astype(np.float32)
    q[0] = [1.0, 0.0, 0.0, 0.0]
    q[1] = [1e-4, 1.0, 0.0, 0.0]          # a half turn
    R_j = JL.quat_to_rot(jnp.asarray(q))
    R_t = TL.quat_to_rot(t(q))
    close(R_j, R_t, tol=1e-6)
    tv = r.randn(16, 3).astype(np.float32)
    close(JL.se3_from_rt(R_j, jnp.asarray(tv)),
          TL.se3_from_rt(R_t, t(tv)), tol=1e-6)
