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
