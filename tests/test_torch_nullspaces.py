"""The port's gauge null spaces and orthogonalize against
sos_slam_tpu.models.energy, on tests/test_nullspaces.py's windows and at
its tolerances (1e-4 on the pose directions, 1e-6 on scale and affine)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.models import energy as JE
from sos_slam_tpu_torch.models import energy as TE
from sos_slam_tpu_torch.ops import ba as TB
from tests.test_nullspaces import _tiny_ba
from tests.test_torch_helpers import close, port_state, t


def _poses(seed):
    """Identity, a pure translation and two seeded rigid poses."""
    from sos_slam_tpu.utils import lie
    r = np.random.RandomState(seed)
    T = [np.eye(4, dtype=np.float32)]
    Tt = np.eye(4, dtype=np.float32)
    Tt[:3, 3] = [1.0, -2.0, 0.5]
    T.append(Tt)
    for _ in range(2):
        xi = (r.randn(6) * [0.3, 0.3, 0.3, 0.4, 0.4, 0.4]).astype(np.float32)
        T.append(np.asarray(lie.se3_exp(jnp.asarray(xi))))
    return np.stack(T)


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_nullspaces_match(seed):
    Ts = _poses(seed)
    r = np.random.RandomState(seed + 10)
    exposure = (0.5 + r.rand(len(Ts))).astype(np.float32)
    a0 = (0.2 * r.randn(len(Ts))).astype(np.float32)
    p_t, s_t, a_t = TE.frame_nullspaces(t(Ts), t(exposure), t(a0))
    for i in range(len(Ts)):
        p_j, s_j, a_j = JE.frame_nullspaces(
            jnp.asarray(Ts[i]), jnp.float32(exposure[i]), jnp.float32(a0[i]))
        np.testing.assert_allclose(p_t[i].numpy(), np.asarray(p_j),
                                   atol=1e-4)
        np.testing.assert_allclose(s_t[i].numpy(), np.asarray(s_j),
                                   atol=1e-6)
        np.testing.assert_allclose(a_t[i].numpy(), np.asarray(a_j),
                                   atol=1e-6)


@pytest.mark.parametrize("F", [4, 8])
def test_get_nullspaces_match(F):
    ba_j = _tiny_ba(F=F)
    ns_j = np.asarray(JE.get_nullspaces(ba_j))
    ns_t = TE.get_nullspaces(port_state(TB.BAState, ba_j)).numpy()
    assert ns_t.shape == ns_j.shape == (9, 4 + 8 * F)
    # the calib block and the invalid frame slots are exactly zero in both
    np.testing.assert_array_equal(ns_t[:, :4], 0.0)
    np.testing.assert_array_equal(ns_t[:, 4 + 8 * 3:], 0.0)
    np.testing.assert_array_equal(ns_t == 0.0, ns_j == 0.0)
    np.testing.assert_allclose(ns_t[:6], ns_j[:6], atol=1e-4)
    np.testing.assert_allclose(ns_t[6:], ns_j[6:], atol=1e-6)


def test_orthogonalize_matches():
    ba_j = _tiny_ba()
    ns_j = JE.get_nullspaces(ba_j)
    nsel_j = jnp.concatenate([ns_j[:6], ns_j[8:9]], axis=0)
    D = nsel_j.shape[1]
    rng = np.random.default_rng(1)
    H = rng.normal(size=(D, D)).astype(np.float32)
    H = H @ H.T
    b = rng.normal(size=D).astype(np.float32)
    b_j, H_j = JE.orthogonalize(jnp.asarray(b), jnp.asarray(H), nsel_j)
    ns_t = TE.get_nullspaces(port_state(TB.BAState, ba_j))
    nsel_t = t(np.concatenate([ns_t[:6].numpy(), ns_t[8:9].numpy()]))
    b_t, H_t = TE.orthogonalize(t(b), t(H), nsel_t)
    close(b_j, b_t, tol=1e-4)
    close(H_j, H_t, tol=1e-4)
    nsn = nsel_t.numpy() / np.linalg.norm(nsel_t.numpy(), axis=1,
                                          keepdims=True)
    assert np.abs(nsn @ b_t.numpy()).max() < 1e-3 * max(np.linalg.norm(b),
                                                         1.0)
    assert np.abs(nsn @ H_t.numpy() @ nsn.T).max() < 1e-2 * np.abs(H).max()
