"""The port's monocular initializer against the JAX package on the same
frames: the same selected points and graph, and the same bootstrap
outcome (snap frame, pose, depths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.models import initializer as JCI
from sos_slam_tpu.ops import image as JI
from sos_slam_tpu.utils import synthetic as JSY
from sos_slam_tpu_torch.models import initializer as TCI
from sos_slam_tpu_torch.ops import image as TI
from sos_slam_tpu_torch.utils import rng
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import close, exact, port_state, scene_images, t

S = default_settings()
W, H = 256, 192
N = 10


@pytest.fixture(scope="module")
def frames():
    imgs, _ = scene_images(W, H, N, [0.045, 0.015, 0.01, 0.002, 0.004, 0.001])
    calib = JSY.default_calib(W, H)
    pj = [JI.build_pyramid(jnp.asarray(im), calib.levels) for im in imgs]
    pt = [TI.build_pyramid(t(im), calib.levels) for im in imgs]
    return calib, pj, pt


def _near_same(picked_j, picked_t, qu, qv, tu, tv):
    """Both packages picked equally near points, slot by slot."""
    a, b = np.asarray(picked_j), picked_t.numpy()
    exact(a < 0, b < 0)
    qu, qv, tu, tv = (np.asarray(x) for x in (qu, qv, tu, tv))

    def dist(ix):
        ix = np.maximum(ix, 0)
        return (qu[:, None] - tu[ix]) ** 2 + (qv[:, None] - tv[ix]) ** 2
    np.testing.assert_allclose(dist(a), dist(b), rtol=1e-5, atol=1e-4)


def test_set_first_same_points_and_graph(frames):
    calib, pj, pt = frames
    sj = JCI.set_first(pj[0][0], pj[0][1], calib, S, jax.random.PRNGKey(0))
    st = TCI.set_first(pt[0][0], pt[0][1], calib, S, rng.PRNGKey(0))
    n = len(sj.levels)
    for i, (lj, lt) in enumerate(zip(sj.levels, st.levels)):
        exact(lj.valid, lt.valid)
        close(lj.u, lt.u)
        close(lj.v, lt.v)
        # XLA:CPU contracts dx*dx + dy*dy into one FMA, so points at equal
        # distance may rank differently: compare the picked distances
        _near_same(lj.nn, lt.nn, lj.u, lj.v, lj.u, lj.v)
        up = sj.levels[min(i + 1, n - 1)]
        _near_same(lj.parent[:, None], lt.parent[:, None], lj.u * 0.5,
                   lj.v * 0.5, up.u, up.v)


def test_bootstrap_matches(frames):
    calib, pj, pt = frames
    sj = JCI.set_first(pj[0][0], pj[0][1], calib, S, jax.random.PRNGKey(0))
    st = port_state(TCI.InitState, sj)
    done_j = done_t = False
    for i in range(1, N):
        sj, done_j = JCI.track_frame(sj, pj[0][0], pj[i][0], calib, S)
        st, done_t = TCI.track_frame(st, pt[0][0], pt[i][0], calib, S)
        assert done_j == done_t, i
        assert bool(sj.snapped) == bool(st.snapped), i
        close(sj.T, st.T, tol=2e-3)
        if done_j:
            break
    assert done_j
    lj, lt = sj.levels[0], st.levels[0]
    good = np.asarray(lj.is_good & lj.valid)
    assert good.sum() > 200
    agree = np.mean(good == (lt.is_good & lt.valid).numpy())
    assert agree > 0.99, agree
    both = good & (lt.is_good & lt.valid).numpy()
    close(np.asarray(lj.iR)[both], lt.iR.numpy()[both], tol=2e-2)
