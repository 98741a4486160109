"""The port's pixel selector against sos_slam_tpu.ops.selector: the same
key picks the same pixels (the threefry twin makes the draws equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.ops import image as JI
from sos_slam_tpu.ops import selector as JS
from sos_slam_tpu_torch.ops import image as TI
from sos_slam_tpu_torch.ops import selector as TS
from sos_slam_tpu_torch.utils import rng
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import close, exact, scene_images, t

S = default_settings()


@pytest.fixture(scope="module")
def frame():
    imgs, _ = scene_images(256, 192, 1, [0.0] * 6)
    img = imgs[0]
    pj, aj = JI.build_pyramid(jnp.asarray(img), 4)
    pt, at = TI.build_pyramid(t(img), 4)
    return pj, aj, pt, at


def test_block_thresholds_exact(frame):
    pj, aj, pt, at = frame
    exact(JS.block_thresholds(aj[0], S.min_grad_hist_cut, S.min_grad_hist_add),
          TS.block_thresholds(at[0], S.min_grad_hist_cut, S.min_grad_hist_add))


@pytest.mark.parametrize("pot", [1, 3, 6])
def test_select_same_pixels(frame, pot):
    pj, aj, pt, at = frame
    ths_j = JS.block_thresholds(aj[0], S.min_grad_hist_cut,
                                S.min_grad_hist_add)
    ths_t = TS.block_thresholds(at[0], S.min_grad_hist_cut,
                                S.min_grad_hist_add)
    key = jax.random.fold_in(jax.random.PRNGKey(7), pot)
    kk = rng.fold_in(rng.PRNGKey(7), pot)
    sj, scj = JS.select(pj[0], aj[0], aj[1], aj[2], ths_j, pot, 2.0,
                        S.grad_downweight_per_level, key)
    st, sct = TS.select(pt[0], at[0], at[1], at[2], ths_t, pot, 2.0,
                        S.grad_downweight_per_level, kk)
    exact(sj, st)
    close(scj, sct)
    uj, vj, mj = JS.extract_points(sj, 1024)
    ut, vt, mt = TS.extract_points(st, 1024)
    exact(uj, ut)
    exact(vj, vt)
    exact(mj, mt)


def test_make_maps_and_pixel_status(frame):
    pj, aj, pt, at = frame
    a = JS.make_maps(pj[0], aj, S, 1500.0, jax.random.PRNGKey(3))
    b = TS.make_maps(pt[0], at, S, 1500.0, rng.PRNGKey(3))
    exact(a[0], b[0])
    assert a[1:] == b[1:]
    for lvl in (1, 2):
        mj, nj = JS.make_pixel_status(pj[lvl], 400.0)
        mt, nt = TS.make_pixel_status(pt[lvl], 400.0)
        exact(mj, mt)
        assert nj == nt


def test_compact_indices_and_ladder():
    r = np.random.RandomState(0)
    for frac in (0.0, 0.1, 0.9, 1.0):
        m = r.rand(300) < frac
        ij, oj = JS.compact_mask_indices(jnp.asarray(m), 128)
        it, ot = TS.compact_mask_indices(t(m), 128)
        exact(ij, it)
        exact(oj, ot)
    for p in range(1, 20):
        assert JS._snap_pot(p) == TS._snap_pot(p)
        for up in (False, True):
            assert JS.pot_step(p, up) == TS.pot_step(p, up)
