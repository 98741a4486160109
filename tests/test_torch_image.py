"""K1 and the bilinear samplers of the port against the JAX package.

K1's plain twin is held against the TPU kernel in interpret mode
(pallas_kernels.fused_pyramid_level; all levels of a frame against
build_pyramid_pallas) and against build_pyramid; the samplers (including
the BiLin forward-difference gradients) against sos_slam_tpu.ops.image."""

import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.ops import image as JI
from sos_slam_tpu.ops import pallas_kernels as PK
from sos_slam_tpu_torch.ops import image as TI
from tests.test_torch_helpers import close, exact, t


def _img(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w) * 255.0).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 96), (60, 80), (48, 64)])
def test_k1_plain_matches_pallas_interpret(hw):
    img = _img(hw[0], *hw)
    dI_j, asg_j, down_j = PK.fused_pyramid_level(jnp.asarray(img),
                                                 interpret=True)
    dI_t, asg_t, down_t = TI.pyramid_level(t(img))
    close(dI_j, dI_t)
    close(asg_j, asg_t)
    close(down_j, down_t)
    # dx is zero on the first/last row and both border columns, dy on the
    # first/last row
    dI_t = dI_t.numpy()
    assert not dI_t[0, :, 1:].any() and not dI_t[-1, :, 1:].any()
    assert not dI_t[:, 0, 1].any() and not dI_t[:, -1, 1].any()


def test_build_pyramid_matches():
    img = _img(7, 192, 256)
    lv_j, ag_j = JI.build_pyramid(jnp.asarray(img), 4)
    lv_t, ag_t = TI.build_pyramid(t(img), 4)
    for a, b in zip(lv_j, lv_t):
        close(a, b)
    for a, b in zip(ag_j, ag_t):
        close(a, b)


@pytest.mark.parametrize("n_levels", [1, 3, 4])
def test_pyramid_levels_matches_pallas_interpret(n_levels):
    """All levels in one call against the TPU kernel chained over the
    levels (interpret mode) and against the JAX package's XLA form."""
    img = _img(11 + n_levels, 96, 128)
    lv_t, ag_t = TI.pyramid_levels(t(img), n_levels)
    assert len(lv_t) == len(ag_t) == n_levels
    for ref in (PK.build_pyramid_pallas(jnp.asarray(img), n_levels,
                                        interpret=True),
                JI.build_pyramid(jnp.asarray(img), n_levels)):
        for lvl, (a, b) in enumerate(zip(ref[0], lv_t)):
            assert b.shape == (96 >> lvl, 128 >> lvl, 3)
            close(a, b)
        for a, b in zip(ref[1], ag_t):
            close(a, b)
    # build_pyramid is that call
    for a, b in zip(TI.build_pyramid(t(img), n_levels)[0], lv_t):
        exact(a, b)


@pytest.mark.parametrize("hw,n_levels", [((60, 80), 4), ((64, 100), 4),
                                         ((24, 64), 4), ((48, 64), 0),
                                         ((3, 64), 1)])
def test_pyramid_levels_rejects_bad_dims(hw, n_levels):
    """Dims that do not halve n_levels-1 times, a last level under 4
    pixels a side, no level at all."""
    with pytest.raises(ValueError):
        TI.pyramid_levels(t(_img(1, *hw)), n_levels)
    with pytest.raises(ValueError):
        TI.build_pyramid(t(_img(1, *hw)), n_levels)


def test_pyramid_level_rejects_odd_dims():
    with pytest.raises(ValueError):
        TI.pyramid_level(t(_img(1, 63, 64)))
    with pytest.raises(ValueError):
        TI.pyramid_levels(t(_img(1, 64, 64)).double(), 2)


def _coords(seed, n, w, h, shape):
    r = np.random.RandomState(seed)
    u = (r.rand(*shape) * (w + 6) - 3).astype(np.float32)
    v = (r.rand(*shape) * (h + 6) - 3).astype(np.float32)
    return u, v


def test_interp_bilinear_and_blin():
    img = _img(3, 48, 64)
    lv_j, _ = JI.build_pyramid(jnp.asarray(img), 1)
    dI = np.asarray(lv_j[0])
    u, v = _coords(1, 0, 64, 48, (50, 8))
    close(JI.interp_bilinear(jnp.asarray(dI), jnp.asarray(u), jnp.asarray(v)),
          TI.interp_bilinear(t(dI), t(u), t(v)))
    close(JI.interp_bilinear(jnp.asarray(img), jnp.asarray(u),
                             jnp.asarray(v)),
          TI.interp_bilinear(t(img), t(u), t(v)))
    close(JI.interp_bilinear_blin(jnp.asarray(img), jnp.asarray(u),
                                  jnp.asarray(v)),
          TI.interp_bilinear_blin(t(img), t(u), t(v)))


def test_interp_frames_and_in_bounds():
    F, H, W = 3, 40, 56
    dI = np.random.RandomState(4).rand(F, H, W, 3).astype(np.float32)
    u, v = _coords(2, 0, W, H, (20, F, 8))
    close(JI.interp_bilinear_frames(jnp.asarray(dI), jnp.asarray(u),
                                    jnp.asarray(v)),
          TI.interp_bilinear_frames(t(dI), t(u), t(v)))
    exact(JI.in_bounds(jnp.asarray(u), jnp.asarray(v), W, H),
          TI.in_bounds(t(u), t(v), W, H))
    close(JI.downsample2x(jnp.asarray(dI[0, ..., 0])),
          TI.downsample2x(t(dI[0, ..., 0])))


def test_nan_coordinates_gather_corner_zero():
    """XLA converts NaN coordinates to corner index 0; the port matches."""
    img = _img(5, 16, 16)
    u = np.array([np.nan, 3.5], np.float32)
    v = np.array([2.0, np.nan], np.float32)
    a = np.asarray(JI.interp_bilinear(jnp.asarray(img), jnp.asarray(u),
                                      jnp.asarray(v)))
    b = TI.interp_bilinear(t(img), t(u), t(v)).numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))


@pytest.mark.parametrize("xi", [(0.0,) * 6, (0.05, -0.02, 0.1, 0.01, -0.02,
                                              0.005)])
def test_render_two_planes_matches(xi):
    from sos_slam_tpu.utils import lie as JL
    from sos_slam_tpu.utils import synthetic as JS
    from sos_slam_tpu_torch.utils import synthetic as TS
    T = np.asarray(JL.se3_exp(jnp.asarray(xi, jnp.float32)))
    img_j, idp_j = JS.render_two_planes(JS.default_calib(128, 96),
                                        jnp.asarray(T))
    img_t, idp_t = TS.render_two_planes(TS.default_calib(128, 96), t(T))
    close(img_j, img_t, tol=1e-5)
    close(idp_j, idp_t, tol=1e-5)
