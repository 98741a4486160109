"""K1 and the bilinear samplers of the port against the JAX package.

K1's plain twin is held against the TPU kernel in interpret mode
(pallas_kernels.fused_pyramid_level) and against build_pyramid; the
samplers (including the BiLin forward-difference gradients) against
sos_slam_tpu.ops.image."""

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
