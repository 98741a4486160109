"""The port's stereo-only FullSystem against the JAX package.

The scene of tests/test_stereo_system.py (256x192, 24 frames, constant
twist, right camera at +0.11 m, the settings of
tests/test_torch_stereo_vio.py without the IMU) through the JAX package
and the port on the CPU, fed the same pixels: keyframe counts within 2,
common keyframes >= min - 2, positions within 1e-3 (as
tests/test_torch_full_system.py), the trapped scale within 5%, and the
port's scaled trajectory metric with no alignment
(tests/test_stereo_system.py's gate)."""

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_helpers import scene_images
from tests.test_torch_stereo_vio import (_metric_gate, _packages,
                                         _render_right, _run,
                                         _same_keyframes, _settings)

torch.set_num_threads(2)

W, H = 256, 192
N_STEREO = 24
TWIST = [0.05, 0.02, 0.03, 0.003, 0.006, 0.002]


@pytest.fixture(scope="module")
def stereo_runs():
    (JFS, JSC, JC, JSY), (TFS, TSC, TC, TSY) = _packages()
    T_lr, T_rl = TSY.stereo_T_lr()
    left, poses = scene_images(W, H, N_STEREO, TWIST)
    right = _render_right(poses, T_rl)
    calib_j = JSY.default_calib(W, H)
    fs_j = _run(JFS, JSC, calib_j, _settings(JC), T_lr,
                [jnp.asarray(im) for im in left],
                [jnp.asarray(im) for im in right])
    fs_t = _run(TFS, TSC, TSY.default_calib(W, H), _settings(TC), T_lr,
                left, right, device="cpu")
    return fs_j, fs_t, poses


def test_stereo_matches_jax(stereo_runs):
    fs_j, fs_t, _ = stereo_runs
    assert not fs_t.is_lost and not fs_t.init_failed
    _same_keyframes(fs_j, fs_t, 1e-3)
    assert abs(fs_j.current_scale - fs_t.current_scale) \
        / fs_j.current_scale < 0.05, (fs_j.current_scale,
                                      fs_t.current_scale)


def test_stereo_metric_trajectory(stereo_runs):
    """tests/test_stereo_system.py's gates on the port: the scale trapped,
    at least 3 keyframes, metric with no alignment."""
    _, fs, poses = stereo_runs
    assert fs.scale_trapped
    assert sum(sh.is_kf for sh in fs.shells) >= 3
    _metric_gate(fs, poses, 0.07, 0.01)
