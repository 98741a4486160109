"""The port's pipelined fused driver (FullSystem.pipeline) against its own
synchronous path: tests/test_pipeline.py on the port.

Frames in flight dispatch from the records of the frames before them (the
chained device state and next-frame inputs), so a pipelined run computes
what the synchronous one does; pipelining changes only when the host
completes a frame. So the trajectories, the window state and the IMU
prior must match bit for bit, at depth 1 and 3, mono (the scene and
settings of tests/test_pipeline.py: 256x192, 28 frames) and stereo + VIO
(tests/test_torch_stereo_vio.py's scene: 20 frames of the cubic
trajectory with a gyro bias). Parity with the JAX package comes through
the synchronous path's own tests."""

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models.full_system import FullSystem, StereoCalib
from sos_slam_tpu_torch.utils import synthetic
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import exact

torch.set_num_threads(2)

W, H = 256, 192
N_FRAMES = 28
TWIST = (0.05, 0.02, 0.03, 0.003, 0.006, 0.002)
N_VIO, FRAME_DT = 20, 0.1


def _settings(**kw):
    return default_settings(
        max_window_frames=8, max_points=512, max_immature=1024,
        max_track_pts=4096, desired_point_density=400.0,
        desired_immature_density=400.0, **kw)


def _mono(depth):
    """The mono scene through a FullSystem at `depth` (0: synchronous).
    Returns (fs, ground-truth poses, the most frames seen in flight)."""
    calib = synthetic.default_calib(W, H)
    imgs, _, poses = synthetic.make_sequence(calib, N_FRAMES, TWIST,
                                             plane_z=2.0, device="cpu")
    fs = FullSystem(calib, _settings(), device="cpu")
    fs.pipeline, fs.pipeline_depth = depth > 0, depth
    most = 0
    for i in range(N_FRAMES):
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        most = max(most, len(fs._pending_fused))
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    return fs, poses.numpy(), most


@pytest.fixture(scope="module")
def mono():
    return {d: _mono(d) for d in (0, 1, 3)}


def _assert_bitwise_equal(fs_s, fs_p):
    traj_s, traj_p = fs_s.trajectory(), fs_p.trajectory()
    assert traj_s[:, 0].astype(int).tolist() == \
        traj_p[:, 0].astype(int).tolist(), "keyframe sets differ"
    exact(traj_s[:, 1:4], traj_p[:, 1:4])
    exact(fs_s.ba.state, fs_p.ba.state)
    exact(fs_s.ba.pt_valid, fs_p.ba.pt_valid)


@pytest.mark.parametrize("depth", [1, 3])
def test_pipelined_bitwise_matches_sync(mono, depth):
    fs_s, _, _ = mono[0]
    fs_p, _, most = mono[depth]
    assert not fs_p.is_lost and not fs_p.init_failed
    assert fs_p.initialized
    assert most == depth, most            # frames really were in flight
    assert len(fs_p._pending_fused) == 0  # finish_pending drained them
    _assert_bitwise_equal(fs_s, fs_p)
    exact(fs_s.imm.valid, fs_p.imm.valid)


def test_pipelined_accuracy(mono):
    fs_p, poses, _ = mono[3]
    traj = fs_p.trajectory()
    ids = traj[:, 0].astype(int)
    est, gt = traj[:, 1:4], poses[ids, :3, 3]
    en, gn = np.linalg.norm(est, axis=1), np.linalg.norm(gt, axis=1)
    nz = gn > 1e-6
    scale = np.median(en[nz] / gn[nz]) if nz.any() else 1.0
    ate = np.sqrt(np.mean(
        np.linalg.norm(est / max(scale, 1e-9) - gt, axis=1) ** 2))
    path = np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))
    assert ate < 0.05 * max(path, 1e-9) + 0.01, (ate, path)


def _vio(depth, scene):
    calib = synthetic.default_calib(W, H)
    fs = FullSystem(calib, _settings(scale_opt_thres=12.0,
                                     weight_imu_dso=6.0, min_g_imu=10),
                    stereo=StereoCalib(T_lr=scene["T_lr"],
                                       calib_right=calib), device="cpu")
    fs.pipeline, fs.pipeline_depth = depth > 0, depth
    most = 0
    for i in range(N_VIO):
        fs.add_active_frame(scene["left"][i], timestamp=i * FRAME_DT,
                            frame_id=i, image_right=scene["right"][i],
                            imu_samples=scene["imu"][i])
        most = max(most, len(fs._pending_fused))
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    return fs, most


def test_stereo_vio_pipelined_bitwise_matches_sync():
    scene = synthetic.stereo_vio_scene(
        synthetic.default_calib(W, H), N_VIO, FRAME_DT, synthetic.cubic_pose,
        synthetic.cubic_acc, bias_g=synthetic.CUBIC_BIAS_G, device="cpu")
    fs_s, _ = _vio(0, scene)
    fs_p, most = _vio(3, scene)
    assert fs_p.imu_initialized and fs_p.scale_trapped
    assert not fs_p.is_lost and not fs_p.init_failed
    assert most == 3, most
    _assert_bitwise_equal(fs_s, fs_p)
    exact(fs_s.trajectory(scaled=True), fs_p.trajectory(scaled=True))
    exact(fs_s.imu.HM, fs_p.imu.HM)
    exact(fs_s.imu.state, fs_p.imu.state)
    assert [q[0] for q in fs_s.imu_queue] == [q[0] for q in fs_p.imu_queue]
    exact(fs_s._last_bg, fs_p._last_bg)


def test_imu_staging_leaves_out_the_keyframe_in_flight():
    """With a keyframe in flight the host queue still holds the samples
    its chain consumed; the next frame's staged block leaves them out
    exactly as the completion's reconciliation does (`q[0] > t_kf`, in
    float64), also the sample at the keyframe's own time: at t_kf = 2.6,
    t = 2.9 an f32 mask keeps it (the flagship scene at 640x480)."""
    from sos_slam_tpu_torch.models.full_system import FrameShell
    fs = FullSystem(synthetic.default_calib(W, H),
                    _settings(weight_imu_dso=6.0, min_g_imu=10),
                    device="cpu")
    r = np.random.RandomState(0)
    queue = [(k / 200.0, r.randn(3).astype(np.float32),
              r.randn(3).astype(np.float32)) for k in range(460, 601)]
    shell = FrameShell(id=29, timestamp=2.9, cam_to_world=np.eye(4),
                       aff=np.zeros(2))
    fs.imu_queue = queue
    staged = fs._stage_imu(shell, 2.6)
    fs.imu_queue = [q for q in queue if q[0] > 2.6]     # reconciled
    reconciled = fs._stage_imu(shell, float("-inf"))
    assert 2.6 in [q[0] for q in queue]
    assert int(staged["valid"].sum()) == 60
    for k in ("acc", "gyro", "ts", "valid"):
        exact(staged[k], reconciled[k])
