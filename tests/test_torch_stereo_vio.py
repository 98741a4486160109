"""The slice: the port's stereo + spline-VIO FullSystem against the JAX
package.

Stereo + VIO: the scene and settings of tests/test_fused_vio.py (256x192,
20 frames, cubic trajectory with a gyro bias, F = 8, P = 512) go through
the JAX package's synchronous fused driver (fused_kf=True, pipeline=False)
and through the port on the CPU, fed the same pixels and IMU samples. The
port is held to the tolerances the JAX package applies between its own two
VIO drivers (tests/test_fused_vio.py): keyframe counts within 2, common
keyframes >= min - 2, positions within 2e-3, metric scale within 5%; and
to the metric ATE gate with no alignment.

The stereo-only run of the same comparison is tests/test_torch_stereo.py,
so that each file's JAX reference run keeps to its time."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

W, H = 256, 192
N_VIO, FRAME_DT = 20, 0.1


def _settings(mod, **kw):
    return mod.default_settings(
        max_window_frames=8, max_points=512, max_immature=1024,
        max_track_pts=4096, desired_point_density=400.0,
        desired_immature_density=400.0, scale_opt_thres=12.0, **kw)


def _render_right(poses, T_rl):
    """Right images of the JAX package's renderer at poses @ T_rl."""
    import jax.numpy as jnp
    from sos_slam_tpu.utils import synthetic as JSY
    calib = JSY.default_calib(W, H)
    return [np.asarray(JSY.render_plane(
        calib, jnp.asarray((p @ T_rl).astype(np.float32)), 2.0)[0])
        for p in poses]


def _run(FullSystem, StereoCalib, calib, settings, T_lr, left, right,
         imu=None, dt=0.05, **kw):
    fs = FullSystem(calib, settings,
                    stereo=StereoCalib(T_lr=T_lr, calib_right=calib), **kw)
    for i in range(len(left)):
        fs.add_active_frame(left[i], timestamp=i * dt, frame_id=i,
                            image_right=right[i],
                            imu_samples=None if imu is None else imu[i])
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    return fs


def _packages():
    from sos_slam_tpu.models.full_system import FullSystem as JFS
    from sos_slam_tpu.models.full_system import StereoCalib as JSC
    from sos_slam_tpu.utils import config as JC
    from sos_slam_tpu.utils import synthetic as JSY
    from sos_slam_tpu_torch.models.full_system import FullSystem as TFS
    from sos_slam_tpu_torch.models.full_system import StereoCalib as TSC
    from sos_slam_tpu_torch.utils import config as TC
    from sos_slam_tpu_torch.utils import synthetic as TSY
    return (JFS, JSC, JC, JSY), (TFS, TSC, TC, TSY)


@pytest.fixture(scope="module")
def vio_runs():
    import jax.numpy as jnp
    (JFS, JSC, JC, JSY), (TFS, TSC, TC, TSY) = _packages()
    T_lr, T_rl = TSY.stereo_T_lr()
    poses = np.stack([TSY.cubic_pose(i * FRAME_DT) for i in range(N_VIO)])
    calib_j = JSY.default_calib(W, H)
    left = [np.asarray(JSY.render_plane(calib_j, jnp.asarray(p), 2.0)[0])
            for p in poses]
    right = _render_right(poses, T_rl)
    imu = [TSY.imu_between(TSY.cubic_pose, TSY.cubic_acc,
                           (i - 1) * FRAME_DT, i * FRAME_DT,
                           TSY.CUBIC_BIAS_G) for i in range(N_VIO)]
    kw = dict(weight_imu_dso=6.0, min_g_imu=10)

    fs_j = JFS(calib_j, _settings(JC, **kw), stereo=JSC(
        T_lr=T_lr, calib_right=calib_j))
    fs_j.fused_kf, fs_j.pipeline = True, False
    for i in range(N_VIO):
        fs_j.add_active_frame(jnp.asarray(left[i]), timestamp=i * FRAME_DT,
                              frame_id=i, image_right=jnp.asarray(right[i]),
                              imu_samples=imu[i])
        if fs_j.is_lost or fs_j.init_failed:
            break
    fs_j.finish_pending()
    fs_t = _run(TFS, TSC, TSY.default_calib(W, H), _settings(TC, **kw),
                T_lr, left, right, imu, FRAME_DT, device="cpu")
    return fs_j, fs_t, poses


def _same_keyframes(fs_j, fs_t, tol):
    traj_j, traj_t = fs_j.trajectory(), fs_t.trajectory()
    ids_j = traj_j[:, 0].astype(int).tolist()
    ids_t = traj_t[:, 0].astype(int).tolist()
    assert abs(len(ids_j) - len(ids_t)) <= 2, (ids_j, ids_t)
    common = sorted(set(ids_j) & set(ids_t))
    assert len(common) >= min(len(ids_j), len(ids_t)) - 2
    pj = {int(r[0]): r[1:4] for r in traj_j}
    pt = {int(r[0]): r[1:4] for r in traj_t}
    d = np.array([np.linalg.norm(pj[i] - pt[i]) for i in common])
    assert d.max() < tol, d.max()


def _metric_gate(fs, poses, frac, const):
    from sos_slam_tpu_torch.utils.synthetic import metric_ate
    ate, path = metric_ate(fs.trajectory(scaled=True), poses)
    assert ate < frac * max(path, 1e-9) + const, (ate, path)


def test_stereo_vio_matches_jax(vio_runs):
    fs_j, fs_t, _ = vio_runs
    assert fs_j.imu_initialized and not fs_j.init_failed
    assert not fs_t.is_lost and not fs_t.init_failed
    _same_keyframes(fs_j, fs_t, 2e-3)
    from sos_slam_tpu_torch.models import imu as IM
    s_j = float(fs_j.imu.scale) * IM.SCALE_SCALE
    s_t = float(fs_t.imu.scale) * IM.SCALE_SCALE
    assert abs(s_j - s_t) / s_j < 0.05, (s_j, s_t)


def test_stereo_vio_metric_trajectory(vio_runs):
    """The port's flagship path ran: IMU initialized, the stereo scale
    trapped, the fused VIO chain ran (the only writer of the host gyro
    bias), and the SCALED trajectory is metric with no alignment."""
    _, fs, poses = vio_runs
    assert fs.imu_initialized and fs.scale_trapped
    assert fs._last_bg is not None
    _metric_gate(fs, poses, 0.15, 0.03)
