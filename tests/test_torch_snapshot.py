"""The port's snapshots (models/snapshot.py): a resumed port run against the
uninterrupted one, and snapshots carried between the port and the JAX
package in both directions.

The scenario of tests/test_snapshot.py: 256x192, 18 frames of the
constant-twist plane, a snapshot after frame 12, both systems continuing.
Held:
  (a) a port snapshot resumed in the port gives the uninterrupted run bit
      for bit (trajectory and window state); the same snapshot without its
      `port.*` entries (the JAX layout alone: the tracker template rebuilt
      from the restored window, a fresh random key, no chained inputs)
      continues within 5e-3, tests/test_snapshot.py's tolerance;
  (b) a JAX snapshot loaded into the port continues like the JAX package
      resuming the same snapshot, at the tolerance tests/
      test_torch_full_system.py applies between the two packages (keyframe
      counts within 2, common keyframes >= min - 2, positions within 1e-3);
  (c) a port snapshot loads into the JAX package with the same keyframe
      count, live points and window arrays."""

import os

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models import snapshot as TSNAP
from tests.test_torch_helpers import exact, scene_images

torch.set_num_threads(2)

W, H, N, AT = 256, 192, 18, 12
TWIST = [0.05, 0.02, 0.03, 0.003, 0.006, 0.002]


def _settings(mod):
    return mod.default_settings(
        max_window_frames=8, max_points=512, max_immature=1024,
        max_track_pts=4096, desired_point_density=400.0,
        desired_immature_density=400.0)


def _feed(fs, imgs, frames, drain=True):
    """Feed `frames`; then, with `drain`, complete the frames in flight."""
    for i in frames:
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
    if drain:
        fs.finish_pending()


def _port():
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import config, synthetic
    return FullSystem(synthetic.default_calib(W, H), _settings(config),
                      device="cpu")


def _jax():
    from sos_slam_tpu.models.full_system import FullSystem
    from sos_slam_tpu.utils import config, synthetic
    return FullSystem(synthetic.default_calib(W, H), _settings(config))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp
    from sos_slam_tpu.models import snapshot as JSNAP
    tmp = tmp_path_factory.mktemp("snap")
    imgs, _ = scene_images(W, H, N, TWIST)
    port_path, jax_path = str(tmp / "port.npz"), str(tmp / "jax.npz")

    fs = _port()
    _feed(fs, imgs, range(AT))
    TSNAP.save_snapshot(fs, port_path)
    at_save = dict(n_kf=fs.stats["n_kf"],
                   ba={k: v.clone() for k, v in fs.ba._asdict().items()})
    _feed(fs, imgs, range(AT, N))

    jimgs = [jnp.asarray(im) for im in imgs]
    fj = _jax()
    _feed(fj, jimgs, range(AT))
    JSNAP.save_snapshot(fj, jax_path)
    fj_resumed = JSNAP.load_snapshot(_jax(), jax_path)
    _feed(fj_resumed, jimgs, range(AT, N))
    return dict(imgs=imgs, fs=fs, at_save=at_save, port_path=port_path,
                jax_path=jax_path, fj_resumed=fj_resumed, tmp=tmp)


def test_port_resume_is_bitwise(runs):
    fs2 = TSNAP.load_snapshot(_port(), runs["port_path"])
    assert fs2.initialized and fs2.stats["n_kf"] == runs["at_save"]["n_kf"]
    _feed(fs2, runs["imgs"], range(AT, N))
    fs = runs["fs"]
    assert not fs2.is_lost
    exact(fs.trajectory(), fs2.trajectory())
    for k, v in fs.ba._asdict().items():
        exact(v, getattr(fs2.ba, k))
    for k, v in fs.imm._asdict().items():
        exact(v, getattr(fs2.imm, k))
    exact(fs.dI, fs2.dI)


def test_port_resume_from_the_jax_layout(runs):
    """The port's snapshot with only the entries the JAX package writes."""
    with np.load(runs["port_path"]) as data:
        kept = {k: data[k] for k in data.files
                if not k.startswith(TSNAP.PORT)}
        assert len(kept) < len(data.files) and "host_json" in kept
    path = os.path.join(runs["tmp"], "jax_layout.npz")
    np.savez_compressed(path, **kept)
    fs2 = TSNAP.load_snapshot(_port(), path)
    _feed(fs2, runs["imgs"], range(AT, N))
    assert not fs2.is_lost
    t1, t2 = runs["fs"].trajectory(), fs2.trajectory()
    assert t1.shape == t2.shape
    np.testing.assert_allclose(t1, t2, atol=5e-3)


def test_jax_snapshot_resumes_in_the_port(runs):
    ft = TSNAP.load_snapshot(_port(), runs["jax_path"])
    fj = runs["fj_resumed"]
    _feed(ft, runs["imgs"], range(AT, N))
    assert ft.initialized and not ft.is_lost
    traj_j, traj_t = fj.trajectory(), ft.trajectory()
    ids_j = traj_j[:, 0].astype(int).tolist()
    ids_t = traj_t[:, 0].astype(int).tolist()
    assert abs(len(ids_j) - len(ids_t)) <= 2, (ids_j, ids_t)
    common = sorted(set(ids_j) & set(ids_t))
    assert len(common) >= min(len(ids_j), len(ids_t)) - 2
    pj = {int(r[0]): r[1:4] for r in traj_j}
    pt = {int(r[0]): r[1:4] for r in traj_t}
    d = np.array([np.linalg.norm(pj[i] - pt[i]) for i in common])
    assert d.max() < 1e-3, d.max()


def test_port_snapshot_loads_in_jax(runs):
    from sos_slam_tpu.models import snapshot as JSNAP
    fj = JSNAP.load_snapshot(_jax(), runs["port_path"])
    saved = runs["at_save"]
    assert fj.initialized and fj.stats["n_kf"] == saved["n_kf"]
    assert int(np.asarray(fj.ba.pt_valid).sum()) \
        == int(saved["ba"]["pt_valid"].sum())
    for k, v in saved["ba"].items():
        exact(np.asarray(getattr(fj.ba, k)), v)
    ft = TSNAP.load_snapshot(_port(), runs["port_path"])
    for k, v in ft.imm._asdict().items():
        exact(np.asarray(getattr(fj.imm, k)), v)
    exact(np.asarray(fj.dI), ft.dI)
    exact(np.asarray(fj.HdiF), ft.HdiF)
    assert fj.kf_shell_ids == ft.kf_shell_ids
    assert fj.frame_shell_idx == ft.frame_shell_idx


def test_vio_state_round_trip(tmp_path):
    """A stereo + VIO system's own state through a port snapshot: the
    ImuState fields, the host IMU queue (float32 samples stay float32) and
    the gyro-bias copy come back exactly, dtypes included."""
    from sos_slam_tpu_torch.models import imu as IM
    from sos_slam_tpu_torch.models.full_system import FullSystem, \
        StereoCalib
    from sos_slam_tpu_torch.utils import config, convert, synthetic
    calib = synthetic.default_calib(128, 96)
    settings = config.default_settings(weight_imu_dso=6.0,
                                       scale_opt_thres=12.0)

    def system():
        return FullSystem(calib, settings, stereo=StereoCalib(
            T_lr=synthetic.stereo_T_lr()[0], calib_right=calib),
            device="cpu")

    fs = system()
    r = np.random.RandomState(8)
    arrays = {k: np.asarray(r.randn(*v.shape) * 10).astype(v.dtype)
              if v.dtype.kind == "f" else v
              for k, v in convert.to_numpy(fs.imu).items()}
    arrays["spline_valid"] = r.rand(fs.F) < 0.5
    fs.imu = convert.from_numpy(IM.ImuState, arrays, "cpu")
    fs.imu_queue = synthetic.imu_between(synthetic.sine_pose,
                                         synthetic.sine_acc, 0.0, 0.1)
    fs._last_bg = r.randn(3)
    path = str(tmp_path / "vio.npz")
    TSNAP.save_snapshot(fs, path)
    fl = TSNAP.load_snapshot(system(), path)
    for k, v in fs.imu._asdict().items():
        assert getattr(fl.imu, k).dtype == v.dtype
        exact(getattr(fl.imu, k), v)
    assert len(fl.imu_queue) == len(fs.imu_queue) == 20
    for (t0, a0, g0), (t1, a1, g1) in zip(fs.imu_queue, fl.imu_queue):
        assert t0 == t1 and a1.dtype == a0.dtype and g1.dtype == g0.dtype
        exact(a0, a1)
        exact(g0, g1)
    exact(fs._last_bg, fl._last_bg)


def test_snapshot_with_frames_in_flight_resumes_bitwise(runs, tmp_path):
    """A snapshot saved while the pipelined driver has frames in flight:
    saving completes them, and the resumed run (chained from the last
    completed frame's record) gives the uninterrupted pipelined run bit
    for bit, drained at the end."""
    imgs = runs["imgs"]
    fs = _port()
    _feed(fs, imgs, range(N))

    half = _port()
    _feed(half, imgs, range(AT), drain=False)
    assert len(half._pending_fused) == half.pipeline_depth
    path = str(tmp_path / "in_flight.npz")
    TSNAP.save_snapshot(half, path)
    assert len(half._pending_fused) == 0
    fs2 = TSNAP.load_snapshot(_port(), path)
    assert fs2._last_chain["shell"].id == AT - 1
    _feed(fs2, imgs, range(AT, N))
    assert not fs2.is_lost
    exact(fs.trajectory(), fs2.trajectory())
    for k, v in fs.ba._asdict().items():
        exact(v, getattr(fs2.ba, k))
    for k, v in fs.imm._asdict().items():
        exact(v, getattr(fs2.imm, k))
    exact(fs.dI, fs2.dI)
