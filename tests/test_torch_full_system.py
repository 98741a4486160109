"""The slice: the port's monocular FullSystem against the JAX package.

The scene and settings of tests/test_fused_kf.py (256x192, 28 frames) go
through both packages on the CPU, fed the same pixels. The comparison is
the one test_fused_kf.py applies between the JAX package's own two
drivers: keyframe counts within 2, common keyframe ids >= min - 2, and
positions on the common set within 1e-3; plus the ATE gate."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.test_torch_helpers import scene_images

W, H = 256, 192
N_FRAMES = 28
TWIST = [0.05, 0.02, 0.03, 0.003, 0.006, 0.002]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _settings(mod):
    return mod.default_settings(
        max_window_frames=8, max_points=512, max_immature=1024,
        max_track_pts=4096, desired_point_density=400.0,
        desired_immature_density=400.0)


def _run(FullSystem, calib, settings, imgs, **kw):
    fs = FullSystem(calib, settings, **kw)
    for i in range(len(imgs)):
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    return fs


@pytest.fixture(scope="module")
def runs():
    import jax.numpy as jnp
    from sos_slam_tpu.models.full_system import FullSystem as JFS
    from sos_slam_tpu.utils import config as JC
    from sos_slam_tpu.utils import synthetic as JSY
    from sos_slam_tpu_torch.models.full_system import FullSystem as TFS
    from sos_slam_tpu_torch.utils import config as TC
    from sos_slam_tpu_torch.utils import synthetic as TSY

    imgs, poses = scene_images(W, H, N_FRAMES, TWIST)
    fs_j = _run(JFS, JSY.default_calib(W, H), _settings(JC),
                [jnp.asarray(im) for im in imgs])
    fs_t = _run(TFS, TSY.default_calib(W, H), _settings(TC), imgs,
                device="cpu")
    return fs_j, fs_t, poses


def test_slice_matches_jax(runs):
    fs_j, fs_t, _ = runs
    assert fs_t.initialized and not fs_t.is_lost and not fs_t.init_failed
    traj_j, traj_t = fs_j.trajectory(), fs_t.trajectory()
    ids_j = traj_j[:, 0].astype(int).tolist()
    ids_t = traj_t[:, 0].astype(int).tolist()
    assert abs(len(ids_j) - len(ids_t)) <= 2, (ids_j, ids_t)
    common = sorted(set(ids_j) & set(ids_t))
    assert len(common) >= min(len(ids_j), len(ids_t)) - 2
    pj = {int(r[0]): r[1:4] for r in traj_j}
    pt = {int(r[0]): r[1:4] for r in traj_t}
    d = np.array([np.linalg.norm(pj[i] - pt[i]) for i in common])
    assert d.max() < 1e-3, d.max()


def test_slice_ate_gate(runs):
    _, fs, poses = runs
    traj = fs.trajectory()
    ids = traj[:, 0].astype(int)
    est, gt = traj[:, 1:4], poses[ids, :3, 3]
    en, gn = np.linalg.norm(est, axis=1), np.linalg.norm(gt, axis=1)
    nz = gn > 1e-6
    scale = np.median(en[nz] / gn[nz]) if nz.any() else 1.0
    ate = np.sqrt(np.mean(
        np.linalg.norm(est / max(scale, 1e-9) - gt, axis=1) ** 2))
    path = np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))
    assert ate < 0.05 * max(path, 1e-9) + 0.01, (ate, path)


def test_port_imports_no_jax_and_runs():
    """Every port module imports with JAX and the JAX package made
    unimportable, and three frames run on the CPU."""
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["sos_slam_tpu"] = None
        import importlib, sos_slam_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            sos_slam_tpu_torch.__path__, "sos_slam_tpu_torch.")]
        for m in names:
            importlib.import_module(m)
        want = {"sos_slam_tpu_torch.__main__"} | {
            f"sos_slam_tpu_torch.loop.{m}" for m in (
                "scancontext", "pose_estimator", "pose_graph", "handler")} | {
            f"sos_slam_tpu_torch.io.{m}" for m in (
                "undistort", "output_wrapper", "launch", "datasets", "node",
                "run_synthetic", "png", "viewer", "debug_plot")} | {
            "sos_slam_tpu_torch.models.snapshot",
            "sos_slam_tpu_torch.utils.evaluate"} | {
            f"sos_slam_tpu_torch.parallel.{m}" for m in (
                "comm", "sharded", "dryrun")}
        assert want <= set(names), want - set(names)
        # a GPU host need have no imaging package: importing the port
        # (the viewer and the debug plots included) pulls in none
        assert not {"imageio", "PIL", "matplotlib"} & set(sys.modules)
        import torch
        torch.set_num_threads(2)
        from sos_slam_tpu_torch.models.full_system import FullSystem
        from sos_slam_tpu_torch.utils import synthetic
        from sos_slam_tpu_torch.utils.config import default_settings
        calib = synthetic.default_calib(128, 96)
        imgs, _, _ = synthetic.make_sequence(calib, 3, device="cpu")
        fs = FullSystem(calib, default_settings(max_points=256,
                        max_immature=256, max_track_pts=1024),
                        device="cpu")
        for i in range(3):
            fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
        assert len(fs.shells) == 3 and not fs.is_lost
        assert not any(k == "jax" or k.startswith(("jax.", "sos_slam_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout + r.stderr


def test_entry_points_default_to_cuda(tmp_path):
    """Without device=, the entry point runs on CUDA or raises; it never
    carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    with pytest.raises(RuntimeError, match="CUDA"):
        FullSystem(synthetic.default_calib(128, 96), default_settings())
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.make_sequence(synthetic.default_calib(128, 96), 1)
    from sos_slam_tpu_torch.io.node import SlamNode
    from sos_slam_tpu_torch.loop.handler import LoopHandler
    settings = default_settings(scale_opt_thres=12.0, loop_lidar_range=40.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        LoopHandler(settings, ((100.0, 100.0, 63.5, 47.5),), 1,
                    async_mode=False)
    calib = os.path.join(str(tmp_path), "camera.txt")
    with open(calib, "w") as f:
        f.write("Pinhole 89.6 89.6 63.5 47.5 0\n128 96\nnone\n128 96\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamNode(default_settings(), calib)


def test_optional_layers_raise():
    """Loop closure constructs on the CPU with stereo scale; mono loop
    closure is refused by default_settings (utils/config.py:181-184, the
    reference's main.cpp:174-178), as is stereo scale without a
    StereoCalib; stereo scale and VIO construct."""
    from sos_slam_tpu_torch.models.full_system import FullSystem, StereoCalib
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings
    calib = synthetic.default_calib(128, 96)
    stereo = StereoCalib(T_lr=np.eye(4, dtype=np.float32), calib_right=calib)
    fs = FullSystem(calib, default_settings(scale_opt_thres=12.0,
                                            loop_lidar_range=40.0),
                    stereo=stereo, device="cpu")
    assert fs.settings.enable_loop_closure and fs.marg_callbacks == []
    with pytest.raises(ValueError, match="stereo"):
        default_settings(loop_lidar_range=40.0)
    with pytest.raises(ValueError):
        FullSystem(calib, default_settings(scale_opt_thres=12.0),
                   device="cpu")
    fs = FullSystem(calib, default_settings(weight_imu_dso=1.0,
                                            scale_opt_thres=12.0),
                    stereo=stereo, device="cpu")
    assert fs.imu is not None and fs.stereo is stereo
