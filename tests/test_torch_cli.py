"""The port's node-level runs and its command line, on the CPU.

tests/test_node.py's scenarios through the port's SlamNode, held to that
file's own assertions (the JAX package's runs of them are that file's):
reinitialization with the trajectory, keyframe count and loop history
carried over, and the output wrappers' event counts. Then the command
line: `python -m sos_slam_tpu_torch --device cpu` on the tiny Malaga
folder of tests/test_datasets.py, on a synthetic KITTI-layout sequence
(poses.txt of `id x y z` rows, metric up to the monocular scale), and its
refusal to start without a CUDA device when none is named; and
`python -m sos_slam_tpu_torch.io.run_synthetic --device cpu`.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.io.node import SlamNode
from sos_slam_tpu_torch.io.output_wrapper import Output3DWrapper
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_datasets import _tiny_launch, _write_png
from tests.test_torch_helpers import scene_images

torch.set_num_threads(2)

W, H = 256, 192
TWIST = [0.05, 0.02, 0.03, 0.003, 0.006, 0.002]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINHOLE = f"Pinhole 179.2 179.2 127.5 95.5 0\n{W} {H}\nnone\n{W} {H}\n"


def small_settings(**kw):
    return default_settings(
        max_window_frames=8, max_points=512, max_immature=1024,
        max_track_pts=4096, desired_point_density=400.0,
        desired_immature_density=400.0, **kw)


def make_node():
    calib_file = os.path.join(tempfile.mkdtemp(), "camera0.txt")
    with open(calib_file, "w") as f:
        f.write(PINHOLE)
    return SlamNode(small_settings(), calib_file, device="cpu",
                    async_loop=False)


class CountingWrapper(Output3DWrapper):
    def __init__(self):
        self.poses = self.kfs = self.finals = self.depths = 0

    def publish_cam_pose(self, shell, calib):
        self.poses += 1

    def publish_keyframes(self, record, final):
        if final:
            self.finals += 1
        else:
            self.kfs += 1

    def push_depth_image(self, image, idepth):
        self.depths += 1
        assert image.shape == idepth.shape


def test_reinitialization_preserves_history():
    node = make_node()
    n = 34
    imgs, _ = scene_images(W, H, n, TWIST)
    for i in range(16):
        node.process(imgs[i], i * 0.05)
    kfs_before = node.fs.stats["n_kf"]
    assert kfs_before > 2
    loop_before = len(node.loop.frames)
    pose_at_failure = np.asarray(node.cur_pose).copy()
    # force an initialization failure (the reference's rmse-gate outcome)
    node.fs.init_failed = True
    node.process(imgs[16], 16 * 0.05)
    np.testing.assert_array_equal(node.fs.initial_pose, pose_at_failure)
    assert node.prev_kf_size >= kfs_before
    assert not node.fs.initialized                # fresh system
    for i in range(17, n):
        node.process(imgs[i], i * 0.05)
    assert node.n_frames == n
    assert len(node.loop.frames) >= loop_before
    assert node.fs.initialized, "fresh system failed to re-initialize"
    first_kf = next(sh for sh in node.fs.shells if sh.is_kf)
    np.testing.assert_allclose(first_kf.cam_to_world, pose_at_failure,
                               atol=1e-5)
    # the first keyframe after the restart carries a NaN dso_error, so no
    # odometry edge bridges the gap
    restarted = [f for f in node.loop.frames[loop_before:]
                 if not np.isfinite(f["dso_error"])]
    assert len(restarted) <= 1
    if restarted:
        assert restarted[0]["edges"] == []


def test_output_wrappers_receive_events():
    node = make_node()
    cw = CountingWrapper()
    node.extra_wrappers.append(cw)
    node.fs.output_wrappers.append(cw)
    n = 22
    imgs, _ = scene_images(W, H, n, TWIST)
    for i in range(n):
        node.process(imgs[i], i * 0.05)
    assert cw.poses > 0
    assert cw.kfs >= 2
    assert cw.depths == cw.kfs
    assert cw.finals >= 1
    assert len(node.pose_recorder.current) == cw.poses
    assert len(node.pose_recorder.marginalized) == cw.finals
    assert cw.finals == len(node.loop.frames)


def _cli(*args, env_extra=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_malaga_format(tmp_path):
    d = tmp_path / "malaga" / "Images"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(4):
        t = 1261228749.0 + i * 0.05
        img = rng.randint(0, 255, (60, 80))
        _write_png(d / f"img_CAMERA1_{t:.6f}_left.png", img)
        _write_png(d / f"img_CAMERA1_{t:.6f}_right.png", img)
    out = tmp_path / "poses.txt"
    r = _cli("sos_slam_tpu_torch", "--launch", _tiny_launch(tmp_path),
             "--dataset", str(tmp_path / "malaga"), "--format", "malaga",
             "--output", str(out), "--max-frames", "3", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert out.exists() and "processed 3 frames" in r.stdout


def test_cli_needs_a_device_when_none_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    r = _cli("sos_slam_tpu_torch", "--launch", _tiny_launch(tmp_path),
             "--dataset", str(tmp_path), "--format", "malaga")
    assert r.returncode != 0 and "CUDA" in r.stderr
    r = _cli("sos_slam_tpu_torch.io.run_synthetic", "--frames", "2",
             "--out", str(tmp_path))
    assert r.returncode != 0 and "CUDA" in r.stderr


def test_cli_kitti_sequence_writes_poses(tmp_path):
    """A 24-frame synthetic sequence in the KITTI odometry layout (8-bit
    PNGs + times.txt) through the command line: poses.txt holds one
    `id x y z` row per marginalized keyframe, on the rendered trajectory
    up to the monocular scale (scale-aligned ATE as bench.py gates it)."""
    n = 24
    imgs, poses = scene_images(W, H, n, TWIST)
    seq = tmp_path / "seq"
    (seq / "image_0").mkdir(parents=True)
    for i in range(n):
        _write_png(seq / "image_0" / f"{i:06d}.png",
                   np.clip(np.round(imgs[i]), 0, 255))
    np.savetxt(seq / "times.txt", np.arange(n) * 0.05)
    cam = tmp_path / "camera0.txt"
    cam.write_text(PINHOLE)
    launch = tmp_path / "mono.launch"
    launch.write_text(
        "<launch>\n"
        f"  <param name=\"calib0\" value=\"{cam}\"/>\n"
        "  <param name=\"mode\" value=\"1\"/>\n"
        "  <param name=\"preset\" value=\"2\"/>\n"
        "</launch>\n")
    out = tmp_path / "poses.txt"
    r = _cli("sos_slam_tpu_torch", "--launch", str(launch), "--dataset",
             str(seq), "--format", "kitti", "--output", str(out),
             "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    rows = np.loadtxt(out)
    assert rows.ndim == 2 and rows.shape[1] == 4 and len(rows) >= 3
    assert (rows[:, 0] == np.round(rows[:, 0])).all()
    ids = rows[:, 0].astype(int)
    est, gt = rows[:, 1:4], poses[ids, :3, 3]
    en, gn = np.linalg.norm(est, axis=1), np.linalg.norm(gt, axis=1)
    nz = gn > 1e-6
    scale = np.median(en[nz] / gn[nz])
    ate = np.sqrt(np.mean(np.linalg.norm(est / scale - gt, axis=1) ** 2))
    path = np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))
    assert ate < 0.05 * path + 0.01, (ate, path)


def test_run_synthetic_on_the_cpu(tmp_path):
    r = _cli("sos_slam_tpu_torch.io.run_synthetic", "--frames", "20",
             "--out", str(tmp_path), "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    rows = np.loadtxt(tmp_path / "poses.txt")
    assert rows.ndim == 2 and rows.shape[1] == 4
