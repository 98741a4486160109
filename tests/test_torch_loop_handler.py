"""The port's LoopHandler against sos_slam_tpu/loop/handler.py on the
closed-loop scene of tests/test_loop_closure_e2e.py: a drifted 16-gon
continued three segments revisits its start among 30 pillars; Scan
Context must match, ICP verify, and the pose graph pull the revisit back.

Both handlers run synchronously on the same records (the JAX package's
ScanAccumulator on its numpy voxel filter, as in tests/test_torch_loop.py)
and must give the same ringkey candidates, the same scans and signatures
(exactly: host numpy in both), the same loop edges between the same
keyframes, the same n_icp / n_direct, and optimized poses within 5e-3
(a pose-graph optimization is a run of full GN steps). The port's
asynchronous worker must give what its synchronous mode gives.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sos_slam_tpu import native
from sos_slam_tpu.loop.handler import LoopHandler as JLoopHandler
from sos_slam_tpu.models.full_system import FrameShell as JShell
from sos_slam_tpu.utils import lie as jlie
from sos_slam_tpu.utils.config import default_settings as j_settings
from sos_slam_tpu_torch.loop.handler import LoopHandler as TLoopHandler
from sos_slam_tpu_torch.models.full_system import FrameShell as TShell
from sos_slam_tpu_torch.utils.config import default_settings as t_settings
from tests.test_loop_closure_e2e import (LIDAR_RANGE, RecordingViewer,
                                         make_environment, visible_points)
from tests.test_torch_helpers import GN_TOL, close

KW = dict(scale_opt_thres=12.0, loop_lidar_range=LIDAR_RANGE,
          loop_icp_thres=1.0, scan_context_thres=0.42)
INTR = ((300.0, 300.0, 128.0, 96.0),)


def scene_records(n=20):
    """(ground truth, odometry, records): each record's points seen from
    the TRUE pose, handed over as pinhole [u, v, idepth] rows."""
    env = make_environment()
    rng = np.random.RandomState(42)
    gt = [np.eye(4)]
    seg = np.asarray(jlie.se3_exp(jnp.asarray(
        [2.0, 0.0, 0.0, 0.0, 2 * np.pi / 16, 0.0], jnp.float32)))
    for _ in range(1, n):
        gt.append(gt[-1] @ seg)
    gt = np.stack(gt)
    drift = np.asarray(jlie.se3_exp(jnp.asarray(
        [0.06, 0.03, -0.04, 0.004, 0.006, 0.0], jnp.float32)))
    odo = [np.eye(4)]
    for i in range(1, n):
        odo.append(odo[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ drift)
    odo = np.stack(odo)
    fx, fy, cx, cy = INTR[0]
    recs = []
    for i in range(n):
        pts_cam = visible_points(env, gt[i], rng)
        pts_cam = pts_cam[pts_cam[:, 2] > 0.5]
        pts_uvdi = np.stack([pts_cam[:, 0] / pts_cam[:, 2] * fx + cx,
                             pts_cam[:, 1] / pts_cam[:, 2] * fy + cy,
                             1.0 / pts_cam[:, 2]], -1)
        recs.append((i, pts_uvdi))
    return gt, odo, recs


def feed(lh, shell_cls, odo, recs, spy):
    orig = lh.ringkeys.search_and_insert

    def search_and_insert(rk):
        out = orig(rk)
        spy.append(list(out))
        return out

    lh.ringkeys.search_and_insert = search_and_insert
    for i, pts_uvdi in recs:
        shell = shell_cls(id=i, timestamp=i * 0.5,
                          cam_to_world=odo[i].copy(), aff=np.zeros(2))
        shell.cam_to_world_scaled = odo[i].copy()
        lh.on_keyframe(dict(shell=shell, pts_uvdi=pts_uvdi,
                            intensities=np.zeros((len(pts_uvdi), 1),
                                                 np.float32),
                            pyramid=None, dso_error=1.0, scale_error=2.0))
    lh.join()
    return lh


@pytest.fixture(scope="module")
def handlers():
    gt, odo, recs = scene_records()
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "scan_voxel_filter", lambda *a, **k: None)
    try:
        cj = []
        jh = JLoopHandler(j_settings(**KW), INTR, 1, ringkey_margin=6,
                          async_mode=False)
        feed(jh, JShell, odo, recs, cj)
    finally:
        mp.undo()
    ct, ca = [], []
    th = TLoopHandler(t_settings(**KW), INTR, 1, ringkey_margin=6,
                      async_mode=False, device="cpu")
    th.attach_viewer(RecordingViewer())
    feed(th, TShell, odo, recs, ct)
    ta = TLoopHandler(t_settings(**KW), INTR, 1, ringkey_margin=6,
                      async_mode=True, device="cpu")
    feed(ta, TShell, odo, recs, ca)
    return gt, odo, (jh, cj), (th, ct), (ta, ca)


def test_same_candidates_scans_and_edges(handlers):
    _, _, (jh, cj), (th, ct), _ = handlers
    assert cj == ct and any(cj)
    assert len(jh.frames) == len(th.frames) == 20
    for fj, ft in zip(jh.frames, th.frames):
        np.testing.assert_array_equal(fj["pts_sc"], ft["pts_sc"])
        np.testing.assert_array_equal(fj["T_sc_rig"], ft["T_sc_rig"])
        np.testing.assert_array_equal(fj["sig"], ft["sig"])
        assert [e["id_from"] for e in fj["edges"]] \
            == [e["id_from"] for e in ft["edges"]]
        for ej, et in zip(fj["edges"], ft["edges"]):
            np.testing.assert_array_equal(ej["info"], et["info"])
        assert [e["id_from"] for e in fj["loop_edges"]] \
            == [e["id_from"] for e in ft["loop_edges"]]
        for ej, et in zip(fj["loop_edges"], ft["loop_edges"]):
            close(ej["T_from_to"], et["T_from_to"], tol=1e-4)
            close(ej["info"], et["info"], tol=1e-3)
    assert (jh.n_loop_edges, jh.n_icp, jh.n_direct) \
        == (th.n_loop_edges, th.n_icp, th.n_direct)
    assert th.n_loop_edges >= 1 and th.n_icp >= 1


def test_optimized_poses_match(handlers):
    gt, odo, (jh, _), (th, _), _ = handlers
    close(np.stack([f["T_opt"] for f in jh.frames]),
          np.stack([f["T_opt"] for f in th.frames]), tol=GN_TOL)
    close(jh.trajectory(), th.trajectory(), tol=GN_TOL)
    # tests/test_loop_closure_e2e.py's drift gate on the port
    from sos_slam_tpu.utils.evaluate import ate_rmse
    traj = th.trajectory()
    ids = traj[:, 0].astype(int)
    r_odo = ate_rmse(odo[ids, :3, 3], gt[ids, :3, 3])["rmse"]
    r_opt = ate_rmse(traj[:, 1:4], gt[ids, :3, 3])["rmse"]
    assert r_opt < 0.6 * r_odo, (r_odo, r_opt)


def test_viewer_write_back(handlers):
    _, _, _, (th, _), _ = handlers
    v = th.viewers[0]
    assert len(v.edges) == th.n_loop_edges >= 1
    assert v.scans >= 1
    assert len(v.modified) == len(th.frames)
    for f in th.frames:
        np.testing.assert_allclose(v.modified[f["kf_id"]], f["T_opt"],
                                   atol=1e-9)


def test_async_equals_sync(handlers, tmp_path):
    _, _, _, (th, ct), (ta, ca) = handlers
    assert ta._worker is not None and th._worker is None
    assert ca == ct
    assert (ta.n_loop_edges, ta.n_icp, ta.n_direct) \
        == (th.n_loop_edges, th.n_icp, th.n_direct)
    np.testing.assert_array_equal(ta.trajectory(), th.trajectory())
    for fmt in ("id_xyz", "tum"):
        pa, ps = tmp_path / f"a_{fmt}.txt", tmp_path / f"s_{fmt}.txt"
        ta.save_poses(str(pa), fmt=fmt)
        th.save_poses(str(ps), fmt=fmt)
        assert pa.read_text() == ps.read_text()
    rows = np.loadtxt(str(ps))
    assert rows.shape == (20, 8)
