"""The port's headless viewer (io/viewer.py), debug plots (io/debug_plot.py)
and PNG writer (io/png.py).

Held against the JAX package, bit for bit (both render in numpy on the
host): the map the MapViewer renders from the same host records
(tests/test_viewer.py's five keyframes, a loop edge, a rewritten pose);
render_window in modes 0, 3 and 4 and render_tracking on one window state,
a seeded BA window (utils/synthetic.make_window) and a seeded immature
pool, handed to the port through utils/convert.py. On the port alone: the
PNG writer's files decode (through imageio) to the arrays written; a port
run with a DebugPlotDumper writes its window and tracking PNGs; and
`run_synthetic --viewer --device cpu` writes map frames."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_slam_tpu.io import debug_plot as JDP
from sos_slam_tpu.io import viewer as JV
from sos_slam_tpu.ops import ba as JB
from sos_slam_tpu.ops import trace as JT
from sos_slam_tpu.utils import synthetic as JSY
from sos_slam_tpu_torch.io import debug_plot as TDP
from sos_slam_tpu_torch.io import png
from sos_slam_tpu_torch.io import viewer as TV
from sos_slam_tpu_torch.ops import ba as TB
from sos_slam_tpu_torch.ops import trace as TT
from sos_slam_tpu_torch.utils import convert, synthetic
from tests.test_torch_helpers import exact

torch.set_num_threads(2)

P, F, N_IMM = 400, 6, 300


class _Shell:
    def __init__(self, i, T):
        self.id = i
        self.cam_to_world = T
        self.cam_to_world_scaled = None
        self.scale = 1.0


def _feed_viewer(v):
    rng = np.random.default_rng(0)
    for i in range(5):
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.0, 0.02 * i]
        v.publish_cam_pose(_Shell(i, T), None)
        rec = dict(shell=_Shell(i, T),
                   pts_uvdi=np.stack([rng.uniform(10, 300, 50),
                                      rng.uniform(10, 200, 50),
                                      rng.uniform(0.3, 2.0, 50)], -1),
                   calib=(300.0, 300.0, 160.0, 120.0), scale_error=0.5)
        v.publish_keyframes(rec, final=True)
        v.publish_keyframes(rec, final=False)


def test_map_viewer_matches(tmp_path):
    vj = JV.MapViewer(size=128)
    vt = TV.MapViewer(out_dir=str(tmp_path), size=128)
    for v in (vj, vt):
        _feed_viewer(v)
    assert len(vt.keyframes) == 5 and len(vt.trajectory) == 5
    exact(vj.render_array(), vt.render_array())
    T_new = np.eye(4)
    T_new[:3, 3] = [0.3, -0.1, 0.2]
    for v in (vj, vt):
        v.publish_loop_edge(0, 4)
        v.modify_keyframe_pose_by_kf_id(2, T_new)
        v.publish_scan(np.ones((4, 3)), np.zeros((2, 3)))
    img = vt.render_array()
    exact(vj.render_array(), img)
    assert img.shape == (128, 256, 3) and (img != 16).any()
    files = sorted(os.listdir(tmp_path))
    assert files.count("ui_vars.txt") == 1
    assert [f for f in files if f.startswith("map_")] \
        == [f"map_{i:06d}.png" for i in range(1, 6)]
    vt.join()
    assert vt.n_rendered == 6


def _window_states():
    """(JAX fs-like, port fs-like) over one seeded window state."""
    fields, dI = synthetic.make_window(P, F, seed=3)
    r = np.random.RandomState(4)
    h, w = dI.shape[1:3]
    imax = r.uniform(0.3, 2.0, N_IMM).astype(np.float32)
    imax[r.rand(N_IMM) < 0.2] = np.inf
    imm = dict(
        valid=r.rand(N_IMM) < 0.8, host=r.randint(0, F, N_IMM).astype(
            np.int32),
        u=r.uniform(0, w - 1, N_IMM).astype(np.float32),
        v=r.uniform(0, h - 1, N_IMM).astype(np.float32),
        color=r.rand(N_IMM, 8).astype(np.float32),
        weights=r.rand(N_IMM, 8).astype(np.float32),
        gradH=r.rand(N_IMM, 2, 2).astype(np.float32),
        energy_th=r.rand(N_IMM).astype(np.float32),
        idepth_min=r.uniform(0.0, 0.3, N_IMM).astype(np.float32),
        idepth_max=imax, status=r.randint(0, 6, N_IMM).astype(np.int8),
        quality=r.rand(N_IMM).astype(np.float32),
        my_type=np.ones(N_IMM, np.int32))
    ba_j = JB.BAState(**{k: jnp.asarray(v) for k, v in fields.items()})
    imm_j = JT.ImmatureState(**{k: jnp.asarray(v) for k, v in imm.items()})
    shells = [SimpleNamespace(cam_to_world=np.linalg.inv(
        fields["T_cw_eval"][i].astype(np.float64))) for i in range(F)]
    common = dict(current_scale=1.7, shells=shells,
                  frame_shell_idx=list(range(F)))
    fj = SimpleNamespace(dI=jnp.asarray(dI), ba=ba_j, imm=imm_j,
                         calib=JSY.default_calib(w, h), **common)
    ft = SimpleNamespace(
        dI=torch.as_tensor(np.array(fj.dI)),
        ba=convert.from_numpy(TB.BAState, {k: np.asarray(v) for k, v in
                                           ba_j._asdict().items()}, "cpu"),
        imm=convert.from_numpy(TT.ImmatureState,
                               {k: np.asarray(v) for k, v in
                                imm_j._asdict().items()}, "cpu"),
        calib=synthetic.default_calib(w, h), **common)
    return fj, ft


@pytest.fixture(scope="module")
def window():
    return _window_states()


@pytest.mark.parametrize("mode", [0, 3, 4])
def test_render_window_matches(window, mode):
    fj, ft = window
    ij, it = JDP.render_window(fj, mode), TDP.render_window(ft, mode)
    assert len(it) == F
    for a, b in zip(ij, it):
        exact(a, b)
    painted = sum(int(((im.max(-1).astype(int) - im.min(-1)) > 0).sum())
                  for im in it)
    assert painted > 50


def test_render_tracking_matches(window):
    fj, ft = window
    ij, it = JDP.render_tracking(fj), TDP.render_tracking(ft)
    assert len(it) == F
    for a, b in zip(ij, it):
        exact(a, b)


def test_rainbow_matches():
    x = np.random.RandomState(5).uniform(-1, 7, 100)
    exact(JDP.rainbow(x), TDP.rainbow(x))


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (48, 64)])
def test_png_writer_decodes_to_its_array(tmp_path, shape):
    import imageio.v2 as iio
    img = np.random.RandomState(6).randint(0, 256, shape + (3,)).astype(
        np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    exact(iio.imread(path), img)
    with pytest.raises(ValueError):
        png.encode_png(img.astype(np.float32))


def test_debug_plot_dumper_on_a_port_run(tmp_path):
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils.config import default_settings
    W, H = 256, 192
    calib = synthetic.default_calib(W, H)
    imgs, _, _ = synthetic.make_sequence(
        calib, 12, (0.05, 0.02, 0.03, 0.003, 0.006, 0.002), plane_z=2.0,
        device="cpu")
    fs = FullSystem(calib, default_settings(
        max_window_frames=8, max_points=512, max_immature=1024,
        max_track_pts=4096, desired_point_density=400.0,
        desired_immature_density=400.0), device="cpu")
    for i in range(12):
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
    assert fs.initialized and not fs.is_lost
    d = TDP.DebugPlotDumper(str(tmp_path), mode=0, tracking=True)
    d.dump(fs)
    n = int(fs.ba.frame_valid.sum())
    files = sorted(os.listdir(tmp_path))
    assert files == sorted([f"win_00000_{k}.png" for k in range(n)]
                           + [f"trk_00000_{k}.png" for k in range(n)])


def test_run_synthetic_viewer_writes_maps(tmp_path):
    from sos_slam_tpu_torch.io import run_synthetic
    out = str(tmp_path / "out")
    assert run_synthetic.main(["--frames", "24", "--out", out, "--viewer",
                               "--device", "cpu"]) == 0
    maps = [f for f in os.listdir(out) if f.startswith("map_")]
    assert maps and os.path.exists(os.path.join(out, "poses.txt"))
