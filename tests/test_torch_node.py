"""The port's SlamNode, undistortion and launch parsing against the JAX
package's.

The node: the 256x192 stereo scene of tests/test_loop_integration.py (24
frames, constant twist, right camera at +0.11 m, loop closure on at a 40 m
LiDAR range) through both packages' SlamNode from pinhole camera files
with no rectification, fed the same pixels. Held: the same keyframe ids
and the same marginalized keyframes reaching the loop handler in the same
order (exact); the same loop edges; each record's marginalized point
count within one point and the totals within two (a point whose Hessian
or residual count sits on a marginalization threshold can flip between
the packages' f32 states, which differ by ~1e-3 relative by the end of
the run: the stereo scale errors differ by up to 1%); dso_error within
2e-2 relative and scale_error within 1e-2 relative (both read that state);
poses.txt rows within 1e-3 (tests/test_torch_stereo.py's tolerance on
positions). A record handed to the loop handler holds tensors the
odometry never writes again: it is unchanged after the later frames.

The JAX package remaps `none` rectification through the identity, whose
validity test zeroes the one-pixel border; the port passes the image
through (io/undistort.py). Both packages' nodes are compared with the
port's `jax_form=True`, which keeps that remap (and the JAX package's VIO
prior fold). The port's own form is held on its own: `none` returns the
photometrically corrected image bit for bit, and the flagship scene of
chip_smoke.py at 256x192 (stereo + VIO, 30 frames) through the node gives
the keyframes of a FullSystem fed the raw frames (with the remap they part
from the sixth keyframe on).

Undistortion: each distortion model's K_new and remap tables exactly
(float64 numpy in both), the rectified image at 2e-4 (the port's remap
form); the photometric response + vignette on the device against the
numpy form at 2e-4. Launch files: the same settings and paths.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_slam_tpu.io import launch as JL
from sos_slam_tpu.io import undistort as JU
from sos_slam_tpu.io.node import SlamNode as JNode
from sos_slam_tpu.utils import synthetic as jsyn
from sos_slam_tpu.utils.config import default_settings as j_settings
from sos_slam_tpu_torch.io import launch as TL
from sos_slam_tpu_torch.io import undistort as TU
from sos_slam_tpu_torch.io.node import SlamNode as TNode
from sos_slam_tpu_torch.utils.config import default_settings as t_settings
from tests.test_torch_helpers import close, exact

torch.set_num_threads(2)

W, H, N, BASELINE = 256, 192, 24, 0.11
TWIST = [0.05, 0.02, 0.03, 0.003, 0.006, 0.002]
PINHOLE = f"Pinhole 179.2 179.2 127.5 95.5 0\n{W} {H}\nnone\n{W} {H}\n"
KW = dict(scale_opt_thres=12.0, loop_lidar_range=40.0, max_window_frames=8,
          max_points=512, max_immature=1024, max_track_pts=4096,
          desired_point_density=400.0, desired_immature_density=400.0)


def stereo_frames():
    calib = jsyn.default_calib(W, H)
    T_lr_world = np.eye(4)
    T_lr_world[0, 3] = BASELINE
    imgs, _, poses = jsyn.make_sequence(calib, N, jnp.array(TWIST),
                                        plane_z=2.0)
    right = [np.asarray(jsyn.render_plane(
        calib, poses[i] @ jnp.asarray(T_lr_world, jnp.float32), 2.0)[0])
        for i in range(N)]
    return ([np.asarray(im) for im in imgs], right, np.asarray(poses),
            np.linalg.inv(T_lr_world))


def run_node(node, left, right):
    """Feeds the frames; returns the records' summaries as the loop
    handler received them, and a deep copy of the first record with
    points taken when it arrived."""
    seen, first = [], {}
    orig = node.loop.on_keyframe

    def on_keyframe(rec):
        seen.append(dict(id=rec["shell"].id, n=len(rec["pts_uvdi"]),
                         dso=rec["dso_error"], se=rec["scale_error"]))
        if not first and len(rec["pts_uvdi"]) and torch.is_tensor(
                rec["pyramid"][0]):
            first.update(rec=rec, pyr=[p.clone() for p in rec["pyramid"]],
                         pts=rec["pts_uvdi"].copy(),
                         inten=rec["intensities"].copy())
        orig(rec)

    node.loop.on_keyframe = on_keyframe
    for i in range(N):
        node.process(left[i], i * 0.05, image_right=right[i])
    if hasattr(node.fs, "finish_pending"):
        node.fs.finish_pending()
    node.loop.join()
    return seen, first


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("node")
    cam = str(tmp / "camera.txt")
    with open(cam, "w") as f:
        f.write(PINHOLE)
    left, right, poses, T_stereo = stereo_frames()
    jn = JNode(j_settings(**KW), cam, calib1=cam, T_stereo=T_stereo)
    sj, _ = run_node(jn, left, right)
    tn = TNode(t_settings(**KW), cam, calib1=cam, T_stereo=T_stereo,
               device="cpu", jax_form=True)
    st, first = run_node(tn, left, right)
    pj, pt = str(tmp / "poses_jax.txt"), str(tmp / "poses_port.txt")
    jn.save_poses(pj)
    tn.save_poses(pt)
    return jn, tn, sj, st, first, np.loadtxt(pj), np.loadtxt(pt), poses


def test_node_matches_jax(nodes):
    jn, tn, sj, st, _, _, _, _ = nodes
    assert tn.fs.initialized and not tn.fs.is_lost
    assert tn.fs.kf_shell_ids == jn.fs.kf_shell_ids
    assert [r["id"] for r in st] == [r["id"] for r in sj]
    assert len(st) >= 3
    assert [f["incoming_id"] for f in tn.loop.frames] \
        == [f["incoming_id"] for f in jn.loop.frames]
    assert tn.loop.n_loop_edges == jn.loop.n_loop_edges
    n_j = np.array([r["n"] for r in sj])
    n_t = np.array([r["n"] for r in st])
    assert np.abs(n_j - n_t).max() <= 1 and abs(n_j.sum() - n_t.sum()) <= 2
    assert n_t.sum() > 0
    close(np.array([r["dso"] for r in sj]) / np.array([r["dso"] for r in st]),
          np.ones(len(st)), tol=2e-2)
    close([r["se"] for r in sj], [r["se"] for r in st], tol=1e-2)


def test_node_poses_txt(nodes):
    _, tn, _, _, _, pj, pt, poses = nodes
    assert pt.ndim == 2 and pt.shape[1] == 4 and pt.shape == pj.shape
    exact(pt[:, 0], pj[:, 0])
    close(pj[:, 1:], pt[:, 1:], tol=1e-3)
    # tests/test_loop_integration.py's metric gate on the port
    ids = pt[:, 0].astype(int)
    err = np.linalg.norm(pt[:, 1:4] - poses[ids, :3, 3], axis=1)
    assert np.sqrt((err ** 2).mean()) < 0.15, err
    # every marginalized keyframe has an odometry edge to the previous one
    n_edges = sum(len(f["edges"]) for f in tn.loop.frames)
    assert n_edges == len(tn.loop.frames) - 1
    assert all(np.isfinite(f["dso_error"]) for f in tn.loop.frames)
    assert any(f["pts_sc"].shape[0] > 0 for f in tn.loop.frames)


def test_record_unchanged_after_later_frames(nodes):
    """The mutable-tensor hazard: the record's pyramid is the slot's own
    (no view into the window's image stack or a reused buffer), and its
    points and intensities are host copies."""
    _, tn, _, _, first, _, _, _ = nodes
    rec = first["rec"]
    assert len(first["pts"]) > 0
    for p, q in zip(rec["pyramid"], first["pyr"]):
        exact(p, q)
        assert p.data_ptr() != tn.fs.dI.data_ptr()
    exact(rec["pts_uvdi"], first["pts"])
    exact(rec["intensities"], first["inten"])
    kept = next(f for f in tn.loop.frames
                if f["incoming_id"] == rec["shell"].id)
    assert kept["pyramid"] is rec["pyramid"]


def test_node_none_gives_the_raw_frames_keyframes(tmp_path):
    from sos_slam_tpu_torch.models.full_system import FullSystem, \
        StereoCalib
    from sos_slam_tpu_torch.utils import synthetic
    n = 30
    calib = synthetic.default_calib(W, H)
    sc = synthetic.stereo_vio_scene(calib, n, 0.1, synthetic.sine_pose,
                                    synthetic.sine_acc, device="cpu")
    cam = str(tmp_path / "camera.txt")
    fx, fy, cx, cy = calib.intrinsics(0)
    with open(cam, "w") as f:
        f.write(f"Pinhole {fx} {fy} {cx} {cy} 0\n{W} {H}\nnone\n{W} {H}\n")
    kw = dict(KW, weight_imu_dso=6.0, min_g_imu=10)
    node = TNode(t_settings(**kw), cam, calib1=cam, T_stereo=sc["T_lr"],
                 device="cpu", async_loop=False)
    node.run([dict(image=sc["left"][i], t=i * 0.1,
                   image_right=sc["right"][i], imu=sc["imu"][i])
              for i in range(n)])
    kw.pop("loop_lidar_range")
    fs = FullSystem(calib, t_settings(**kw), stereo=StereoCalib(
        T_lr=sc["T_lr"], calib_right=calib), device="cpu")
    for i in range(n):
        fs.add_active_frame(sc["left"][i], timestamp=i * 0.1, frame_id=i,
                            image_right=sc["right"][i],
                            imu_samples=sc["imu"][i])
    assert node.fs.imu_initialized and len(fs.kf_shell_ids) >= 6
    assert node.fs.kf_shell_ids == fs.kf_shell_ids


# ----------------------------------------------------------------------
# undistortion
# ----------------------------------------------------------------------
def test_none_is_a_passthrough(tmp_path):
    """`none` with equal sizes: the node hands the photometrically
    corrected image on bit for bit; the remap form (`jax_form=True`, and
    `none` between unequal sizes) zeroes the one-pixel border."""
    cam = tmp_path / "camera.txt"
    cam.write_text(PINHOLE)
    gamma = str(tmp_path / "pcalib.txt")
    np.savetxt(gamma, 255.0 * np.linspace(0, 1, 256)[None] ** 1.3)
    node = TNode(t_settings(**dict(KW, loop_lidar_range=0.0,
                                   scale_opt_thres=0.0)),
                 str(cam), gamma0=gamma, device="cpu")
    img = np.random.RandomState(7).uniform(1, 255, (H, W)).astype(np.uint8)
    out = node._preprocess(img, node.und0, node.photo0)
    exact(out, node.photo0.process_tensor(torch.as_tensor(
        img.astype(np.float32))))
    assert node.und0.passthrough and out.abs().min() > 0
    remapped = TU.load_undistorter(str(cam), jax_form=True).undistort(out)
    assert not remapped[0].any() and not remapped[:, -1].any()
    exact(remapped[1:-1, 1:-1], out[1:-1, 1:-1])
    cam.write_text(PINHOLE.replace(f"none\n{W} {H}", f"none\n{W} {H - 2}"))
    assert not TU.load_undistorter(str(cam)).passthrough


# ----------------------------------------------------------------------
CAMERAS = {
    "FOV": "FOV 0.5 0.6 0.5 0.5 0.9\n64 48\ncrop\n48 40\n",
    "Pinhole": "Pinhole 0.6 0.8 0.5 0.5 0\n64 48\nfull\n64 48\n",
    "RadTan": "RadTan 0.6 0.8 0.5 0.5 -0.2 0.05 0.001 -0.002\n64 48\n"
              "crop\n56 40\n",
    "EquiDistant": "EquiDistant 0.5 0.65 0.5 0.5 0.01 -0.02 0.003 0.0\n"
                   "64 48\nfull\n64 48\n",
    "KannalaBrandt": "KannalaBrandt 0.5 0.65 0.5 0.5 0.02 -0.01 0.002 0.0\n"
                     "64 48\n0.55 0.7 0.5 0.5\n48 36\n",
    "radtan-by-count": "0.6 0.8 0.5 0.5 -0.1 0.02 0.0 0.0\n64 48\nnone\n"
                       "64 48\n",
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_undistort_matches(name, tmp_path):
    path = str(tmp_path / "camera.txt")
    with open(path, "w") as f:
        f.write(CAMERAS[name])
    uj, ut = JU.load_undistorter(path), TU.load_undistorter(path,
                                                             jax_form=True)
    assert (uj.model, uj.w, uj.h, uj.w_org, uj.h_org) \
        == (ut.model, ut.w, ut.h, ut.w_org, ut.h_org)
    for f in ("pars", "K", "remap_x", "remap_y", "remap_valid"):
        exact(getattr(uj, f), getattr(ut, f))
    assert uj.intrinsics() == ut.intrinsics()
    img = np.random.RandomState(0).uniform(0, 255, (48, 64)) \
        .astype(np.float32)
    close(uj.undistort(jnp.asarray(img)), ut.undistort(torch.as_tensor(img)))
    assert ut.remap_valid.any()


def test_photometric_undistorter_matches(tmp_path):
    w, h = 64, 48
    gamma = str(tmp_path / "pcalib.txt")
    G = 255.0 * np.linspace(0, 1, 256) ** 1.3
    np.savetxt(gamma, G[None])
    for mode in (0, 1, 2):
        pj = JU.PhotometricUndistorter(gamma, None, w=w, h=h, mode=mode)
        pt = TU.PhotometricUndistorter(gamma, None, w=w, h=h, mode=mode)
        exact(pj.G, pt.G)
        img = np.random.RandomState(mode).uniform(-5, 260, (h, w)) \
            .astype(np.float32)
        oj, ej = pj.process(img, 2.0)
        ot, et = pt.process(img, 2.0)
        exact(oj, ot)
        assert ej == et
        close(ot, pt.process_tensor(torch.as_tensor(img)))


def test_launch_matches(tmp_path):
    cam = tmp_path / "camera0.txt"
    cam.write_text(PINHOLE)
    yaml = tmp_path / "calib.yaml"
    yaml.write_text(
        "imu_topic: /imu0\ncam0_topic: /cam0/image_raw\n"
        "T_cam0_imu: [0.0, -1.0, 0.0, 0.1,\n 1.0, 0.0, 0.0, -0.05,\n"
        " 0.0, 0.0, 1.0, 0.02,\n 0.0, 0.0, 0.0, 1.0]\n"
        "T_cam1_cam0: [1.0, 0.0, 0.0, -0.11, 0.0, 1.0, 0.0, 0.0,"
        " 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]\n"
        "rate_hz: 200\naccelerometer_noise_density: 2.0e-3  # noise\n"
        "gyroscope_noise_density: 1.6968e-04\n")
    launch = tmp_path / "tiny.launch"
    launch.write_text(
        "<launch>\n"
        "  <arg name=\"seq\" default=\"00\"/>\n"
        f"  <rosparam command=\"load\" file=\"{yaml}\"/>\n"
        f"  <param name=\"calib0\" value=\"{cam}\"/>\n"
        f"  <param name=\"calib1\" value=\"{cam}\"/>\n"
        "  <param name=\"bag\" value=\"$(find sos_slam)/bags/$(arg seq)\"/>\n"
        "  <param name=\"mode\" value=\"1\"/>\n"
        "  <param name=\"preset\" value=\"0\"/>\n"
        "  <param name=\"scale_opt_thres\" value=\"12\"/>\n"
        "  <param name=\"weight_imu_dso\" value=\"6\"/>\n"
        "  <param name=\"loop_lidar_range\" value=\"40\"/>\n"
        "  <param name=\"loop_force_icp\" value=\"true\"/>\n"
        "  <param name=\"start_frame\" value=\"3\"/>\n"
        "</launch>\n")
    cj = JL.load_launch(str(launch), package_root="/pkg")
    ct = TL.load_launch(str(launch), package_root="/pkg")
    assert ct.settings == type(ct.settings)(**vars(cj.settings))
    assert ct.settings.enable_loop_closure and ct.settings.loop_force_icp
    for f in ("calib0", "calib1", "gamma0", "vignette0", "bag",
              "start_frame", "topics"):
        assert getattr(cj, f) == getattr(ct, f), f
    assert ct.bag == "/pkg/bags/00" and ct.start_frame == 3
    exact(cj.T_cam0_imu, ct.T_cam0_imu)
    exact(cj.T_cam1_cam0, ct.T_cam1_cam0)
