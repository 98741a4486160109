"""Synthetic multi-view-consistent scenes (port of sos_slam_tpu/utils/synthetic.py).

A textured 3-D plane rendered from arbitrary camera poses: images from
different poses are exactly photometrically consistent, with analytic
ground-truth depth. World convention: camera looks along +z; the plane is
z = plane_z (world). Texture = sum of smooth sinusoids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sos_slam_tpu_torch import resolve_device
from sos_slam_tpu_torch.utils import lie
from sos_slam_tpu_torch.utils.camera import CalibPyramid, make_calib_pyramid


def default_calib(w: int = 640, h: int = 480) -> CalibPyramid:
    return make_calib_pyramid(w, h, fx=0.7 * w, fy=0.7 * w, cx=w / 2 - 0.5,
                              cy=h / 2 - 0.5)


def texture(xy: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Continuous texture T(x, y) in [0, 255], band-limited sinusoid mix."""
    rng = np.random.RandomState(seed)
    n_waves = 24
    freqs = rng.uniform(0.5, 12.0, (n_waves, 2)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)
    amps = (rng.uniform(0.3, 1.0, n_waves) / np.sqrt(n_waves)).astype(np.float32)
    x, y = xy[..., 0], xy[..., 1]
    acc = torch.zeros_like(x)
    for i in range(n_waves):
        acc = acc + float(amps[i]) * torch.sin(
            float(freqs[i, 0]) * x + float(freqs[i, 1]) * y + float(phases[i]))
    return 128.0 + 100.0 * acc


def render_plane(calib: CalibPyramid, cam_to_world: torch.Tensor,
                 plane_z: float = 2.0, seed: int = 0, lvl: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image (H,W) in [0,255], inverse depth (H,W)) for a camera at
    `cam_to_world` viewing the plane z = plane_z, on cam_to_world's device."""
    w, h = calib.widths[lvl], calib.heights[lvl]
    fx, fy, cx, cy = calib.intrinsics(lvl)
    dev = cam_to_world.device
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rc = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)], -1)
    R = cam_to_world[:3, :3]
    t = cam_to_world[:3, 3]
    rw = rc @ R.T
    rz = rw[..., 2]
    s = (plane_z - t[2]) / torch.where(torch.abs(rz) < 1e-6,
                                       torch.full_like(rz, 1e-6), rz)
    s = torch.clamp(s, min=1e-3)
    pw = t + s[..., None] * rw
    img = texture(pw[..., :2], seed)
    pc = (pw - t) @ R
    z = torch.clamp(pc[..., 2], min=1e-3)
    return img, 1.0 / z


def render_two_planes(calib: CalibPyramid, cam_to_world: torch.Tensor,
                      z_near: float = 2.0, z_far: float = 6.0, seed: int = 0,
                      lvl: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two textured planes with a vertical depth discontinuity at world
    x = 0 (x < 0 -> z_near, x >= 0 -> z_far): multi-view consistent
    imagery with 3-D structure. Returns (image, idepth) on cam_to_world's
    device."""
    w, h = calib.widths[lvl], calib.heights[lvl]
    fx, fy, cx, cy = calib.intrinsics(lvl)
    dev = cam_to_world.device
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rc = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)], -1)
    R = cam_to_world[:3, :3]
    t = cam_to_world[:3, 3]
    rw = rc @ R.T
    rz = rw[..., 2]
    rz_safe = torch.where(torch.abs(rz) < 1e-6, torch.full_like(rz, 1e-6), rz)

    def hit(plane_z):
        s = torch.clamp((plane_z - t[2]) / rz_safe, min=1e-3)
        return t + s[..., None] * rw

    p_near = hit(z_near)
    p_far = hit(z_far)
    use_near = p_near[..., 0] < 0.0
    pw = torch.where(use_near[..., None], p_near, p_far)
    img = torch.where(use_near, texture(p_near[..., :2], seed),
                      texture(p_far[..., :2], seed + 1))
    pc = (pw - t) @ R
    return img, 1.0 / torch.clamp(pc[..., 2], min=1e-3)


def make_sequence(calib: CalibPyramid, n_frames: int,
                  twist_per_frame=(0.02, 0.01, 0.015, 0.001, 0.002, 0.001),
                  plane_z: float = 2.0, seed: int = 0, device=None):
    """Constant-twist trajectory: (images (N,H,W), idepths, poses (N,4,4))
    as float32 tensors on `device` (CUDA unless named; see
    `resolve_device`)."""
    dev = resolve_device(device)
    xi = torch.as_tensor(np.asarray(twist_per_frame, np.float32), device=dev)
    step = lie.se3_exp(xi)
    imgs, idepths, poses = [], [], []
    T = torch.eye(4, dtype=torch.float32, device=dev)
    for _ in range(n_frames):
        img, idp = render_plane(calib, T, plane_z, seed)
        imgs.append(img)
        idepths.append(idp)
        poses.append(T)
        T = T @ step
    return torch.stack(imgs), torch.stack(idepths), torch.stack(poses)


# ---------------------------------------------------------------------------
# stereo + VIO scenes: a trajectory, its analytic IMU and both cameras
# ---------------------------------------------------------------------------

GRAVITY = np.array([0.0, 0.0, -9.81])
IMU_HZ = 200.0
BASELINE = 0.11          # right camera at +x in the left camera's frame

# the flagship scene (bench.py's _bench_full_config): a bounded sinusoidal
# 6-DoF trajectory with continuous non-zero acceleration (spline-VIO
# observability) that never closes on the plane
SINE_A = np.array([0.38, 0.28, 0.20])      # translation amplitudes (m)
SINE_WT = np.array([0.9, 0.7, 1.1])        # translation frequencies
SINE_B = np.array([0.05, 0.09, 0.04])      # rotation amplitudes (rad)
SINE_WR = np.array([0.8, 1.0, 0.7])        # rotation frequencies

# the small CPU scene (tests/test_fused_vio.py): a cubic trajectory with a
# constant gyro bias
CUBIC_L = np.array([0.10, 0.05, 0.08, 0.04, 0.06, 0.03])
CUBIC_Q = np.array([0.06, -0.05, 0.04, 0.02, -0.015, 0.02])
CUBIC_C = np.array([0.008, -0.006, 0.007, -0.004, 0.003, -0.004])
CUBIC_BIAS_G = np.array([0.005, -0.008, 0.006])


def sine_pose(t: float) -> np.ndarray:
    """Camera-to-world pose (4,4) f32 of the flagship scene at time t."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = lie.np_so3_exp(SINE_B * np.sin(SINE_WR * t)).astype(
        np.float32)
    T[:3, 3] = SINE_A * np.sin(SINE_WT * t)
    return T


def sine_acc(t: float) -> np.ndarray:
    """World-frame acceleration of `sine_pose`."""
    return -SINE_A * SINE_WT * SINE_WT * np.sin(SINE_WT * t)


def cubic_pose(t: float) -> np.ndarray:
    """Camera-to-world pose (4,4) f32 of the small cubic scene at time t."""
    p = CUBIC_L[:3] * t + CUBIC_Q[:3] * t * t + CUBIC_C[:3] * t ** 3
    r = CUBIC_L[3:] * t + CUBIC_Q[3:] * t * t + CUBIC_C[3:] * t ** 3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = lie.np_so3_exp(r).astype(np.float32)
    T[:3, 3] = p
    return T


def cubic_acc(t: float) -> np.ndarray:
    """World-frame acceleration of `cubic_pose`."""
    return 2 * CUBIC_Q[:3] + 6 * CUBIC_C[:3] * t


def imu_between(pose_fn, acc_fn, t0: float, t1: float,
                bias_g=(0.0, 0.0, 0.0)):
    """Analytic IMU samples (t, acc(3,) f32, gyro(3,) f32) at IMU_HZ in
    (t0, t1] of a body moving along pose_fn (the body frame is the camera
    frame): specific force in the body frame, body rates from a central
    difference of the rotation, plus a constant gyro bias."""
    out, h = [], 1e-4
    for i in range(1, int(round((t1 - t0) * IMU_HZ)) + 1):
        t = t0 + i / IMU_HZ
        R = pose_fn(t)[:3, :3]
        Wx = R.T @ ((pose_fn(t + h)[:3, :3] - pose_fn(t - h)[:3, :3])
                    / (2 * h))
        w_body = np.array([Wx[2, 1], Wx[0, 2], Wx[1, 0]])
        out.append((t, (R.T @ (acc_fn(t) + GRAVITY)).astype(np.float32),
                    (w_body + np.asarray(bias_g)).astype(np.float32)))
    return out


def stereo_T_lr(baseline: float = BASELINE):
    """(T_lr left -> right (4,4) f32, the right camera's pose in the left
    camera's frame (4,4))."""
    T_right_in_left = np.eye(4)
    T_right_in_left[0, 3] = baseline
    return (np.linalg.inv(T_right_in_left).astype(np.float32),
            T_right_in_left)


def stereo_vio_scene(calib: CalibPyramid, n_frames: int, frame_dt: float,
                     pose_fn, acc_fn, bias_g=(0.0, 0.0, 0.0),
                     baseline: float = BASELINE, plane_z: float = 2.0,
                     device=None) -> dict:
    """A stereo + IMU sequence over the textured plane, frame i at time
    i * frame_dt: `left` and `right` (n,H,W) image tensors on `device`
    (CUDA unless named), `poses` (n,4,4) numpy ground truth, `imu` the
    per-frame sample lists (the first covers (-frame_dt, 0]) and `T_lr`.
    chip_smoke.py and the card tests build their stereo + VIO scenes here;
    the CPU parity tests take the trajectories and IMU samples above."""
    dev = resolve_device(device)
    T_lr, T_rl = stereo_T_lr(baseline)
    poses = np.stack([pose_fn(i * frame_dt) for i in range(n_frames)])
    left, right = [], []
    for p in poses:
        left.append(render_plane(calib, torch.as_tensor(p, device=dev),
                                 plane_z)[0])
        right.append(render_plane(calib, torch.as_tensor(
            (p @ T_rl).astype(np.float32), device=dev), plane_z)[0])
    imu = [imu_between(pose_fn, acc_fn, (i - 1) * frame_dt, i * frame_dt,
                       bias_g) for i in range(n_frames)]
    return dict(left=torch.stack(left), right=torch.stack(right),
                poses=poses, imu=imu, T_lr=T_lr)


def metric_ate(traj: np.ndarray, poses: np.ndarray):
    """(ATE, path length) of a trajectory (`id x y z` rows) against the
    ground-truth poses, with no alignment: the metric gate of the stereo
    and VIO scenes is ATE <= 0.15 * path + 0.03."""
    ids = traj[:, 0].astype(int)
    gt = poses[ids, :3, 3]
    err = np.linalg.norm(traj[:, 1:4] - gt, axis=1)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return float(np.sqrt(np.mean(err ** 2))), path


# (P, F) of the fused BA iteration and (N, F) of the activation pass that no
# block size divides, for holding the kernels to their plain forms at the
# edges: F = 1..16 need not divide a warp, P and N need not fill a block
K3_RAGGED_SHAPES = ((100, 1), (100, 3), (100, 5), (512, 8), (512, 16),
                    (2048 + 37, 5), (2048 + 37, 8), (2048 + 37, 16))
K4_RAGGED_SHAPES = ((100, 1), (100, 3), (515, 5), (1024 + 37, 8), (515, 16))


def make_window(P: int, F: int, seed: int = 0, w: int = 160, h: int = 120,
                plane_z: float = 2.0):
    """A BA window of P point slots and F frames of the textured plane, as
    numpy: (dict of ops/ba.BAState fields, dI (F,h,w,3) [I,dx,dy]). Every
    random draw comes from numpy's RandomState(seed), so the same window
    can be handed to any implementation. Built to reach every branch of
    the fused BA iteration: mixed hosts, free point slots, dropped, OOB
    and outlier residuals, per-frame thresholds, and a state moved off its
    FEJ point (so the res_toZero shift is live)."""
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils.config import PATTERN_OFFSETS
    r = np.random.RandomState(seed)
    calib = default_calib(w, h)
    fx, fy, cx, cy = calib.intrinsics(0)
    imgs, idepths, poses = make_sequence(
        calib, F, (0.04, 0.02, 0.03, 0.004, 0.008, 0.004), plane_z=plane_z,
        seed=seed, device="cpu")
    dI = torch.stack([IMG.pyramid_level_plain(im)[0] for im in imgs])
    T_eval = torch.stack([
        lie.se3_exp(torch.as_tensor(
            (0.0 if i == 0 else 0.004) * r.randn(6).astype(np.float32)))
        @ poses[i] for i in range(F)])

    host = r.randint(0, F, P).astype(np.int32)
    u = r.uniform(8, w - 9, P).astype(np.float32)
    v = r.uniform(8, h - 9, P).astype(np.float32)
    pt_valid = r.rand(P) < 0.9
    host = np.where(pt_valid, host, 0).astype(np.int32)
    pat = np.asarray(PATTERN_OFFSETS, np.float32)
    ut, vt, ht = torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(
        host).long()
    idp_true = torch.stack([IMG.interp_bilinear(idepths[i], ut, vt)
                            for i in range(F)])[ht, torch.arange(P)].numpy()
    color = torch.stack([
        IMG.interp_bilinear(imgs[i], ut[:, None] + torch.as_tensor(pat[:, 0]),
                            vt[:, None] + torch.as_tensor(pat[:, 1]))
        for i in range(F)])[ht, torch.arange(P)].numpy()
    idz = (idp_true * (1.0 + 0.05 * r.randn(P))).astype(np.float32)
    idepth = (idz * (1.0 + 0.01 * r.randn(P))).astype(np.float32)

    fr = np.arange(F)
    res_exist = (pt_valid[:, None] & (fr[None, :] != host[:, None])
                 & (r.rand(P, F) < 0.9))
    res_state = r.choice(np.array([0, 1, 2], np.int8), (P, F),
                         p=[0.9, 0.05, 0.05]).astype(np.int8)
    state_zero = np.zeros((F, 8), np.float32)
    state = (0.003 * r.randn(F, 8)).astype(np.float32)
    state[0] = 0.0
    c_zero = (np.array([fx, fy, cx, cy], np.float32)
              / np.array([50.0, 50.0, 50.0, 50.0], np.float32))
    D = 4 + 8 * F
    fields = dict(
        frame_valid=np.ones(F, bool), T_cw_eval=T_eval.numpy(), state=state,
        state_zero=state_zero,
        exposure=(1.0 + 0.05 * r.rand(F)).astype(np.float32),
        energy_th=(12.0 * 12.0 * 8.0 * (0.25 + 0.75 * r.rand(F))).astype(
            np.float32),
        prior=np.zeros((F, 8), np.float32),
        c=(c_zero * np.float32(1.001)).astype(np.float32), c_zero=c_zero,
        pt_valid=pt_valid, host=host, u=u, v=v,
        color=color.astype(np.float32),
        weight=(0.5 + 0.5 * r.rand(P, 8)).astype(np.float32),
        idepth=idepth * pt_valid, idepth_zero=idz * pt_valid,
        pt_prior=(50.0 * r.rand(P) * pt_valid).astype(np.float32),
        res_exist=res_exist, res_state=res_state,
        HM=np.zeros((D, D), np.float32), bM=np.zeros(D, np.float32))
    return fields, dI.numpy()


def make_act_inputs(N: int, F: int, seed: int = 0, nan_dead: bool = True):
    """Seeded numpy inputs of one activation-pass reduce at N candidates, F
    frames: hit (N,F,8,3), a, b, okf (N,F,8), color, weights^2 (N,8),
    affine (N,F,2), oob (N,F), energy_th (N,). Taps that are not ok hold
    NaN when `nan_dead`, as on the main path."""
    r = np.random.RandomState(seed)
    hit = (r.rand(N, F, 8, 3) * [200, 20, 20] - [0, 10, 10]).astype(
        np.float32)
    a = (r.randn(N, F, 8) * 30).astype(np.float32)
    b = (r.randn(N, F, 8) * 30).astype(np.float32)
    okf = (r.rand(N, F, 8) > 0.03).astype(np.float32)
    if nan_dead:
        hit[..., 0] = np.where(okf > 0.5, hit[..., 0], np.nan)
    color = (r.rand(N, 8) * 200).astype(np.float32)
    w2 = r.rand(N, 8).astype(np.float32)
    ap = np.stack([1 + 0.1 * r.randn(N, F), 5 * r.randn(N, F)], -1).astype(
        np.float32)
    oob = (r.rand(N, F) < 0.2).astype(np.float32)
    eth = (8 * 144.0 * (0.05 + r.rand(N))).astype(np.float32)
    return hit, a, b, okf, color, w2, ap, oob, eth
