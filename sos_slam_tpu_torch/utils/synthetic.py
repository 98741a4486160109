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
