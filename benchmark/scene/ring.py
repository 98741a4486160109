"""The benchmark's scene: a periodic 6-DoF flight over a textured plane,
rendered as the raw, distorted 8-bit frames of a EuRoC-class camera, and
the 200 Hz IMU of the same flight.

Rewritten from the program's synthetic scenes (the plane renderer, the
sine trajectory and the IMU of the flagship scene) so that the yardstick
does not move when the program does. What makes it a served input:

- the renderer draws the *distorted* raw frame: for each raw pixel the
  RadTan model is inverted by fixed-point iterations to a ray, the ray
  meets the plane, and a dead-leaves texture (not periodic, unlike a sum
  of sinusoids, whose repeats mislead the epipolar search) is sampled
  there, then quantized to uint8;
- the trajectory is a sum of whole harmonics of one period, so frame
  k + ring is frame k and the IMU is periodic too: a ring rendered once
  feeds a window of any length without a seam.

The scene (the texture, from the traffic's texture seed), the flight and
the camera's sensor noise (from the traffic's noise seed, added to every
rendered frame before it is quantized, on the device) are the same for
every run seed, and every run starts at flight frame 0, so the window
(which opens at a fixed frame of the flight) serves every run the same
frames: the same work. The port's cost per frame moves with the noise
realization (it decides when the tracker meets the flight's hard
stretch), so a noise drawn from the run's seed would change the work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.camera import CameraModel

GRAVITY = np.array([0.0, 0.0, -9.81])


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one named stream of a seed (any whole number,
    negative or beyond 64 bits included)."""
    return np.random.default_rng([abs(int(seed)) % (1 << 64),
                                  int(seed < 0), stream])


# ---------------------------------------------------------------------------
# the trajectory
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Flight:
    """pose(t) = [exp(B * sin(wr t + pr)), A * sin(wt t + pt)], camera to
    world, the camera looking along +z at the plane z = plane_z."""
    A: np.ndarray        # translation amplitudes (m)
    wt: np.ndarray       # translation angular rates (rad/s)
    pt: np.ndarray       # translation phases
    B: np.ndarray        # rotation amplitudes (rad)
    wr: np.ndarray       # rotation angular rates (rad/s)
    pr: np.ndarray       # rotation phases
    plane_z: float

    @staticmethod
    def from_traffic(traffic: dict) -> "Flight":
        T = float(traffic["period_s"])
        zero = np.zeros(3)
        return Flight(
            A=np.asarray(traffic["translation_amp_m"], np.float64),
            wt=2 * math.pi * np.asarray(traffic["translation_harmonics"],
                                        np.float64) / T,
            pt=zero,
            B=np.asarray(traffic["rotation_amp_rad"], np.float64),
            wr=2 * math.pi * np.asarray(traffic["rotation_harmonics"],
                                        np.float64) / T,
            pr=zero,
            plane_z=float(traffic["plane_z_m"]))

    def poses(self, t: np.ndarray) -> np.ndarray:
        """(N,4,4) float64 camera-to-world poses at times t."""
        t = np.asarray(t, np.float64)[:, None]
        out = np.tile(np.eye(4), (t.shape[0], 1, 1))
        out[:, :3, :3] = so3_exp(self.B * np.sin(self.wr * t + self.pr))
        out[:, :3, 3] = self.A * np.sin(self.wt * t + self.pt)
        return out


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues, (N,3) -> (N,3,3), float64."""
    th = np.linalg.norm(w, axis=-1)[:, None, None]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[:, 0, 1], K[:, 0, 2] = -w[:, 2], w[:, 1]
    K[:, 1, 0], K[:, 1, 2] = w[:, 2], -w[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -w[:, 1], w[:, 0]
    small = th < 1e-8
    a = np.where(small, 1.0, np.sin(th) / np.where(small, 1.0, th))
    b = np.where(small, 0.5, (1 - np.cos(th)) / np.where(small, 1.0, th * th))
    return np.eye(3) + a * K + b * (K @ K)


# ---------------------------------------------------------------------------
# the texture and the distorted renderer
# ---------------------------------------------------------------------------

class Texture:
    """The plane's texture: a dead-leaves image (opaque disks of random
    gray, radii from a power law, painted one over another, as natural
    images are modelled), blurred by one texel so that it is band-limited,
    over a square of the plane centred on the origin. Not periodic, so an
    epipolar search has one true match. Made on the host from the
    traffic's texture seed; sampled bilinearly on any device."""

    def __init__(self, traffic: dict):
        t = traffic["texture"]
        self.extent = float(t["extent_m"])
        n = int(round(self.extent / float(t["texel_m"])))
        rng = np.random.default_rng(int(t["seed"]))
        r_lo, r_hi = (v / float(t["texel_m"]) for v in t["radius_m"])
        img = np.full((n, n), 128.0, np.float32)
        yy, xx = np.mgrid[0:n, 0:n]
        for _ in range(int(t["disks"])):
            # radius density ~ 1/r^3 between r_lo and r_hi (scale invariant)
            u = rng.random()
            r = r_lo * r_hi / np.sqrt(r_hi ** 2 - u * (r_hi ** 2 - r_lo ** 2))
            cx, cy = rng.uniform(0, n, 2)
            x0, x1 = int(max(cx - r, 0)), int(min(cx + r + 1, n))
            y0, y1 = int(max(cy - r, 0)), int(min(cy + r + 1, n))
            if x0 >= x1 or y0 >= y1:
                continue
            sub = (xx[y0:y1, x0:x1] - cx) ** 2 + (yy[y0:y1, x0:x1] - cy) ** 2
            img[y0:y1, x0:x1][sub <= r * r] = rng.uniform(20.0, 235.0)
        k = np.exp(-0.5 * np.arange(-3, 4) ** 2)
        k /= k.sum()
        img = np.apply_along_axis(np.convolve, 0, img, k, "same")
        img = np.apply_along_axis(np.convolve, 1, img, k, "same")
        self.image = img.astype(np.float32)
        self._on = {}

    def sample(self, xy: torch.Tensor) -> torch.Tensor:
        """Bilinear samples at world points (..., 2) in metres."""
        dev = xy.device
        if dev not in self._on:
            self._on[dev] = torch.as_tensor(self.image, device=dev)[None,
                                                                    None]
        grid = (xy / (0.5 * self.extent)).to(torch.float32)
        shape = grid.shape[:-1]
        out = torch.nn.functional.grid_sample(
            self._on[dev], grid.reshape(1, 1, -1, 2), mode="bilinear",
            padding_mode="reflection", align_corners=False)
        return out.reshape(shape).to(xy.dtype)


def raw_rays(cam: CameraModel) -> np.ndarray:
    """(h_raw, w_raw, 3) float64 rays [x, y, 1] of the raw pixels: the
    distortion inverted per pixel by fixed-point iterations."""
    fx, fy, cx, cy = cam.pars[:4]
    yy, xx = np.meshgrid(np.arange(cam.h_raw, dtype=np.float64),
                         np.arange(cam.w_raw, dtype=np.float64),
                         indexing="ij")
    xd, yd = (xx - cx) / fx, (yy - cy) / fy
    x, y = cam.undistort_normalized(xd, yd)
    return np.stack([x, y, np.ones_like(x)], -1)


def render(rays: torch.Tensor, poses: torch.Tensor, plane_z: float,
           tex: Texture, noise_sigma: float = 0.0,
           gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(N, h, w) uint8 frames of the plane from camera-to-world poses
    (N,4,4) float32, rays (h, w, 3) float32, on the rays' device, with
    Gaussian sensor noise of `noise_sigma` intensity units drawn from
    `gen` (a generator on that device)."""
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    rw = torch.einsum("hwj,nij->nhwi", rays, R)
    rz = rw[..., 2]
    rz = torch.where(rz.abs() < 1e-6, torch.full_like(rz, 1e-6), rz)
    s = torch.clamp((plane_z - t[:, None, None, 2]) / rz, min=1e-3)
    pw = t[:, None, None, :2] + s[..., None] * rw[..., :2]
    img = tex.sample(pw)
    if noise_sigma > 0:
        img = img + noise_sigma * torch.randn(
            img.shape, generator=gen, device=img.device, dtype=img.dtype)
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def imu_samples(pose_fn, t: np.ndarray,
                bias_g=(0.0, 0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """(acc (n,3) f32, gyro (n,3) f32) at times t of a body moving along
    pose_fn(t) -> (n,4,4) (the body frame is the camera frame): the
    specific force R^T (a + g) with the acceleration a by a central second
    difference of the position, and the body rates by a central difference
    of the rotation, plus a constant gyro bias (the convention of the
    program's flagship scene)."""
    t = np.asarray(t, np.float64)
    h = 1e-3
    P0, Pp, Pm = pose_fn(t), pose_fn(t + h), pose_fn(t - h)
    R = P0[:, :3, :3]
    a = (Pp[:, :3, 3] - 2 * P0[:, :3, 3] + Pm[:, :3, 3]) / (h * h)
    Wx = np.transpose(R, (0, 2, 1)) @ (Pp[:, :3, :3] - Pm[:, :3, :3]) \
        / (2 * h)
    w_body = np.stack([Wx[:, 2, 1], Wx[:, 0, 2], Wx[:, 1, 0]], -1)
    acc = np.einsum("nji,nj->ni", R, a + GRAVITY)
    return (acc.astype(np.float32),
            (w_body + np.asarray(bias_g, np.float64)).astype(np.float32))


@dataclass
class Ring:
    """One period of the flight, on the host: frames (ring, h, w) uint8 per
    camera, the ground-truth left-camera poses (ring, 4, 4) float64 and the
    IMU (ring * imu_per_frame, 3) per channel. The run's frame k is ring
    frame k mod ring, replayed without a seam."""
    left: np.ndarray
    right: Optional[np.ndarray]
    poses: np.ndarray
    acc: Optional[np.ndarray]
    gyro: Optional[np.ndarray]
    fps: float
    imu_per_frame: int
    flight: Flight

    @property
    def n(self) -> int:
        return self.poses.shape[0]

    def index(self, k: int) -> int:
        """The ring frame of the run's frame k."""
        return k % self.n

    def frame(self, k: int, cam: int = 0) -> np.ndarray:
        return (self.left if cam == 0 else self.right)[self.index(k)]

    def frame_time(self, k: int) -> float:
        return k / self.fps

    def gt_pose(self, k: int) -> np.ndarray:
        return self.poses[self.index(k)]

    def imu_for(self, k: int) -> List[tuple]:
        """The samples of the run's frame k, in ((k-1)/fps, k/fps] of the
        flight's clock: (t, acc(3,), gyro(3,))."""
        m = self.imu_per_frame
        n_imu = self.acc.shape[0]
        out = []
        for i in range(m * (k - 1) + 1, m * k + 1):
            j = i % n_imu
            out.append((i / (self.fps * m), self.acc[j], self.gyro[j]))
        return out


def make_ring(traffic: dict, config: dict, cams: List[CameraModel],
              device, chunk: int = 64) -> Ring:
    """Render the cell's ring on `device`, with the traffic's sensor noise,
    and copy it to the host."""
    fps = float(traffic["fps"])
    n = int(round(float(traffic["period_s"]) * fps))
    flight = Flight.from_traffic(traffic)
    poses = flight.poses(np.arange(n) / fps)
    tex = Texture(traffic)
    sigma = float(traffic.get("noise_sigma", 0.0))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_rng(int(traffic["noise_seed"]), 1)
                        .integers(0, 1 << 62)))
    rigs = [np.eye(4)]
    if len(cams) > 1:
        rig = np.eye(4)
        rig[:3, 3] = config["stereo_right_in_left_m"]
        rigs.append(rig)
    frames = []
    for cam, rig in zip(cams, rigs):
        rays = torch.as_tensor(raw_rays(cam), dtype=torch.float32,
                               device=device)
        out = np.empty((n, cam.h_raw, cam.w_raw), np.uint8)
        for a in range(0, n, chunk):
            P = torch.as_tensor((poses[a:a + chunk] @ rig).astype(np.float32),
                                device=device)
            out[a:a + chunk] = render(rays, P, flight.plane_z, tex, sigma,
                                      gen).cpu().numpy()
        frames.append(out)
    acc = gyro = None
    per = 0
    if config.get("imu_hz"):
        per = int(round(float(config["imu_hz"]) / fps))
        acc, gyro = imu_samples(flight.poses, np.arange(n * per)
                                / (fps * per),
                                config.get("imu_bias_g", (0.0, 0.0, 0.0)))
    return Ring(left=frames[0], right=frames[1] if len(frames) > 1 else None,
                poses=poses, acc=acc, gyro=gyro, fps=fps, imu_per_frame=per,
                flight=flight)
