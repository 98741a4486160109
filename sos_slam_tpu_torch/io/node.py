"""SlamNode: the top-level driver tying IO, undistortion, the odometry
front-end and the loop-closure backend together (port of
sos_slam_tpu/io/node.py).

Rebuild of src/SlamNode.{h,cpp} + src/main.cpp: owns the undistorters and
the FullSystem; feeds time-aligned images + IMU; handles
**reinitialization**: on initFailed the FullSystem is rebuilt carrying
over the current pose, KF count and output wrappers (SlamNode.cpp:
173-191), and the restart is NaN-marked in the pose graph so no odometry
edge bridges the gap.

Every frame is taken to the device once; the photometric correction and
the remap run there (the JAX package's non-native branch; its g++ module
computes the same on the host and is not ported).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sos_slam_tpu_torch import resolve_device
from sos_slam_tpu_torch.io.output_wrapper import PoseRecorder
from sos_slam_tpu_torch.io.undistort import PhotometricUndistorter, \
    load_undistorter
from sos_slam_tpu_torch.loop.handler import LoopHandler
from sos_slam_tpu_torch.models.full_system import FullSystem, StereoCalib
from sos_slam_tpu_torch.utils.camera import make_calib_pyramid
from sos_slam_tpu_torch.utils.config import Settings


class SlamNode:
    def __init__(self, settings: Settings,
                 calib0: str,
                 calib1: Optional[str] = None,
                 T_stereo: Optional[np.ndarray] = None,   # left -> right
                 gamma0: Optional[str] = None,
                 vignette0: Optional[str] = None,
                 device=None, async_loop: bool = True,
                 jax_form: bool = False):
        """`jax_form=True` reproduces the JAX package's remap of `none`
        rectification and its VIO prior fold (`load_undistorter`,
        `FullSystem`; for the parity tests only)."""
        self.device = resolve_device(device)
        self.settings = settings
        self.jax_form = jax_form
        self.und0 = load_undistorter(calib0, jax_form)
        self.und1 = load_undistorter(calib1, jax_form) if calib1 else None
        self.photo0 = PhotometricUndistorter(
            gamma0, vignette0, w=self.und0.w_org, h=self.und0.h_org,
            mode=settings.photometric_calibration) \
            if gamma0 else None

        fx, fy, cx, cy = self.und0.intrinsics()
        self.calib = make_calib_pyramid(self.und0.w, self.und0.h, fx, fy, cx,
                                        cy)
        self.stereo = None
        if settings.enable_scale_opt:
            if self.und1 is None or T_stereo is None:
                raise ValueError("stereo mode needs calib1 + T_stereo")
            fx1, fy1, cx1, cy1 = self.und1.intrinsics()
            calib_r = make_calib_pyramid(self.und1.w, self.und1.h,
                                         fx1, fy1, cx1, cy1)
            self.stereo = StereoCalib(T_lr=np.asarray(T_stereo),
                                      calib_right=calib_r)

        intr = tuple(self.calib.intrinsics(l)
                     for l in range(self.calib.levels))
        self.loop = LoopHandler(settings, intr, self.calib.levels,
                                async_mode=async_loop, device=self.device)
        self.pose_recorder = PoseRecorder()
        self.extra_wrappers = []
        self.prev_kf_size = 0
        self.cur_pose = np.eye(4)
        self._new_system()
        self.n_frames = 0

    def add_viewer(self, viewer) -> None:
        """Register a MapViewer-like wrapper: receives the publisher events
        AND the loop closure's pose write-backs (the reference wires the
        Pangolin viewer into both, SlamNode.cpp:56-60 +
        LoopHandler.cpp:352-372)."""
        self.extra_wrappers.append(viewer)
        self.fs.output_wrappers.append(viewer)
        self.loop.attach_viewer(viewer)

    def _new_system(self):
        self.fs = FullSystem(self.calib, self.settings, stereo=self.stereo,
                             device=self.device, jax_form=self.jax_form)
        self.fs.marg_callbacks.append(self._on_marginalized_kf)
        self.fs.output_wrappers.append(self.pose_recorder)
        self.fs.output_wrappers.extend(self.extra_wrappers)
        self._restarted = self.prev_kf_size > 0
        if self._restarted:
            # carry the trajectory across the restart: the rebuilt system's
            # first KF resumes at the pre-failure pose
            # (SlamNode.cpp:174-189 `fullSystem->curPose = lastPose`)
            self.fs.initial_pose = np.asarray(self.cur_pose).copy()

    def _preprocess(self, image, und, photo):
        """Photometric correction (response LUT + vignette) and remap, on
        the device."""
        img = torch.as_tensor(np.array(image, np.float32)
                              if not torch.is_tensor(image) else image,
                              dtype=torch.float32).to(self.device)
        if photo is not None and img.dim() == 2:
            img = photo.process_tensor(img)
        return und.undistort(img)

    def _on_marginalized_kf(self, rec):
        # NaN-mark the first KF after a restart (no odometry edge bridges it,
        # FullSystemMarginalize.cpp:189-194)
        if self._restarted:
            rec["dso_error"] = float("nan")
            self._restarted = False
        self.loop.on_keyframe(rec)

    # ------------------------------------------------------------------
    def process(self, image: np.ndarray, timestamp: float,
                image_right: Optional[np.ndarray] = None,
                imu_samples=None, exposure: float = 1.0):
        """imageMessageCallback + process (SlamNode.cpp:88-171)."""
        img_u = self._preprocess(image, self.und0, self.photo0)
        img_r = None
        if image_right is not None and self.und1 is not None:
            img_r = self._preprocess(image_right, self.und1, None)

        self.fs.add_active_frame(img_u, timestamp, self.n_frames,
                                 exposure=exposure, image_right=img_r,
                                 imu_samples=imu_samples)
        self.n_frames += 1

        if not self.fs.is_lost and self.fs.shells:
            self.cur_pose = self.fs.shells[-1].cam_to_world

        # reinitialization (SlamNode.cpp:173-191)
        if self.fs.init_failed:
            self.prev_kf_size += self.fs.stats["n_kf"]
            self._new_system()

    def run(self, reader, max_frames: Optional[int] = None) -> int:
        n = 0
        for rec in reader:
            self.process(rec["image"], rec["t"],
                         image_right=rec.get("image_right"),
                         imu_samples=rec.get("imu"))
            n += 1
            if self.fs.is_lost:
                break
            if max_frames and n >= max_frames:
                break
        return n

    def save_poses(self, path: str):
        self.loop.save_poses(path)
