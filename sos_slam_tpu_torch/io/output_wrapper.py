"""Output3DWrapper: the publisher seam between odometry and consumers (port
of sos_slam_tpu/io/output_wrapper.py).

Rebuild of src/IOWrapper/Output3DWrapper.h: an abstract interface that the
front-end calls with camera poses, keyframes (final = marginalized), live
frames, and depth images. The reference hooks its loop closure, ROS
publishers, and the Pangolin GUI through this seam; here the LoopHandler and
the recorders below do the same.

Implementations:
  * `PoseRecorder` — the `pose_cam0_in_world/{current,marginalized}` topics
    as in-memory streams (and optional files).
  * `DepthImageDumper` — debug depth/residual overlays as PNGs
    (FullSystemDebugStuff analog, dev-only).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


class Output3DWrapper:
    """Usage contract mirrors Output3DWrapper.h:44-201."""

    def publish_cam_pose(self, shell, calib) -> None:
        """Current frame pose, called for every tracked frame."""

    def publish_keyframes(self, record: dict, final: bool) -> None:
        """final=False: KF entered the window; final=True: marginalized."""

    def publish_graph(self, connectivity) -> None:
        """Window co-observability graph."""

    def push_live_frame(self, image) -> None:
        """The new frame about to be tracked."""

    def push_depth_image(self, image, idepth_map) -> None:
        """Semi-dense inverse-depth visualization of the tracking ref."""

    def join(self) -> None:
        """Flush/terminate."""

    def reset(self) -> None:
        """System re-initialization."""


class PoseRecorder(Output3DWrapper):
    """pose_cam0_in_world/{current,marginalized} (LoopHandler.cpp:54-57)."""

    def __init__(self, current_file: Optional[str] = None,
                 marginalized_file: Optional[str] = None):
        self.current: List = []
        self.marginalized: List = []
        self.current_file = current_file
        self.marginalized_file = marginalized_file

    @staticmethod
    def _row(shell):
        T = shell.cam_to_world_scaled if shell.cam_to_world_scaled is not None \
            else shell.cam_to_world
        # numpy rotation log: the shells' poses are host float64
        R = np.asarray(T[:3, :3])
        cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
        theta = np.arccos(cos_t)
        if theta < 1e-6:
            q = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                R[1, 0] - R[0, 1]])
        else:
            q = theta / (2 * np.sin(theta)) * np.array(
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return [shell.timestamp, *T[:3, 3], *q]

    def publish_cam_pose(self, shell, calib) -> None:
        self.current.append(self._row(shell))

    def publish_keyframes(self, record: dict, final: bool) -> None:
        if final:
            self.marginalized.append(self._row(record["shell"]))

    def join(self) -> None:
        for path, rows in ((self.current_file, self.current),
                           (self.marginalized_file, self.marginalized)):
            if path and rows:
                np.savetxt(path, np.asarray(rows), fmt="%.6f")

    def reset(self) -> None:
        pass  # streams continue across re-initializations


class DepthImageDumper(Output3DWrapper):
    """Debug visualization (FullSystemDebugStuff.cpp analog): writes the
    tracking reference's semi-dense idepth overlay as PNGs."""

    def __init__(self, out_dir: str, every: int = 1):
        self.out_dir = out_dir
        self.every = every
        self.n = 0
        os.makedirs(out_dir, exist_ok=True)

    def push_depth_image(self, image, idepth_map) -> None:
        self.n += 1
        if self.n % self.every:
            return
        import imageio.v2 as iio
        img = np.asarray(image)
        idp = np.asarray(idepth_map)
        rgb = np.stack([img, img, img], -1)
        rgb = (255 * (rgb - rgb.min()) / max(rgb.ptp(), 1e-6)).astype(np.uint8)
        has = idp > 0
        if has.any():
            lo, hi = np.percentile(idp[has], [5, 95])
            t = np.clip((idp - lo) / max(hi - lo, 1e-6), 0, 1)
            rgb[has, 0] = (255 * t[has]).astype(np.uint8)
            rgb[has, 1] = (255 * (1 - t[has])).astype(np.uint8)
            rgb[has, 2] = 60
        iio.imwrite(os.path.join(self.out_dir, f"depth_{self.n:06d}.png"), rgb)
