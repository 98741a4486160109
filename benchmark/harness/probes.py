"""What the benchmark hooks onto the program from outside, without editing
it: an output wrapper that stamps each published pose, and a wrapper of
FullSystem.add_active_frame that keeps the undistorted frames of a sample
(for the intake check) and, in a traced run, times the call."""

from __future__ import annotations

import time
from typing import Dict, List, Set

import numpy as np

from sos_slam_tpu_torch.io.output_wrapper import Output3DWrapper


class PoseStamps(Output3DWrapper):
    """The `pose_cam0_in_world/current` publisher as a consumer sees it:
    per frame id, the host time its pose was published, that pose and the
    frame's affine brightness (a, b) beside it."""

    def __init__(self):
        self.time: Dict[int, float] = {}
        self.pose: Dict[int, np.ndarray] = {}
        self.aff: Dict[int, np.ndarray] = {}
        self.marginalized = 0

    def publish_cam_pose(self, shell, calib) -> None:
        self.time[shell.id] = time.perf_counter()
        self.pose[shell.id] = np.array(shell.cam_to_world, np.float64)
        self.aff[shell.id] = np.array(shell.aff, np.float64)

    def publish_keyframes(self, record: dict, final: bool) -> None:
        if final:
            self.marginalized += 1


class IntakeTap:
    """Wraps `fs.add_active_frame` of the node's current FullSystem."""

    def __init__(self, sample: Set[int]):
        self.sample = sample
        self.kept: Dict[int, tuple] = {}
        self.spans_ms: List[float] = []
        self.timing = False
        self.annotate = False       # a torch.profiler range around the call
        self._fs = None

    def attach(self, fs) -> None:
        if fs is self._fs:
            return
        self._fs = fs
        inner = fs.add_active_frame

        def add_active_frame(image, timestamp, frame_id, exposure=1.0,
                             image_right=None, imu_samples=None):
            if frame_id in self.sample:
                self.kept[frame_id] = (
                    image.clone(),
                    None if image_right is None else image_right.clone())
            if self.annotate:
                from torch.profiler import record_function
                with record_function("FullSystem.add_active_frame"):
                    return inner(image, timestamp, frame_id,
                                 exposure=exposure, image_right=image_right,
                                 imu_samples=imu_samples)
            if not self.timing:
                return inner(image, timestamp, frame_id, exposure=exposure,
                             image_right=image_right,
                             imu_samples=imu_samples)
            t0 = time.perf_counter()
            try:
                return inner(image, timestamp, frame_id, exposure=exposure,
                             image_right=image_right,
                             imu_samples=imu_samples)
            finally:
                self.spans_ms.append((time.perf_counter() - t0) * 1e3)

        fs.add_active_frame = add_active_frame

    def host_frames(self) -> Dict[int, tuple]:
        """The kept frames as float32 numpy, after the window."""
        return {k: tuple(None if x is None else x.float().cpu().numpy()
                         for x in v) for k, v in self.kept.items()}
