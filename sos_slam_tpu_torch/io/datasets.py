"""Dataset readers: EuRoC / TUM-VI (ASL format), KITTI odometry, Malaga
and RobotCar folders (port of sos_slam_tpu/io/datasets.py; host-only, its
own copy; `imageio` is imported only when an image is read).

Replaces the reference's rosbag replay path (main.cpp:203-232): the node
reads a dataset directory directly, giving deterministic sequential
processing. Each reader yields dicts:
  {t, image (H,W) float, image_right or None, imu: [(t, acc3, gyro3), ...]}
with IMU samples in (t_prev, t].
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Iterator, List, Optional

import numpy as np


def _read_image(path: str) -> np.ndarray:
    import imageio.v2 as iio
    img = np.asarray(iio.imread(path))
    if img.ndim == 3:
        img = img.mean(-1)
    return img.astype(np.float32)


def slice_imu(imu: List, imu_i: int, t: float, t_prev: float):
    """Consume IMU samples in (t_prev, t] from the time-sorted list `imu`
    starting at index `imu_i`, appending an interpolated boundary sample at
    exactly the image timestamp from the straddling pair
    (SlamNode.cpp:146-159); the sample after the image stays queued for the
    next frame. Returns (samples, next imu_i)."""
    samples = []
    while imu_i < len(imu) and imu[imu_i][0] <= t:
        if imu[imu_i][0] > t_prev:
            samples.append(imu[imu_i])
        imu_i += 1
    if samples and imu_i < len(imu):
        t0, a0, g0 = samples[-1]
        t1, a1, g1 = imu[imu_i]
        if t0 < t < t1:
            w = (t - t0) / (t1 - t0)
            samples.append((t, (1 - w) * np.asarray(a0) + w * np.asarray(a1),
                            (1 - w) * np.asarray(g0) + w * np.asarray(g1)))
    return samples, imu_i


class EurocReader:
    """ASL folder format: mav0/cam0/data.csv + data/, mav0/imu0/data.csv.
    Also covers TUM-VI which ships the same layout."""

    def __init__(self, root: str, stereo: bool = False, use_imu: bool = False,
                 start: int = 0, end: Optional[int] = None):
        self.root = root
        cam0 = os.path.join(root, "mav0", "cam0")
        self.images = self._read_cam_csv(os.path.join(cam0, "data.csv"),
                                         os.path.join(cam0, "data"))
        self.images = self.images[start:end]
        self.stereo = stereo
        if stereo:
            cam1 = os.path.join(root, "mav0", "cam1")
            self.images_r = dict(self._read_cam_csv(
                os.path.join(cam1, "data.csv"), os.path.join(cam1, "data")))
        self.imu: List = []
        if use_imu:
            p = os.path.join(root, "mav0", "imu0", "data.csv")
            with open(p) as f:
                for row in csv.reader(f):
                    if row[0].startswith("#"):
                        continue
                    t = float(row[0]) * 1e-9
                    g = np.array(row[1:4], np.float32)
                    a = np.array(row[4:7], np.float32)
                    self.imu.append((t, a, g))

    @staticmethod
    def _read_cam_csv(csv_path, data_dir):
        out = []
        with open(csv_path) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                t = float(row[0]) * 1e-9
                out.append((t, os.path.join(data_dir, row[1].strip())))
        return out

    def __len__(self):
        return len(self.images)

    def __iter__(self) -> Iterator[dict]:
        imu_i = 0
        t_prev = -np.inf
        for t, path in self.images:
            samples, imu_i = slice_imu(self.imu, imu_i, t, t_prev)
            rec = dict(t=t, image=_read_image(path), imu=samples,
                       image_right=None)
            if self.stereo:
                # nearest-timestamp right image (ApproximateTime sync)
                key = min(self.images_r.keys(), key=lambda k: abs(k - t)) \
                    if self.images_r else None
                if key is not None and abs(key - t) < 0.01:
                    rec["image_right"] = _read_image(self.images_r[key])
            t_prev = t
            yield rec


class MalagaReader:
    """Malaga Urban dataset extract (reference tests/Malaga bundle):
    `<root>/Images/img_CAMERA1_<timestamp>_left.jpg` + `_right.jpg` pairs;
    the timestamp (seconds) is embedded in the filename."""

    def __init__(self, root: str, stereo: bool = True, start: int = 0,
                 end: Optional[int] = None):
        img_dir = os.path.join(root, "Images")
        if not os.path.isdir(img_dir):
            img_dir = root
        lefts = sorted(
            glob.glob(os.path.join(img_dir, "*_left.jpg"))
            + glob.glob(os.path.join(img_dir, "*_left.png")))
        self.pairs = []
        for lp in lefts:
            t = self._timestamp(lp)
            if t is None:
                continue
            rp = lp.replace("_left.", "_right.")
            self.pairs.append((t, lp, rp if (stereo and os.path.exists(rp))
                               else None))
        self.pairs.sort()
        self.pairs = self.pairs[start:end]
        self.stereo = stereo

    @staticmethod
    def _timestamp(path: str) -> Optional[float]:
        # img_CAMERA1_1261228749.918590_left.jpg
        base = os.path.basename(path)
        parts = base.split("_")
        for p in reversed(parts[:-1]):
            try:
                return float(p)
            except ValueError:
                continue
        return None

    def __len__(self):
        return len(self.pairs)

    def __iter__(self) -> Iterator[dict]:
        for t, lp, rp in self.pairs:
            yield dict(
                t=t, image=_read_image(lp), imu=[],
                image_right=_read_image(rp) if rp else None,
            )


class RobotCarReader:
    """Oxford RobotCar (reference tests/RobotCar bundle, preset 2):
    `<root>/stereo/left|right/<timestamp>.png` with timestamps in
    microseconds (from `stereo.timestamps` when present, else the
    filenames). Raw Bayer frames reduce to grayscale through the
    channel-mean in `_read_image` — adequate for the photometric
    front-end, which works on intensity only."""

    def __init__(self, root: str, stereo: bool = True, start: int = 0,
                 end: Optional[int] = None):
        base = os.path.join(root, "stereo")
        if not os.path.isdir(base):
            base = root
        left_dir = None
        for cand in ("left", "centre", "center"):
            d = os.path.join(base, cand)
            if os.path.isdir(d):
                left_dir = d
                break
        if left_dir is None:
            raise FileNotFoundError(f"no stereo/left|centre under {root}")
        right_dir = os.path.join(base, "right")
        self.left = sorted(glob.glob(os.path.join(left_dir, "*.png")))
        self.right_by_t = {}
        if stereo and os.path.isdir(right_dir):
            for p in glob.glob(os.path.join(right_dir, "*.png")):
                self.right_by_t[self._stamp(p)] = p
        ts_file = os.path.join(root, "stereo.timestamps")
        stamps = {}
        if os.path.exists(ts_file):
            with open(ts_file) as f:
                for line in f:
                    cols = line.split()
                    if cols:
                        stamps[int(cols[0])] = int(cols[0])
        self.frames = []
        for p in self.left:
            s = self._stamp(p)
            if stamps and s not in stamps:
                continue
            self.frames.append((s, p))
        self.frames.sort()
        self.frames = self.frames[start:end]
        self.stereo = stereo

    @staticmethod
    def _stamp(path: str) -> int:
        return int(os.path.splitext(os.path.basename(path))[0])

    def __len__(self):
        return len(self.frames)

    def __iter__(self) -> Iterator[dict]:
        for s, p in self.frames:
            rp = self.right_by_t.get(s)
            yield dict(
                t=s * 1e-6, image=_read_image(p), imu=[],
                image_right=_read_image(rp) if rp else None,
            )


class KittiReader:
    """KITTI odometry: sequences/NN/image_0/*.png + times.txt."""

    def __init__(self, seq_dir: str, stereo: bool = True, start: int = 0,
                 end: Optional[int] = None):
        self.left = sorted(glob.glob(os.path.join(seq_dir, "image_0", "*.png")))
        self.right = sorted(glob.glob(os.path.join(seq_dir, "image_1", "*.png")))
        times_f = os.path.join(seq_dir, "times.txt")
        self.times = np.loadtxt(times_f) if os.path.exists(times_f) \
            else np.arange(len(self.left)) * 0.1
        self.stereo = stereo and len(self.right) == len(self.left)
        sl = slice(start, end)
        self.left = self.left[sl]
        self.right = self.right[sl] if self.stereo else []
        self.times = self.times[sl]

    def __len__(self):
        return len(self.left)

    def __iter__(self) -> Iterator[dict]:
        for i, path in enumerate(self.left):
            yield dict(
                t=float(self.times[i]), image=_read_image(path), imu=[],
                image_right=_read_image(self.right[i]) if self.stereo else None,
            )
