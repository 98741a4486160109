"""Headless map viewer (port of sos_slam_tpu/io/viewer.py) — the Pangolin
GUI analog (PangolinSOSVIOViewer).

Rebuild of src/IOWrapper/Pangolin/PangolinSOSVIOViewer.{h,cpp} +
KeyFrameDisplay.{h,cpp} as an offline renderer: no GL window, but the same
data flow and feature set —

  * consumes only FINAL (marginalized) keyframes into per-KF point clouds
    (KeyFrameDisplay VBO analog, PangolinSOSVIOViewer.cpp:227-268);
  * full camera trajectory from publish_cam_pose;
  * loop-closure edge rendering (:207-225);
  * `modify_keyframe_pose_by_kf_id` lets the loop closure rewrite displayed
    poses (:270-275);
  * "lidar" scan panel points (green current / red accumulated, :285-297);
  * UI vars frame id / scale / scale_err / bias norms (:116-123) written
    beside the frames;
  * video + KF-depth side panels via push_live_frame / push_depth_image.

Every input is a host record (the odometry's records hold numpy copies),
and rendering is plain numpy, the JAX package's arithmetic: orthographic
top-down (x-z) and side (x-y) projections of the map, written as PNG
frames by `render()` through the port's own writer (io/png.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from sos_slam_tpu_torch.io.output_wrapper import Output3DWrapper
from sos_slam_tpu_torch.io.png import write_png


class KeyFrameDisplay:
    """Per-keyframe point cloud in world coordinates (KeyFrameDisplay.h)."""

    def __init__(self, kf_id: int, T_wc: np.ndarray, pts_cam: np.ndarray):
        self.kf_id = kf_id
        self.T_wc = np.asarray(T_wc, np.float64).copy()
        self.pts_cam = np.asarray(pts_cam, np.float32).reshape(-1, 3)

    def world_points(self) -> np.ndarray:
        if self.pts_cam.size == 0:
            return np.zeros((0, 3), np.float32)
        R = self.T_wc[:3, :3]
        t = self.T_wc[:3, 3]
        return (self.pts_cam @ R.T + t).astype(np.float32)


class MapViewer(Output3DWrapper):
    """Offline Pangolin-analog. Register via FullSystem.output_wrappers."""

    def __init__(self, out_dir: Optional[str] = None, size: int = 640,
                 max_points_per_kf: int = 4096):
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.size = size
        self.max_points_per_kf = max_points_per_kf
        self.keyframes: Dict[int, KeyFrameDisplay] = {}
        self.trajectory: List[np.ndarray] = []
        self.loop_edges: List = []          # (kf_id_a, kf_id_b)
        self.scan_cur = np.zeros((0, 3), np.float32)
        self.scan_acc = np.zeros((0, 3), np.float32)
        self.ui = dict(frame_id=0, scale=1.0, scale_err=-1.0,
                       ba_norm=0.0, bg_norm=0.0)
        self.live_frame = None
        self.depth_frame = None
        self.n_rendered = 0

    # ---- Output3DWrapper interface -----------------------------------
    def publish_cam_pose(self, shell, calib) -> None:
        T = shell.cam_to_world_scaled if shell.cam_to_world_scaled is not None \
            else shell.cam_to_world
        self.trajectory.append(np.asarray(T[:3, 3], np.float64).copy())
        self.ui["frame_id"] = shell.id
        self.ui["scale"] = getattr(shell, "scale", 1.0)

    def publish_keyframes(self, record: dict, final: bool) -> None:
        if not final:
            return  # like the reference viewer: final KFs only (:227)
        sh = record["shell"]
        pts = record.get("pts_uvdi")
        pts_cam = np.zeros((0, 3), np.float32)
        if pts is not None and len(pts):
            pts = np.asarray(pts)[: self.max_points_per_kf]
            calib = record.get("calib")
            if calib is not None:
                fx, fy, cx, cy = calib
                d = np.maximum(pts[:, 2], 1e-6)
                pts_cam = np.stack([(pts[:, 0] - cx) / fx / d,
                                    (pts[:, 1] - cy) / fy / d, 1.0 / d], -1)
            else:
                pts_cam = pts
        T = sh.cam_to_world_scaled if sh.cam_to_world_scaled is not None \
            else sh.cam_to_world
        kf_id = len(self.keyframes)
        self.keyframes[kf_id] = KeyFrameDisplay(kf_id, T, pts_cam)
        self.ui["scale_err"] = record.get("scale_error", -1.0)
        if self.out_dir:
            self.render()

    def push_live_frame(self, image) -> None:
        self.live_frame = np.asarray(image)

    def push_depth_image(self, image, idepth_map) -> None:
        self.depth_frame = (np.asarray(image), np.asarray(idepth_map))

    def publish_loop_edge(self, kf_id_a: int, kf_id_b: int) -> None:
        """Loop-closure line (PangolinSOSVIOViewer.cpp:207-225)."""
        self.loop_edges.append((kf_id_a, kf_id_b))

    def publish_scan(self, cur_pts: np.ndarray, acc_pts: np.ndarray) -> None:
        """Lidar-scan panel: green current / red accumulated (:285-297)."""
        self.scan_cur = np.asarray(cur_pts, np.float32).reshape(-1, 3)
        self.scan_acc = np.asarray(acc_pts, np.float32).reshape(-1, 3)

    def modify_keyframe_pose_by_kf_id(self, kf_id: int,
                                      T_wc: np.ndarray) -> None:
        """Loop closure rewrites a displayed KF pose (:270-275)."""
        if kf_id in self.keyframes:
            self.keyframes[kf_id].T_wc = np.asarray(T_wc, np.float64).copy()

    def set_imu_ui(self, ba_norm: float, bg_norm: float) -> None:
        self.ui["ba_norm"] = float(ba_norm)
        self.ui["bg_norm"] = float(bg_norm)

    def join(self) -> None:
        if self.out_dir:
            self.render()

    def reset(self) -> None:
        self.keyframes.clear()
        self.trajectory.clear()
        self.loop_edges.clear()

    # ---- rendering ----------------------------------------------------
    def _bounds(self):
        pts = [p for kf in self.keyframes.values()
               for p in (kf.world_points(),) if len(p)]
        traj = np.asarray(self.trajectory) if self.trajectory else \
            np.zeros((1, 3))
        allp = np.concatenate([traj] + pts, 0) if pts else traj
        lo = np.percentile(allp, 2, axis=0)
        hi = np.percentile(allp, 98, axis=0)
        c = 0.5 * (lo + hi)
        r = max(float(np.max(hi - lo)) * 0.6, 1e-3)
        return c, r

    def _project(self, pts: np.ndarray, c, r, axes=(0, 2)) -> np.ndarray:
        """World points -> integer pixel coords in one ortho panel."""
        s = self.size
        q = (pts[:, axes] - c[list(axes)]) / (2 * r) + 0.5
        px = np.clip((q * (s - 1)).astype(int), 0, s - 1)
        return px

    def render_array(self) -> np.ndarray:
        """Render the two ortho panels side by side; returns (S, 2S, 3)."""
        s = self.size
        img = np.full((s, 2 * s, 3), 16, np.uint8)
        c, r = self._bounds()
        for panel, axes in enumerate(((0, 2), (0, 1))):
            off = panel * s
            # map points, colored by height
            for kf in self.keyframes.values():
                wp = kf.world_points()
                if not len(wp):
                    continue
                px = self._project(wp, c, r, axes)
                h = np.clip((wp[:, 1] - c[1]) / (r + 1e-9) * 0.5 + 0.5, 0, 1)
                img[px[:, 1], off + px[:, 0], 0] = (80 + 120 * h).astype(np.uint8)
                img[px[:, 1], off + px[:, 0], 1] = (200 - 120 * h).astype(np.uint8)
                img[px[:, 1], off + px[:, 0], 2] = 90
            # trajectory
            if self.trajectory:
                tp = self._project(np.asarray(self.trajectory), c, r, axes)
                img[tp[:, 1], off + tp[:, 0]] = (250, 240, 60)
            # KF camera centers
            if self.keyframes:
                cc = np.stack([kf.T_wc[:3, 3] for kf in self.keyframes.values()])
                pc = self._project(cc, c, r, axes)
                img[pc[:, 1], off + pc[:, 0]] = (255, 80, 80)
            # loop edges as straight pixel lines
            for a, b in self.loop_edges:
                if a in self.keyframes and b in self.keyframes:
                    pa = self._project(self.keyframes[a].T_wc[None, :3, 3],
                                       c, r, axes)[0]
                    pb = self._project(self.keyframes[b].T_wc[None, :3, 3],
                                       c, r, axes)[0]
                    n = int(max(abs(pb[0] - pa[0]), abs(pb[1] - pa[1]), 1))
                    xs = np.linspace(pa[0], pb[0], n).astype(int)
                    ys = np.linspace(pa[1], pb[1], n).astype(int)
                    img[ys, off + xs] = (80, 160, 255)
        return img

    def render(self) -> Optional[str]:
        """Write the current map view (+ UI var sidecar) as a PNG frame."""
        if not self.out_dir:
            return None
        img = self.render_array()
        self.n_rendered += 1
        path = os.path.join(self.out_dir, f"map_{self.n_rendered:06d}.png")
        write_png(path, img)
        with open(os.path.join(self.out_dir, "ui_vars.txt"), "a") as f:
            f.write(
                f"{self.n_rendered} frame={self.ui['frame_id']} "
                f"scale={self.ui['scale']:.4f} "
                f"scale_err={self.ui['scale_err']:.4f} "
                f"ba={self.ui['ba_norm']:.4f} bg={self.ui['bg_norm']:.4f} "
                f"kfs={len(self.keyframes)} loops={len(self.loop_edges)}\n")
        return path
