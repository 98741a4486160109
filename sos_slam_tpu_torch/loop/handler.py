"""LoopHandler: place recognition + pose-graph backend (port of
sos_slam_tpu/loop/handler.py; reference src/LoopClosure/
LoopHandler.{h,cpp}).

Consumes marginalized keyframes from the odometry front-end (hooked as a
publisher callback, the same seam as the reference's Output3DWrapper),
assembles the imitated-LiDAR scan, matches Scan Context descriptors,
verifies candidates by direct alignment then ICP, and maintains the SE(3)
pose graph (odometry edges weighted by dso_error/scale_error).

Like the reference (LoopHandler.cpp:48-49,222-234) the work runs on a
WORKER THREAD behind a queue: `on_keyframe` only enqueues, so place
recognition / verification / pose-graph optimization never stall the
keyframe path. Construct with `async_mode=False` for synchronous
processing, where errors propagate (tests); `join()` drains the queue
either way. The worker catches and prints its exceptions, as the
reference does.

The direct alignment, ICP and the pose graph run on `device` (CUDA unless
the caller names another); Scan Context stays host numpy in float64. The
worker thread issues its CUDA work on the same (legacy default) stream as
the odometry: a keyframe record's pyramid was written on that stream, so
the order of the two threads' work on the card needs no event, and the
loop's work is small next to the odometry's, so serializing them costs
little. Each verification and each optimization reads its results back
with one copy to the host.

Pose-graph optimization runs only when a loop edge is added: without loop
edges the graph is a chain with its last vertex fixed, whose optimum is
the odometry itself. After optimization every frame's pose is rewritten
and pushed to attached viewers (modifyKeyframePoseByKFID,
LoopHandler.cpp:352-372).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from sos_slam_tpu_torch import resolve_device
from sos_slam_tpu_torch.loop import pose_estimator as PE
from sos_slam_tpu_torch.loop import pose_graph as PG
from sos_slam_tpu_torch.loop import scancontext as SC
from sos_slam_tpu_torch.utils.config import Settings

DSO_ERROR_SCALE = 5.0
SCALE_ERROR_SCALE = 0.1
DIRECT_ERROR_SCALE = 0.1
ICP_ERROR_SCALE = 1.0
MAX_LOOP_PTS = 2048


class LoopHandler:
    def __init__(self, settings: Settings, intrinsics, n_levels: int,
                 ringkey_margin: int = SC.LOOP_MARGIN,
                 async_mode: bool = True, device=None):
        self.device = resolve_device(device)
        self.settings = settings
        self.intrinsics = intrinsics
        self.n_levels = n_levels
        self.enable = settings.enable_loop_closure
        self.accum = SC.ScanAccumulator(settings.loop_lidar_range,
                                        settings.enable_imu) \
            if self.enable else None
        self.ringkeys = SC.RingkeyIndex(margin=ringkey_margin)
        self.frames: List[dict] = []       # one record per marginalized KF
        self.viewers: List = []            # MapViewer-likes for write-back
        self.n_loop_edges = 0
        self.n_direct = 0
        self.n_icp = 0
        self.timing: Dict[str, List[float]] = dict(
            scan=[], ringkey=[], sc=[], direct=[], icp=[], graph=[])
        # worker thread + queue (LoopHandler.cpp:48-49,222-234); the lock
        # guards self.frames against save_poses/trajectory readers
        self.lock = threading.RLock()
        self.async_mode = async_mode
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        if async_mode:
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="loop-handler")
            self._worker.start()

    def _t(self, a, dtype=None) -> torch.Tensor:
        """A host array as a tensor on the handler's device."""
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def attach_viewer(self, viewer) -> None:
        """Register a MapViewer-like consumer for loop write-backs."""
        self.viewers.append(viewer)

    # ------------------------------------------------------------------
    def on_keyframe(self, rec: dict):
        """Producer side (publishKeyframes final=true): enqueue and return.
        rec: dict from FullSystem._export_kf with keys shell, pts_uvdi
        (M,3) [u,v,idepth_metric], intensities (M,L), pyramid (levels
        tuple), dso_error, scale_error."""
        if self.async_mode:
            self._queue.put(rec)
        else:
            self._process(rec)

    def join(self, timeout: Optional[float] = None) -> None:
        """Drain the queue (reference Output3DWrapper::join contract)."""
        if self.async_mode:
            self._queue.join()

    def close(self) -> None:
        self.join()

    def _run(self):
        while True:
            rec = self._queue.get()
            try:
                self._process(rec)
            except Exception as e:   # never kill the worker
                print(f"[loop-handler] error: {e!r}")
            finally:
                self._queue.task_done()

    # ------------------------------------------------------------------
    def _process(self, rec: dict):
        import time as _time
        sh = rec["shell"]
        T_wc = np.asarray(
            sh.cam_to_world_scaled if sh.cam_to_world_scaled is not None
            else sh.cam_to_world, np.float64)

        frame = dict(
            kf_id=len(self.frames), incoming_id=sh.id, shell=sh,
            T_wc=T_wc.copy(), T_opt=T_wc.copy(),
            edges=[], loop_edges=[], sig=None, pts_sc=np.zeros((0, 3)),
            T_sc_rig=np.eye(4), pyramid=rec.get("pyramid"),
            dso_error=rec.get("dso_error", np.nan),
            scale_error=rec.get("scale_error", -1.0),
            intensities=rec.get("intensities"),
            pts_cam=None,
        )

        # odometry edge to the previous KF (LoopHandler.cpp:236-244)
        with self.lock:
            if self.frames:
                prv = self.frames[-1]
                T_prv_cur = np.linalg.inv(prv["T_wc"]) @ T_wc
                dso_err = frame["dso_error"]
                if np.isfinite(dso_err):
                    info = PG.edge_information(
                        max(DSO_ERROR_SCALE * dso_err, 1e-9),
                        SCALE_ERROR_SCALE * frame["scale_error"])
                    frame["edges"].append(dict(
                        id_from=prv["kf_id"], T_from_to=T_prv_cur,
                        info=np.asarray(info)))
            self.frames.append(frame)

        if not self.enable or frame["scale_error"] < 0:
            return

        pts_uvdi = rec.get("pts_uvdi")
        if pts_uvdi is None or len(pts_uvdi) == 0:
            # keep the ringkey index aligned with kf_id: every KF that
            # reaches the loop stage must insert exactly one key (a far
            # sentinel for empty scans), else candidate indices from
            # search_and_insert would point at the wrong frames
            self.ringkeys.search_and_insert(
                np.full(SC.NUM_R, 1e9, np.float64))
            return
        fx, fy, cx, cy = self.intrinsics[0]
        d = np.maximum(pts_uvdi[:, 2], 1e-6)
        pts_cam = np.stack([
            (pts_uvdi[:, 0] - cx) / fx / d,
            (pts_uvdi[:, 1] - cy) / fy / d,
            1.0 / d], -1)
        frame["pts_cam"] = pts_cam

        t0 = _time.time()
        if self.settings.loop_cam_mode == "downward":
            pts_sc, T_sc_rig = SC.process_scan_downward(
                T_wc, pts_cam, self.settings.loop_lidar_range,
                self.settings.enable_imu)
        else:
            pts_sc, T_sc_rig = self.accum.process(frame["kf_id"], T_wc,
                                                  pts_cam)
        frame["pts_sc"] = pts_sc
        frame["T_sc_rig"] = T_sc_rig
        sig, ringkey, usable = SC.generate(
            pts_sc, T_sc_rig, self.settings.loop_lidar_range)
        frame["sig"] = sig
        self.timing["scan"].append(_time.time() - t0)

        # lidar-panel refresh (reference refreshLidarData, :378-388)
        scan_pts = np.asarray(pts_sc)
        for v in self.viewers:
            v.publish_scan(scan_pts, scan_pts)

        if not usable:
            self.ringkeys.search_and_insert(ringkey * 0 + 1e9)  # keep margin
            return

        t0 = _time.time()
        cands = self.ringkeys.search_and_insert(ringkey)
        self.timing["ringkey"].append(_time.time() - t0)
        cands = [c for c in cands if self.frames[c]["sig"] is not None]
        if not cands:
            return

        t0 = _time.time()
        mi, diff = SC.search_sc(sig, cands, [f["sig"] for f in self.frames])
        self.timing["sc"].append(_time.time() - t0)
        if diff >= self.settings.scan_context_thres:
            return

        matched = self.frames[mi]
        self._verify_and_close(frame, matched)

    # ------------------------------------------------------------------
    def _verify_and_close(self, frame, matched):
        import time as _time
        s = self.settings
        T_cur_matched0 = np.linalg.inv(frame["T_sc_rig"]) @ matched["T_sc_rig"]

        ok = False
        pose_error = np.inf
        T_cm = T_cur_matched0

        # direct photometric verification
        if frame.get("pyramid") is not None and \
                matched.get("pts_cam") is not None and \
                matched.get("intensities") is not None:
            t0 = _time.time()
            pts, inten, valid = _pad_points(
                matched["pts_cam"], matched["intensities"])
            pyr = tuple(p.to(self.device) for p in frame["pyramid"])
            T_est, okd, rms = PE.estimate_direct(
                pyr, self._t(pts), self._t(inten), self._t(valid),
                self._t(T_cur_matched0, torch.float32),
                self.intrinsics, self.n_levels, s.loop_direct_thres)
            T_est, okd, rms = _fetch(T_est, okd, rms)
            self.timing["direct"].append(_time.time() - t0)
            if bool(okd) and not s.loop_force_icp:
                ok = True
                T_cm = np.asarray(T_est, np.float64)
                pose_error = float(rms) * DIRECT_ERROR_SCALE
                self.n_direct += 1

        if not ok and matched["pts_sc"].shape[0] > 8 \
                and frame["pts_sc"].shape[0] > 8:
            t0 = _time.time()
            pr, vr = _pad_cloud(matched["pts_sc"])
            pc, vc = _pad_cloud(frame["pts_sc"])
            T_icp, oki, err = PE.icp(
                self._t(pr), self._t(vr), self._t(pc), self._t(vc),
                self._t(T_cm, torch.float32))
            T_icp, oki, err = _fetch(T_icp, oki, err)
            self.timing["icp"].append(_time.time() - t0)
            if bool(oki) and float(err) < s.loop_icp_thres:
                ok = True
                T_cm = np.asarray(T_icp, np.float64)
                pose_error = float(err) * ICP_ERROR_SCALE
                self.n_icp += 1

        if not ok:
            return

        # loop edge: measurement maps matched -> cur (T_matched_cur)
        info = PG.edge_information(
            max(pose_error, 1e-9),
            SCALE_ERROR_SCALE * matched["scale_error"])
        frame["loop_edges"].append(dict(
            id_from=matched["kf_id"], T_from_to=np.linalg.inv(T_cm),
            info=np.asarray(info)))
        self.n_loop_edges += 1
        for v in self.viewers:
            v.publish_loop_edge(frame["kf_id"], matched["kf_id"])

        self._optimize_graph()

        # merge the matched frame's scan into the panel (reference
        # LoopHandler.cpp:369-375)
        if len(matched["pts_sc"]):
            hom = np.concatenate(
                [matched["pts_sc"], np.ones((len(matched["pts_sc"]), 1))], 1)
            merged = (T_cm @ hom.T).T[:, :3]
            acc = np.concatenate([frame["pts_sc"], merged], 0)
            for v in self.viewers:
                v.publish_scan(np.asarray(frame["pts_sc"]), acc)

    # ------------------------------------------------------------------
    def _optimize_graph(self):
        import time as _time
        t0 = _time.time()
        with self.lock:
            n = len(self.frames)
            N = 1 << max(4, (n - 1).bit_length())
            T = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
            for i, f in enumerate(self.frames):
                T[i] = f["T_opt"]
            v_valid = np.arange(N) < n
            fixed = ~v_valid
            fixed[n - 1] = True          # fix the newest vertex
            chain, loops = [], []
            for f in self.frames:
                for e in f["edges"]:
                    chain.append((e["id_from"], f["kf_id"], e["T_from_to"],
                                  e["info"]))
                for e in f["loop_edges"]:
                    loops.append((e["id_from"], f["kf_id"], e["T_from_to"],
                                  e["info"]))
        if not chain and not loops:
            return

        def pack(edges, cap_min=16):
            E = 1 << max(cap_min.bit_length() - 1,
                         (max(len(edges), 1) - 1).bit_length())
            e_from = np.zeros(E, np.int32)
            e_to = np.zeros(E, np.int32)
            e_meas = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
            e_info = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
            e_valid = np.zeros(E, bool)
            for i, (a, b, m, info) in enumerate(edges):
                e_from[i], e_to[i] = a, b
                e_meas[i] = m
                e_info[i] = info
                e_valid[i] = True
            return e_from, e_to, e_meas, e_info, e_valid

        cf, ct, cm, ci, cv = pack(chain)
        lf, lt, lm, li, lv = pack(loops)
        T_out = PG.optimize_pose_graph(
            *(self._t(a) for a in (T, v_valid, fixed, cf, ct, cm, ci, cv,
                                   lf, lt, lm, li, lv)))
        T_out = T_out.cpu().numpy().astype(np.float64)
        with self.lock:
            # write back every pose (reference rewrites lf->tfm_w_c and
            # notifies the viewer, LoopHandler.cpp:352-368)
            for i, f in enumerate(self.frames):
                f["T_opt"] = T_out[i]
                f["T_wc"] = T_out[i].copy()
                for v in self.viewers:
                    v.modify_keyframe_pose_by_kf_id(f["kf_id"], T_out[i])
        self.timing["graph"].append(_time.time() - t0)

    # ------------------------------------------------------------------
    def save_poses(self, path: str, fmt: str = "id_xyz"):
        """poses.txt contract: `incoming_id x y z` per KF
        (LoopHandler::savePose, LoopHandler.cpp:62-76). fmt="tum" writes
        `timestamp tx ty tz qx qy qz qw` for TUM evaluation tools."""
        self.join()
        with self.lock, open(path, "w") as f:
            for fr in self.frames:
                T = fr["T_opt"]
                t = T[:3, 3]
                if fmt == "tum":
                    q = _rot_to_quat(T[:3, :3])
                    f.write(f"{fr['shell'].timestamp:.6f} "
                            f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")
                else:
                    f.write(f"{fr['incoming_id']} {t[0]:.6f} {t[1]:.6f} "
                            f"{t[2]:.6f}\n")

    def trajectory(self) -> np.ndarray:
        self.join()
        with self.lock:
            return np.array([[f["incoming_id"], *f["T_opt"][:3, 3]]
                             for f in self.frames])


def _fetch(T, ok, val):
    """(T (4,4) float64 numpy, ok bool, val float) in one copy to the
    host."""
    flat = torch.cat([T.reshape(-1).to(torch.float32), ok.reshape(1).to(
        torch.float32), val.reshape(1).to(torch.float32)]).cpu().numpy()
    return flat[:16].reshape(4, 4), bool(flat[16]), float(flat[17])


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) from a rotation matrix."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2.0
    if w > 1e-6:
        return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                         (R[0, 2] - R[2, 0]) / (4 * w),
                         (R[1, 0] - R[0, 1]) / (4 * w)])
    # fallback for w ~ 0
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 0.5
    q = np.zeros(4)
    q[1 + i] = s
    q[0] = (R[k, j] - R[j, k]) / (4 * s)
    q[1 + j] = (R[j, i] + R[i, j]) / (4 * s)
    q[1 + k] = (R[k, i] + R[i, k]) / (4 * s)
    return q


def _pad_points(pts: np.ndarray, inten: np.ndarray):
    n = min(len(pts), MAX_LOOP_PTS)
    P = np.zeros((MAX_LOOP_PTS, 3), np.float32)
    I = np.zeros((MAX_LOOP_PTS, inten.shape[1]), np.float32)
    V = np.zeros(MAX_LOOP_PTS, bool)
    P[:n] = pts[:n]
    I[:n] = inten[:n]
    V[:n] = True
    return P, I, V


def _pad_cloud(pts: np.ndarray, cap: int = 1024):
    n = min(len(pts), cap)
    P = np.zeros((cap, 3), np.float32)
    V = np.zeros(cap, bool)
    step = max(len(pts) // cap, 1)
    sel = pts[::step][:cap]
    P[:len(sel)] = sel
    V[:len(sel)] = True
    return P, V
