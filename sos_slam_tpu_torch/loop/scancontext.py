"""Scan Context place recognition on the 'imitated LiDAR scan' (port of
sos_slam_tpu/loop/scancontext.py; reference src/LoopClosure/
ScanContext.{h,cpp}).

The sparse depth map of a marginalized keyframe is treated as a LiDAR
scan, PCA-aligned to a NED-like frame and summarized as a 60-sector x
20-ring polar min-height signature; a per-ring occupancy histogram
("ringkey") gives a cheap kNN pre-filter, the full signature a
verification score.

Host numpy in float64 throughout, as in the JAX package: the loop
subsystem is asynchronous and tiny next to the odometry, and its outputs
are held exactly equal to the JAX package's. The voxel filter is the JAX
package's numpy form (its g++ module gives the same result and is not
ported).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from sos_slam_tpu_torch.utils import lie

NUM_S = 60          # sectors
NUM_R = 20          # rings
RES = (1.0, 0.5, 1.0)
CENTER_RANGE = 2.0
VAR_HEIGHT_THRES = 5.0
FLANN_NN = 3
LOOP_MARGIN = 100
RINGKEY_THRES = 0.1


def pca_align(pts: np.ndarray, T_wc: np.ndarray,
              enable_imu: bool) -> np.ndarray:
    """NED-alignment transform (getAlignTfmByPCA, ScanContext.cpp:56-104).

    pts: (N,3) camera-frame points. Returns T_ned_cam (4,4).
    """
    center = pts.mean(axis=0)
    q = pts - center
    cov = q.T @ q
    w, v = np.linalg.eigh(cov)

    if enable_imu:
        # gravity-aligned z from the current pose (ScanContext.cpp:77-82)
        z = T_wc[2, :3].copy()
    else:
        z = v[:, 0]
        if z.sum() < 0:
            z = -z

    y_cands = [v[:, 1], -v[:, 1], v[:, 2], -v[:, 2]]
    y = max(y_cands, key=lambda c: c[0])
    y = y - z.dot(y) * z
    y = y / max(np.linalg.norm(y), 1e-12)
    x = np.cross(y, z)

    T = np.eye(4)
    T[0, :3] = x
    T[1, :3] = y
    T[2, :3] = z
    T[:3, 3] = -T[:3, :3] @ center
    return T


class ScanAccumulator:
    """Forward-camera scan assembly (process_scan_forward,
    ScanContext.cpp:106-178): accumulate recent KFs' world points, prune by
    orientation change > 0.5 rad and range, voxel-filter keeping the highest
    point per voxel."""

    def __init__(self, lidar_range: float, enable_imu: bool):
        self.lidar_range = lidar_range
        self.enable_imu = enable_imu
        self.pts_w = np.zeros((0, 3), np.float64)   # accumulated world pts
        # float64 end-to-end: the reference accumulates Vector3d; f32 here
        # drifts voxel assignments near bin edges, compounding across KFs
        self.fids = np.zeros(0, np.int64)           # source KF per point
        self.id2pose: Dict[int, np.ndarray] = {}

    def process(self, frame_id: int, T_wc: np.ndarray,
                pts_cam: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (pts_scan (M,3) camera frame, T_sc_rig (4,4))."""
        self.id2pose[frame_id] = T_wc.copy()
        R, t = T_wc[:3, :3], T_wc[:3, 3]
        if len(pts_cam):
            self.pts_w = np.concatenate(
                [self.pts_w, (np.asarray(pts_cam, np.float64) @ R.T + t)])
            self.fids = np.concatenate(
                [self.fids, np.full(len(pts_cam), frame_id, np.int64)])

        # prune frames whose orientation diverged > 0.5 rad
        T_cw = np.linalg.inv(T_wc)
        for fid in [f for f, pose in self.id2pose.items()
                    if np.linalg.norm(
                        lie.np_so3_log((T_cw @ pose)[:3, :3])) > 0.5]:
            del self.id2pose[fid]
        valid = np.isin(self.fids, np.fromiter(self.id2pose.keys(),
                                               np.int64))

        # range filter + voxel keep-highest (-y is up in camera frame)
        r = self.lidar_range
        inv_res = np.array([1.0 / RES[0], 1.0 / RES[1], 1.0 / RES[2]])
        if len(self.pts_w):
            p_l = self.pts_w[valid] @ T_cw[:3, :3].T + T_cw[:3, 3]
            src = np.flatnonzero(valid)
            inr = np.einsum("ij,ij->i", p_l, p_l) < r * r
            p_l, src = p_l[inr], src[inr]
            sizes = np.floor(2 * r * inv_res).astype(np.int64) + 1
            idx3 = np.floor((p_l + r) * inv_res).astype(np.int64)
            loc = idx3 @ np.array([1, sizes[0], sizes[0] * sizes[1]])
            # stable min-y per voxel: sort by (voxel, height), keep first
            order = np.lexsort((p_l[:, 1], loc))
            first = np.ones(len(order), bool)
            first[1:] = loc[order][1:] != loc[order][:-1]
            sel = order[first]
            keep_idx, pts_scan = src[sel], p_l[sel]
        else:
            keep_idx = np.zeros(0, np.int64)
            pts_scan = np.zeros((0, 3), np.float64)

        self.pts_w = self.pts_w[keep_idx]
        self.fids = self.fids[keep_idx]

        if len(pts_scan) < 8:
            return pts_scan, np.eye(4)
        T_sc_rig = pca_align(pts_scan, T_wc, self.enable_imu)
        return pts_scan, T_sc_rig


def process_scan_downward(T_wc: np.ndarray, pts_cam: np.ndarray,
                          lidar_range: float, enable_imu: bool):
    """Downward-camera single-frame scan alignment (process_scan_downward,
    ScanContext.cpp:180-238): PCA/gravity NED alignment, re-center on the
    highest point near the planar centroid, trim by range, normalize height.
    Returns (pts_scan camera frame, T_sc_rig)."""
    if len(pts_cam) < 8:
        return pts_cam, np.eye(4)
    T_ned = pca_align(pts_cam, T_wc, enable_imu)
    p = (T_ned[:3, :3] @ pts_cam.T).T    # rotate only (center via align pt)

    center = p[:, :2].mean(axis=0)
    near = np.linalg.norm(p[:, :2] - center, axis=1) < CENTER_RANGE
    if not near.any():
        near = np.ones(len(p), bool)
    align = p[near][np.argmin(p[near][:, 2])]     # highest = min z in NED
    p[:, :2] -= align[:2]

    keep = np.linalg.norm(p[:, :2], axis=1) < lidar_range
    p = p[keep]
    if len(p) == 0:
        return np.zeros((0, 3)), np.eye(4)
    mean_z = p[:, 2].mean()
    p[:, 2] -= mean_z

    T_sc_rig = np.eye(4)
    T_sc_rig[:3, :3] = T_ned[:3, :3]
    T_sc_rig[:3, 3] = -np.array([align[0], align[1], mean_z])
    # back to camera frame
    pts_scan = (np.linalg.inv(T_sc_rig)[:3, :3] @ p.T).T \
        + np.linalg.inv(T_sc_rig)[:3, 3]
    return pts_scan, T_sc_rig


def generate(pts_cam: np.ndarray, T_sc_rig: np.ndarray,
             lidar_range: float) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Descriptor (generate, ScanContext.cpp:240-308).

    Returns (signature (NUM_S, NUM_R) dense, 0 = empty; ringkey (NUM_R,);
    usable flag from the height-variance gate)."""
    if len(pts_cam) == 0:
        return np.zeros((NUM_S, NUM_R)), np.zeros(NUM_R), False
    p = (T_sc_rig[:3, :3] @ pts_cam.T).T + T_sc_rig[:3, 3]
    theta = np.mod(np.arctan2(p[:, 1], p[:, 0]), 2 * np.pi)
    si = np.minimum((theta / (2 * np.pi) * NUM_S).astype(int), NUM_S - 1)
    ri = (np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2) / lidar_range * NUM_R).astype(int)
    ok = ri < NUM_R
    si, ri, d = si[ok], ri[ok], p[ok, 2]

    sig = np.full((NUM_S, NUM_R), np.inf)
    np.minimum.at(sig, (si, ri), d)

    filled = np.isfinite(sig)
    ringkey = filled.sum(axis=0) / NUM_S
    vals = sig[filled]
    if vals.size == 0:
        return np.zeros((NUM_S, NUM_R)), ringkey, False
    # The reference's height-variance gate divides the mean by
    # signature.size() BEFORE the signature is filled (ScanContext.cpp:285)
    # — always zero — so ave_height is ±inf and var_height is inf whenever
    # any bin is filled: the gate effectively tests "any bin filled".
    # Golden-tested against the compiled reference; replicated for loop
    # recall parity.
    usable = bool(np.isfinite(vals).any())

    norm_si = np.sqrt(np.sum(np.where(filled, sig ** 2, 0.0), axis=1))
    sig_n = np.where(filled, sig / np.maximum(norm_si[:, None], 1e-12), 0.0)
    return sig_n, ringkey, usable


class RingkeyIndex:
    """Brute-force kNN over stored ringkeys with the insertion margin
    (search_ringkey, ScanContext.cpp:310-342; margin = 100 KFs there).

    Mirrors the reference's flann index exactly, INCLUDING its initial
    dummy row (LoopHandler.cpp:30-34): searches start once the index holds
    > FLANN_NN entries counting the dummy, the dummy can occupy one of the
    kNN slots, and returned candidates are the 0-based insertion order of
    real ringkeys (the reference's idces[i]-1). Golden-tested."""

    def __init__(self, margin: int = LOOP_MARGIN):
        self.margin = margin
        # index slot 0 = the reference's dummy row (zeros)
        self.keys: List[np.ndarray] = [np.zeros(NUM_R)]
        self.queue: List[np.ndarray] = []  # waiting `margin` frames

    def search_and_insert(self, ringkey: np.ndarray) -> List[int]:
        cands: List[int] = []
        if len(self.keys) > FLANN_NN:
            K = np.stack(self.keys)
            d = np.sum((K - ringkey[None, :]) ** 2, axis=1)
            order = np.argsort(d, kind="stable")[:FLANN_NN]
            for i in order:
                if d[i] < RINGKEY_THRES and i > 0:
                    cands.append(int(i) - 1)
        self.queue.append(ringkey.copy())
        if len(self.queue) > self.margin:
            self.keys.append(self.queue.pop(0))
        return cands


def search_sc(signature: np.ndarray, candidates: List[int],
              all_sigs: List[np.ndarray]) -> Tuple[int, float]:
    """Signature matching score (search_sc, ScanContext.cpp:344-371)."""
    best_idx, best_diff = candidates[0], 1.1
    for c in candidates:
        prod = float(np.sum(signature * all_sigs[c]))
        diff = (1.0 - prod / NUM_S) / 2.0
        if diff < best_diff:
            best_idx, best_diff = c, diff
    return best_idx, best_diff
