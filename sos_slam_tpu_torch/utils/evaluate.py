"""Trajectory evaluation: ATE RMSE with SE(3)/Sim(3) (Umeyama) alignment
(port of sos_slam_tpu/utils/evaluate.py, numpy float64 as there).

The reference's evaluation contract is offline: compare `poses.txt`
(`id x y z` per keyframe) against ground truth after alignment
(README.md:48). This module provides that comparison for the benchmark
ladder (BASELINE.md): mono runs align in Sim(3) (free scale gauge), stereo/
VIO runs in SE(3) (metric).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool) \
        -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares src -> dst alignment. Returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray,
             align_scale: bool = False) -> dict:
    """Absolute trajectory error after alignment.

    est_xyz, gt_xyz: (N, 3) associated positions.
    align_scale=True for monocular (Sim(3) gauge).
    """
    R, t, s = umeyama(est_xyz, gt_xyz, align_scale)
    aligned = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    return dict(
        rmse=float(np.sqrt((err ** 2).mean())),
        mean=float(err.mean()), median=float(np.median(err)),
        max=float(err.max()), scale=s, n=len(err),
    )


def associate_by_id(traj: np.ndarray, gt_ids: np.ndarray,
                    gt_xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Match a (N,4) [id x y z] trajectory against ground truth by frame id."""
    lut = {int(i): k for k, i in enumerate(gt_ids)}
    est, gt = [], []
    for row in traj:
        k = lut.get(int(row[0]))
        if k is not None:
            est.append(row[1:4])
            gt.append(gt_xyz[k])
    return np.asarray(est), np.asarray(gt)


def associate_by_time(est_t: np.ndarray, est_xyz: np.ndarray,
                      gt_t: np.ndarray, gt_xyz: np.ndarray,
                      max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association (TUM-style)."""
    est, gt = [], []
    j = 0
    for i, t in enumerate(est_t):
        j = int(np.searchsorted(gt_t, t))
        best = None
        for k in (j - 1, j):
            if 0 <= k < len(gt_t) and abs(gt_t[k] - t) < max_dt:
                if best is None or abs(gt_t[k] - t) < abs(gt_t[best] - t):
                    best = k
        if best is not None:
            est.append(est_xyz[i])
            gt.append(gt_xyz[best])
    return np.asarray(est), np.asarray(gt)
