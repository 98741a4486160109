"""Trajectory arithmetic of the yardstick, NumPy float64: the Umeyama
alignment and the ATE RMSE (copied from the program's utils/evaluate.py),
and rotation angles."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool) \
        -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares src -> dst alignment (N,3) -> (R, t, s)."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    return R, mu_d - s * R @ mu_s, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align_scale: bool) -> float:
    """RMSE of est (N,3) against gt after a Sim(3) (or SE(3)) alignment."""
    R, t, s = umeyama(est, gt, align_scale)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of est (N,3) against gt with no alignment."""
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def angle(R: np.ndarray) -> np.ndarray:
    """Rotation angles (rad) of (..., 3, 3) rotations."""
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5
    A = R - np.swapaxes(R, -1, -2)
    s = 0.5 * np.sqrt(A[..., 2, 1] ** 2 + A[..., 0, 2] ** 2
                      + A[..., 1, 0] ** 2)
    return np.arctan2(s, c)
