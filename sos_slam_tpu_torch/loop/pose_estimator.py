"""Loop-candidate relative pose: direct alignment + small ICP (port of
sos_slam_tpu/loop/pose_estimator.py; reference src/LoopClosure/
PoseEstimator.{h,cpp}).

  * `estimate_direct`: coarse-to-fine direct photometric alignment of the
    matched keyframe's 3-D points + per-level intensities against the
    current keyframe's pyramid - the coarse tracker's 8-dim SE(3)+affine
    machinery with externally supplied points (PoseEstimator.cpp:288-494).
    Acceptance: residual < setting_loop_direct_thres, inlier fraction
    > 90%, sane affine.
  * `icp`: fixed-iteration point-to-point ICP with masked correspondences
    (replaces PCL IterativeClosestPoint, PoseEstimator.cpp:518-542).

Both run on the device of their inputs; neither reads the host.
"""

from __future__ import annotations

import torch

from sos_slam_tpu_torch.ops import tracker as TK
from sos_slam_tpu_torch.utils import lie


def estimate_direct(
    pyr_cur,                      # tuple of (H_l,W_l,3) current KF pyramid
    pts_cam: torch.Tensor,        # (N,3) matched KF camera-frame points
    intensities: torch.Tensor,    # (N,L) per-level intensities
    pts_valid: torch.Tensor,      # (N,)
    T_cur_matched_init: torch.Tensor,   # (4,4)
    intrinsics, n_levels: int,
    direct_thres: float,
):
    """Direct alignment via the coarse tracker with an external template.
    Returns (T_cur_matched (4,4), ok (0-d bool), rms (0-d))."""
    dev = pts_cam.device
    # per-level templates: the matched points as (u, v, idepth) in the
    # MATCHED camera at each level's intrinsics
    templates = []
    z = torch.clamp(pts_cam[:, 2], min=1e-6)
    for lvl in range(n_levels):
        fx, fy, cx, cy = intrinsics[lvl]
        templates.append(TK.LevelTemplate(
            u=pts_cam[:, 0] / z * fx + cx, v=pts_cam[:, 1] / z * fy + cy,
            idepth=1.0 / z,
            color=intensities[:, min(lvl, intensities.shape[1] - 1)],
            valid=pts_valid))

    zeros2 = torch.zeros(2, device=dev)
    out = TK.track_newest_coarse(
        tuple(pyr_cur), tuple(templates), T_cur_matched_init[None], zeros2,
        zeros2, torch.ones(2, device=dev),
        torch.full((6,), float("nan"), device=dev), tuple(intrinsics),
        n_levels)
    T = out["T"][0]
    rms = out["residuals"][0, 0]
    # acceptance gates (PoseEstimator.cpp:451-493): sane affine, low
    # residual AND > INNER_PERCENT=90% of the template in-bounds at the
    # final level-0 pose (lastInners[0] / pts.size())
    r0 = TK.res_and_hb(pyr_cur[0], templates[0], T[None],
                       torch.zeros((1, 2), device=dev),
                       torch.zeros((), device=dev), intrinsics[0],
                       torch.full((1,), 20.0, device=dev), 9.0)
    n_pts = torch.clamp(torch.sum(pts_valid), min=1)
    inlier_frac = r0["num_in"][0] / n_pts
    aff = out["aff"][0]
    ok = out["good"][0] & torch.isfinite(rms) & (rms < direct_thres) \
        & (torch.abs(aff[0]) < 1.2) & (torch.abs(aff[1]) < 200.0) \
        & (inlier_frac > 0.9)
    return T, ok, rms


def icp(
    pts_ref: torch.Tensor,     # (M,3) matched frame points (padded)
    ref_valid: torch.Tensor,   # (M,)
    pts_cur: torch.Tensor,     # (N,3) current frame points (padded)
    cur_valid: torch.Tensor,   # (N,)
    T_init: torch.Tensor,      # (4,4) cur <- matched initial guess
    max_dist: float = 2.0,
    n_iters: int = 5,
):
    """Point-to-point ICP: transform ref points by T, find the nearest
    current point, solve the weighted Umeyama alignment through a 3x3 SVD.
    Returns (T, ok, mean_err). The SVD's U and V carry signs of their
    own; R = V D U^T does not depend on them."""
    dev = pts_ref.device
    inf = torch.tensor(float("inf"), device=dev)

    def nearest(T):
        p = lie.transform_points(T, pts_ref)              # (M,3)
        d2 = torch.sum((p[:, None, :] - pts_cur[None, :, :]) ** 2, -1)
        d2 = torch.where(cur_valid[None, :], d2, inf)
        return p, d2

    T = T_init
    for _ in range(n_iters):
        p, d2 = nearest(T)
        nn = torch.argmin(d2, -1)
        dmin = torch.sqrt(torch.amin(d2, -1))
        w = (ref_valid & (dmin < max_dist)).to(torch.float32)
        q = pts_cur[nn]

        wsum = torch.clamp(torch.sum(w), min=1e-6)
        mu_p = torch.sum(p * w[:, None], 0) / wsum
        mu_q = torch.sum(q * w[:, None], 0) / wsum
        P = (p - mu_p) * w[:, None]
        Q = q - mu_q
        S = P.T @ Q
        U, _, Vt = torch.linalg.svd(S)
        d = torch.sign(torch.linalg.det(Vt.T @ U.T))
        D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                    d]))
        R = Vt.T @ D @ U.T
        dT = lie.compose_rt(R, mu_q - R @ mu_p)
        T = dT @ T

    # final residual
    _, d2 = nearest(T)
    dmin = torch.sqrt(torch.amin(d2, -1))
    w = ref_valid & (dmin < max_dist)
    n_w = torch.sum(w)
    err = torch.sum(torch.where(w, dmin, torch.zeros_like(dmin))) \
        / torch.clamp(n_w, min=1)
    ok = (n_w > 0.5 * torch.clamp(torch.sum(ref_valid), min=1)) \
        & torch.isfinite(err)
    return T, ok, err
