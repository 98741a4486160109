"""Monocular bootstrap: joint pose + per-point inverse-depth estimation
(port of sos_slam_tpu/models/initializer.py; reference CoarseInitializer,
CoarseInitializer.{h,cpp}).

Multi-level point selection with a kNN neighbour/parent graph, per-level
Levenberg optimisation jointly over SE(3)+affine and all point inverse
depths with the Schur complement on the depths (calcResAndGS), the
translation-evidence snap test, neighbour-median idepth regularisation
(optReg) and cross-level propagation. Each level is a fixed-size padded
point pool; the LM loop runs on the host with device tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import selector
from sos_slam_tpu_torch.ops.numerics import scatter_sum, solve
from sos_slam_tpu_torch.ops.image import build_pyramid, interp_bilinear
from sos_slam_tpu_torch.utils import lie
from sos_slam_tpu_torch.utils.camera import CalibPyramid
from sos_slam_tpu_torch.utils.config import Settings

DENSITIES = (0.03, 0.05, 0.15, 0.5, 1.0)
MAX_ITS = (5, 5, 10, 30, 50)
ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
COUPLING_WEIGHT = 1.0
_WM = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)


class InitLevel(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    is_good: torch.Tensor
    idepth: torch.Tensor
    iR: torch.Tensor
    energy: torch.Tensor       # (N,2) [photometric, regularizer]
    last_hessian: torch.Tensor
    nn: torch.Tensor           # (N,10) int32, -1 = none
    parent: torch.Tensor       # (N,) int32, -1 at top


class InitState(NamedTuple):
    levels: Tuple[InitLevel, ...]
    T: torch.Tensor            # (4,4) first -> current
    aff: torch.Tensor          # (2,)
    snapped: torch.Tensor      # bool
    frame_id: torch.Tensor     # int32
    snapped_at: torch.Tensor   # int32


def _stable_smallest(d: torch.Tensor, k: int):
    """(indices, values) of the k smallest per row, ties by lower index
    (lax.top_k's order)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return idx[:, :k], vals[:, :k]


def _knn(u, v, valid, k, chunk=512):
    """Brute-force kNN indices among valid points. (N,k) int32, -1 pad."""
    n = u.shape[0]
    pts = torch.stack([u, v], -1)
    idxs, dists = [], []
    for c0 in range(0, n, chunk):
        q = pts[c0:c0 + chunk]
        d = torch.sum((q[:, None, :] - pts[None, :, :]) ** 2, -1)
        d = torch.where(valid[None, :], d, torch.full_like(d, float("inf")))
        i, dv = _stable_smallest(d, k + 1)
        idxs.append(i)
        dists.append(dv)
    idx = torch.cat(idxs)[:, 1:]
    dist = torch.cat(dists)[:, 1:]
    idx = torch.where(torch.isfinite(dist), idx, torch.full_like(idx, -1))
    idx = torch.where(valid[:, None], idx, torch.full_like(idx, -1))
    return idx.to(torch.int32)


def _parents(u, v, valid, pu, pv, pvalid, chunk=512):
    """Nearest coarser-level point for each point (coords halved)."""
    q = torch.stack([u * 0.5, v * 0.5], -1)
    pts = torch.stack([pu, pv], -1)
    out = []
    for c0 in range(0, q.shape[0], chunk):
        d = torch.sum((q[c0:c0 + chunk, None, :] - pts[None, :, :]) ** 2, -1)
        d = torch.where(pvalid[None, :], d, torch.full_like(d, float("inf")))
        out.append(torch.argmin(d, -1))
    par = torch.cat(out)
    return torch.where(valid, par, torch.full_like(par, -1)).to(torch.int32)


def level_slots(calib: CalibPyramid, lvl: int) -> int:
    budget = DENSITIES[min(lvl, len(DENSITIES) - 1)] * calib.widths[0] \
        * calib.heights[0]
    cap = calib.widths[lvl] * calib.heights[lvl] // 3
    return max(int(-(-min(budget * 1.5, cap) // 256) * 256), 256)


def set_first(pyr, absgrads, calib: CalibPyramid, settings: Settings,
              key) -> InitState:
    """Select points at every level and build the NN graph (setFirst)."""
    n_levels = calib.levels
    dev = pyr[0].device
    sel_data = []
    for lvl in range(n_levels):
        n_slots = level_slots(calib, lvl)
        density = DENSITIES[min(lvl, len(DENSITIES) - 1)] \
            * calib.widths[0] * calib.heights[0]
        if lvl == 0:
            if len(absgrads) < 3:
                _, absgrads = build_pyramid(pyr[0][..., 0], 3)
            status, _, _ = selector.make_maps(
                pyr[0], absgrads, settings, density, key, recursions=1,
                th_factor=2.0)
        else:
            m, _ = selector.make_pixel_status(pyr[lvl], density)
            status = m.to(torch.int8)
        u, v, my_type = selector.extract_points(status, n_slots)
        w_l, h_l = calib.widths[lvl], calib.heights[lvl]
        valid = (my_type > 0) & (u >= 3) & (v >= 3) & (u < w_l - 4) \
            & (v < h_l - 4)
        sel_data.append((u + 0.1, v + 0.1, valid))

    levels = []
    for lvl in range(n_levels):
        u, v, valid = sel_data[lvl]
        n = u.shape[0]
        nn = _knn(u, v, valid, 10)
        if lvl + 1 < n_levels:
            pu, pv, pvalid = sel_data[lvl + 1]
            parent = _parents(u, v, valid, pu, pv, pvalid)
        else:
            parent = torch.full((n,), -1, dtype=torch.int32, device=dev)
        levels.append(InitLevel(
            u=u, v=v, valid=valid, is_good=valid,
            idepth=torch.ones(n, device=dev), iR=torch.ones(n, device=dev),
            energy=torch.zeros((n, 2), device=dev),
            last_hessian=torch.zeros(n, device=dev), nn=nn, parent=parent))
    return InitState(levels=tuple(levels),
                     T=torch.eye(4, device=dev),
                     aff=torch.zeros(2, device=dev),
                     snapped=torch.tensor(False, device=dev),
                     frame_id=torch.tensor(0, dtype=torch.int32, device=dev),
                     snapped_at=torch.tensor(0, dtype=torch.int32, device=dev))


def _masked_median(vals, mask):
    big = torch.where(mask, vals, torch.full_like(vals, float("inf")))
    s = torch.sort(big, -1).values
    cnt = torch.sum(mask, -1)
    mid = torch.clamp(cnt // 2, 0, vals.shape[-1] - 1)
    return torch.gather(s, -1, mid[:, None])[:, 0], cnt


def opt_reg(lv: InitLevel, snapped: bool) -> InitLevel:
    """Neighbour-median pull of iR (optReg, CoarseInitializer.cpp:720-752)."""
    if not snapped:
        return lv._replace(iR=torch.ones_like(lv.iR))
    nn_ok = lv.nn >= 0
    nidx = torch.clamp(lv.nn, min=0).long()
    med, cnt = _masked_median(lv.iR[nidx], lv.is_good[nidx] & nn_ok)
    new_iR = torch.where(lv.is_good & (cnt > 2),
                         (1.0 - REG_WEIGHT) * lv.idepth + REG_WEIGHT * med,
                         lv.iR)
    return lv._replace(iR=new_iR)


def calc_res_gs(lv: InitLevel, dI_first, dI_new, intr, w, h, T, aff,
                settings: Settings):
    """calcResAndGS: energy + acc9 H,b + Schur pieces, batched over points."""
    fx, fy, cx, cy = intr
    dev = lv.u.device
    pat = B.pattern(dev)
    R = T[:3, :3]
    t = T[:3, 3]
    a_aff = torch.exp(aff[0])
    b_aff = aff[1]
    up = lv.u[:, None] + pat[None, :, 0]
    vp = lv.v[:, None] + pat[None, :, 1]
    KliP = torch.stack([(up - cx) / fx, (vp - cy) / fy,
                        torch.ones_like(up)], -1)
    pt = torch.einsum("ij,nkj->nki", R, KliP) \
        + t[None, None, :] * lv.idepth[:, None, None]
    z = pt[..., 2]
    u_ = pt[..., 0] / z
    v_ = pt[..., 1] / z
    Ku = fx * u_ + cx
    Kv = fy * v_ + cy
    new_idepth = lv.idepth[:, None] / z
    ok = (Ku > 1) & (Kv > 1) & (Ku < w - 2) & (Kv < h - 2) & (new_idepth > 0)
    hit = interp_bilinear(dI_new, Ku, Kv)
    rlR = interp_bilinear(dI_first[..., 0], up, vp)
    ok &= torch.isfinite(hit[..., 0]) & torch.isfinite(rlR)
    all_ok = torch.all(ok, -1)

    r = hit[..., 0] - a_aff * rlR - b_aff
    ar = torch.abs(r)
    hw = torch.where(ar < settings.huber_th, torch.ones_like(ar),
                     settings.huber_th / torch.clamp(ar, min=1e-9))
    energy = torch.sum(hw * r * r * (2.0 - hw), -1)
    dxdd = (t[0] - t[2] * u_) / z
    dydd = (t[1] - t[2] * v_) / z
    hws = torch.where(hw < 1, torch.sqrt(hw), hw)
    dxI = hws * hit[..., 1] * fx
    dyI = hws * hit[..., 2] * fy
    J = torch.stack([
        new_idepth * dxI,
        new_idepth * dyI,
        -new_idepth * (u_ * dxI + v_ * dyI),
        -u_ * v_ * dxI - (1 + v_ * v_) * dyI,
        (1 + u_ * u_) * dxI + u_ * v_ * dyI,
        -v_ * dxI + u_ * dyI,
        -hws * a_aff * rlR,
        -hws,
        hws * r,
    ], -1)
    dd = dxI * dxdd + dyI * dydd

    outlier_th = 8.0 * settings.outlier_th
    good_new = lv.is_good & all_ok & (energy <= outlier_th * 20.0)
    energy_new = torch.where(good_new, energy, lv.energy[:, 0])
    zero = torch.zeros_like(energy)
    E_photo = torch.sum(torch.where(lv.valid, torch.where(
        good_new, energy, lv.energy[:, 0]), zero))
    gmask = good_new.to(torch.float32)
    Jm = J * gmask[:, None, None]
    M = torch.einsum("nki,nkj->ij", Jm, Jm)
    H8 = M[:8, :8].clone()
    b8 = M[:8, 8].clone()
    Jb = torch.cat([torch.einsum("nki,nk->ni", J[..., :9], dd),
                    torch.sum(dd * dd, -1, keepdim=True)], -1)
    Jb = Jb * gmask[:, None]
    maxstep = torch.amin(torch.where(
        ok, 1.0 / torch.clamp(torch.sqrt((dxdd * fx) ** 2 + (dydd * fy) ** 2),
                              min=1e-10),
        torch.full_like(dxdd, 1e10)), -1)

    e_alpha_pt = torch.where(good_new, (lv.idepth - 1.0) ** 2, lv.energy[:, 1])
    npts = float(max(int(torch.sum(lv.valid)), 1))
    t_log = lie.se3_log(T)[:3]
    EAlpha = torch.sum(torch.where(lv.valid & good_new, e_alpha_pt, zero))
    alpha_energy_raw = ALPHA_W * (EAlpha + torch.sum(t * t) * npts)
    snap_now = alpha_energy_raw <= ALPHA_K * npts
    alpha_energy = torch.clamp(alpha_energy_raw, max=ALPHA_K * npts)
    alpha_opt = torch.where(snap_now, torch.tensor(ALPHA_W, device=dev),
                            torch.tensor(0.0, device=dev))
    coupling = torch.where(snap_now, torch.tensor(0.0, device=dev),
                           torch.tensor(COUPLING_WEIGHT, device=dev))
    Jb8 = Jb[:, 8] + alpha_opt * (lv.idepth - 1.0) + torch.where(
        snap_now, torch.zeros_like(lv.idepth),
        COUPLING_WEIGHT * (lv.idepth - lv.iR))
    Jb9 = Jb[:, 9] + alpha_opt + coupling
    Jb9i = torch.where(good_new, 1.0 / (1.0 + Jb9), torch.zeros_like(Jb9))
    Jhead = Jb[:, :8]
    Hsc = torch.einsum("ni,n,nj->ij", Jhead, Jb9i, Jhead)
    bsc = torch.einsum("ni,n->i", Jhead, Jb9i * Jb8)
    i3 = torch.arange(3, device=dev)
    H8[i3, i3] += alpha_opt * npts
    b8[:3] += t_log * alpha_opt * npts
    Jb_out = torch.cat([Jhead, Jb8[:, None], Jb9i[:, None]], -1)
    return dict(E=E_photo, E_alpha=alpha_energy, H=H8, b=b8, Hsc=Hsc,
                bsc=bsc, Jb=Jb_out, good_new=good_new, energy_new=energy_new,
                e_alpha_new=e_alpha_pt, maxstep=maxstep, snap=snap_now)


def _do_point_step(lv, res, inc, lam):
    b = res["Jb"][:, 8] + res["Jb"][:, :8] @ inc
    step = -b * res["Jb"][:, 9] / float(1.0 + lam)
    ms = torch.clamp(0.25 * res["maxstep"], max=1e10)
    step = torch.maximum(torch.minimum(step, ms), -ms)
    return torch.clamp(lv.idepth + step, 1e-3, 50.0)


def track_level(lv: InitLevel, dI_first, dI_new, intr, w, h, T0, aff0,
                snapped: bool, max_its: int, settings: Settings):
    """Per-level LM loop (trackFrame inner loop, CoarseInitializer.cpp:
    295-385). Returns (lv, T, aff, snap)."""
    dev = lv.u.device

    def res_at(lv_, T, aff):
        return calc_res_gs(lv_, dI_first, dI_new, intr, w, h, T, aff,
                           settings)

    res = res_at(lv, T0, aff0)
    lv = lv._replace(is_good=res["good_new"],
                     energy=torch.stack([res["energy_new"],
                                         res["e_alpha_new"]], -1),
                     last_hessian=res["Jb"][:, 9])
    npix = 0.01 / (w * h)
    WM = torch.tensor(_WM, dtype=torch.float32, device=dev)
    T, aff = T0, aff0
    lam = np.float32(0.1)   # f32 damping, as the JAX loop carries it
    fails = 0
    snap = False
    for _ in range(max_its):
        H = res["H"] * float(1.0 + lam) \
            - res["Hsc"] * float(np.float32(1.0) / (1.0 + lam))
        bl = res["b"] - res["bsc"] * float(np.float32(1.0) / (1.0 + lam))
        Hw = H * WM[:, None] * WM[None, :] * npix
        bw = bl * WM * npix
        inc_w = -solve(
            Hw + 1e-12 * torch.eye(8, device=dev), bw)
        inc = WM * inc_w
        inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
        T_new = lie.se3_exp(inc[:6]) @ T
        aff_new = aff + inc[6:8]
        idepth_new = _do_point_step(lv, res, inc, lam)
        lv_new = lv._replace(idepth=idepth_new)
        res_new = res_at(lv_new, T_new, aff_new)
        gm = res_new["good_new"]
        zero = torch.zeros_like(idepth_new)
        if snapped:
            reg_old = COUPLING_WEIGHT * torch.sum(
                torch.where(gm, (lv.idepth - lv.iR) ** 2, zero))
            reg_new = COUPLING_WEIGHT * torch.sum(
                torch.where(gm, (idepth_new - lv.iR) ** 2, zero))
        else:
            reg_old = reg_new = torch.zeros((), device=dev)
        e_old = res["E"] + res["E_alpha"] + reg_old
        e_new = res_new["E"] + res_new["E_alpha"] + reg_new
        accept = bool(e_old > e_new)
        if accept:
            lv = lv_new._replace(
                is_good=res_new["good_new"],
                energy=torch.stack([res_new["energy_new"],
                                    res_new["e_alpha_new"]], -1),
                last_hessian=res_new["Jb"][:, 9])
            lv = opt_reg(lv, snapped or bool(res_new["snap"]))
            T, aff = T_new, aff_new
            res = res_at(lv, T, aff)
            lam = max(lam * np.float32(0.5), np.float32(1e-4))
            fails = 0
            snap = snap or bool(res_new["snap"])
        else:
            lam = min(lam * np.float32(4.0), np.float32(1e4))
            fails += 1
        if float(torch.linalg.norm(inc)) <= 1e-4 or fails >= 2:
            break
    return lv, T, aff, snap


def propagate_down(src: InitLevel, dst: InitLevel) -> InitLevel:
    """Pull iR/idepth from parents (propagateDown)."""
    pok = dst.parent >= 0
    pidx = torch.clamp(dst.parent, min=0).long()
    p_good = src.is_good[pidx] & (src.last_hessian[pidx] >= 0.1) & pok
    p_iR = src.iR[pidx]
    newiR = torch.where(
        dst.is_good,
        (dst.iR * dst.last_hessian * 2.0 + p_iR * src.last_hessian[pidx])
        / torch.clamp(dst.last_hessian * 2.0 + src.last_hessian[pidx],
                      min=1e-10),
        p_iR)
    upd = p_good & dst.valid
    return dst._replace(
        iR=torch.where(upd, newiR, dst.iR),
        idepth=torch.where(upd, newiR, dst.idepth),
        is_good=dst.is_good | upd,
        last_hessian=torch.where(upd & ~dst.is_good,
                                 torch.zeros_like(dst.last_hessian),
                                 dst.last_hessian))


def propagate_up(src: InitLevel, dst: InitLevel) -> InitLevel:
    """Push Hessian-weighted iR to parents (propagateUp)."""
    n_dst = dst.u.shape[0]
    pok = (src.parent >= 0) & src.is_good & src.valid
    pidx = torch.where(pok, src.parent, torch.zeros_like(src.parent)).long()
    zero = torch.zeros_like(src.iR)
    wsum = scatter_sum(pidx, torch.where(pok, src.iR * src.last_hessian,
                                         zero), n_dst)
    hsum = scatter_sum(pidx, torch.where(pok, src.last_hessian, zero), n_dst)
    has = hsum > 0
    newv = torch.where(has, wsum / torch.clamp(hsum, min=1e-10), dst.iR)
    return dst._replace(iR=newv, idepth=torch.where(has, newv, dst.idepth),
                        is_good=dst.is_good | (has & dst.valid))


def reset_points_coarsest(lv: InitLevel) -> InitLevel:
    """At the coarsest level, revive bad points from neighbour means."""
    nn_ok = lv.nn >= 0
    nidx = torch.clamp(lv.nn, min=0).long()
    ngood = lv.is_good[nidx] & nn_ok
    s = torch.sum(torch.where(ngood, lv.iR[nidx], torch.zeros_like(
        lv.iR[nidx])), -1)
    c = torch.sum(ngood, -1)
    revive = ~lv.is_good & (c > 0) & lv.valid
    val = s / torch.clamp(c, min=1)
    return lv._replace(is_good=lv.is_good | revive,
                       iR=torch.where(revive, val, lv.iR),
                       idepth=torch.where(revive, val, lv.idepth))


def track_frame(state: InitState, pyr_first, pyr_new, calib: CalibPyramid,
                settings: Settings, exposures=(1.0, 1.0)):
    """One initializer frame (CoarseInitializer::trackFrame): pre-snap
    reset, the coarse-to-fine level cascade and upward propagation.
    Returns (state, done)."""
    dev = state.T.device
    aff = state.aff
    if exposures[0] > 0 and exposures[1] > 0:
        aff = torch.as_tensor(np.array(
            [np.log(exposures[1] / exposures[0]), 0.0], np.float32),
            device=dev)
    n_levels = len(pyr_first)
    levels = list(state.levels)
    snapped = bool(state.snapped)
    T = state.T
    if not snapped:
        T = T.clone()
        T[:3, 3] = 0.0
        levels = [lv._replace(iR=torch.ones_like(lv.iR),
                              idepth=torch.ones_like(lv.idepth),
                              last_hessian=torch.zeros_like(lv.last_hessian))
                  for lv in levels]
    snap_any = False
    for lvl in range(n_levels - 1, -1, -1):
        lv = levels[lvl]
        if lvl < n_levels - 1:
            lv = propagate_down(levels[lvl + 1], lv)
        else:
            lv = reset_points_coarsest(lv)
        lv, T, aff, snap = track_level(
            lv, pyr_first[lvl], pyr_new[lvl], calib.intrinsics(lvl),
            calib.widths[lvl], calib.heights[lvl], T, aff, snapped,
            MAX_ITS[min(lvl, len(MAX_ITS) - 1)], settings)
        snap_any |= snap
        levels[lvl] = lv
    for lvl in range(n_levels - 1):
        levels[lvl + 1] = propagate_up(levels[lvl], levels[lvl + 1])

    snapped_new = snapped or snap_any
    frame_id = int(state.frame_id) + 1
    snapped_at = int(state.snapped_at)
    if snapped_new and snapped_at == 0:
        snapped_at = frame_id
    if not snapped_new:
        snapped_at = 0
    done = snapped_new and frame_id > snapped_at + 5
    return InitState(
        tuple(levels), T, aff, torch.tensor(snapped_new, device=dev),
        torch.tensor(frame_id, dtype=torch.int32, device=dev),
        torch.tensor(snapped_at, dtype=torch.int32, device=dev)), done
