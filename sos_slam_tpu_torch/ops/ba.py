"""Windowed bundle adjustment: residual linearization, Hessian assembly,
Schur complement and the damped solve (port of sos_slam_tpu/ops/ba.py).

These are the plain forms that kernel K3 (ops/ba_p.py) is held against,
after the reference's PointFrameResidual::linearize (Residuals.cpp:77-271),
AccumulatedTopHessian / AccumulatedSCHessian and EnergyFunctional's
setAdjointsF / setDeltaF / solveSystemF / resubstituteF.

  * All residuals live in a dense (P points x F frames) masked grid.
  * Per-residual output is the factored RawResidualJacobian: X =
    [Jpdc|Jpdxi] (2,10), JIdx2, JabJIdx, Jab2 middle matrices.
  * Frame state = LEFT perturbation of camToWorld at the FEJ point; host/
    target adjoints carry DSO's internal-state scales.
  * H_sc = sum_p HdiF * v_p v_p^T with v the absolute-space cross column.
  * Everything is in DSO's scaled internal units (SCALE_F/C=50, trans 0.5,
    rot 1, a 10, b 1000, idepth 1), f32 throughout.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from sos_slam_tpu_torch.ops.image import (interp_bilinear,
                                          interp_bilinear_frames)
from sos_slam_tpu_torch.ops.numerics import at, solve
from sos_slam_tpu_torch.utils import lie
from sos_slam_tpu_torch.utils.config import CPARS, PATTERN_OFFSETS, Settings

SCALE_F = 50.0
SCALE_C = 50.0
SCALE_XI_TRANS = 0.5
SCALE_XI_ROT = 1.0
SCALE_A = 10.0
SCALE_B = 1000.0
SCALE_IDEPTH = 1.0

_STATE8_SCALE = [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B]
_CALIB_SCALE = [SCALE_F, SCALE_F, SCALE_C, SCALE_C]

RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2


# The three constant tensors below are made once per device and shared
# (read-only): making one is a host-to-device copy, and they are wanted in
# every BA iteration.
@functools.lru_cache(maxsize=None)
def state8_scale(device) -> torch.Tensor:
    """State8 internal -> real multipliers."""
    return torch.tensor(_STATE8_SCALE, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def pattern(device) -> torch.Tensor:
    return torch.as_tensor(PATTERN_OFFSETS, device=device)


@functools.lru_cache(maxsize=None)
def _calib_scale(device) -> torch.Tensor:
    return torch.tensor(_CALIB_SCALE, dtype=torch.float32, device=device)


class BAState(NamedTuple):
    """The sliding window as fixed-shape tensors (padded + masked). Frame
    slots are compact: valid frames occupy slots [0, n)."""

    frame_valid: torch.Tensor   # (F,) bool
    T_cw_eval: torch.Tensor     # (F,4,4) camToWorld at FEJ evaluation point
    state: torch.Tensor         # (F,8) internal [xi(6), a, b]
    state_zero: torch.Tensor    # (F,8) FEJ zero state
    exposure: torch.Tensor      # (F,)
    energy_th: torch.Tensor     # (F,)
    prior: torch.Tensor         # (F,8)
    c: torch.Tensor             # (4,) internal calib
    c_zero: torch.Tensor        # (4,)
    pt_valid: torch.Tensor      # (P,) bool
    host: torch.Tensor          # (P,) int32
    u: torch.Tensor             # (P,)
    v: torch.Tensor             # (P,)
    color: torch.Tensor         # (P,8)
    weight: torch.Tensor        # (P,8)
    idepth: torch.Tensor        # (P,)
    idepth_zero: torch.Tensor   # (P,)
    pt_prior: torch.Tensor      # (P,)
    res_exist: torch.Tensor     # (P,F) bool
    res_state: torch.Tensor     # (P,F) int8
    HM: torch.Tensor            # (D,D)
    bM: torch.Tensor            # (D,)

    @property
    def F(self) -> int:
        return self.frame_valid.shape[0]

    @property
    def P(self) -> int:
        return self.pt_valid.shape[0]


def calib_real(ba: BAState) -> torch.Tensor:
    return ba.c * _calib_scale(ba.c.device)


def state_to_pose(T_cw_eval: torch.Tensor, state: torch.Tensor):
    """camToWorld = exp(scaled_xi) @ T_cw_eval (left eps on camToWorld)."""
    xi = state[..., :6] * state8_scale(state.device)[:6]
    return lie.se3_exp(xi) @ T_cw_eval


def aff_real(state: torch.Tensor) -> torch.Tensor:
    return state[..., 6:8] * state8_scale(state.device)[6:8]


def newest_slot(frame_valid: torch.Tensor) -> torch.Tensor:
    """The window's newest slot as a 0-dim device tensor, read nothing
    back; an empty window's -1 is the last slot, as a Python index."""
    return torch.remainder(torch.sum(frame_valid) - 1, frame_valid.shape[0])


def aff_transfer(exp_h, exp_t, aff_h, aff_t):
    """(a, b) with I_t ~ a I_h + b (NumType.h:157-168). Real-unit affs."""
    exp_h = torch.where(exp_h == 0, torch.ones_like(exp_h), exp_h)
    exp_t = torch.where(exp_t == 0, torch.ones_like(exp_t), exp_t)
    a = torch.exp(aff_t[..., 0] - aff_h[..., 0]) * exp_t / exp_h
    b = aff_t[..., 1] - a * aff_h[..., 1]
    return torch.stack([a, b], -1)


class Precalc(NamedTuple):
    """Per-(host, target) cached transforms + adjoints. All (F,F,...)."""

    R0: torch.Tensor      # (F,F,3,3) FEJ rotation host->target
    t0: torch.Tensor      # (F,F,3)
    R: torch.Tensor       # (F,F,3,3) current
    t: torch.Tensor       # (F,F,3)
    affLL: torch.Tensor   # (F,F,2)
    b0: torch.Tensor      # (F,)
    adHost: torch.Tensor  # (F,F,8,8)
    adTarget: torch.Tensor
    adHTdelta: torch.Tensor  # (F,F,8)


class PrecalcEval(NamedTuple):
    """The FEJ-evaluation-point part of Precalc (constant across the GN
    iterations of one optimize call)."""

    R0: torch.Tensor
    t0: torch.Tensor
    b0: torch.Tensor
    adHost: torch.Tensor
    adTarget: torch.Tensor


def _pair_affs(exposure, aff):
    F = exposure.shape[0]
    return aff_transfer(exposure[:, None], exposure[None, :],
                        aff[:, None, :].expand(F, F, 2),
                        aff[None, :, :].expand(F, F, 2))


def make_precalc_eval(ba: BAState) -> PrecalcEval:
    """Adjoints + FEJ relative transforms (setAdjointsF,
    EnergyFunctional.cpp:42-103)."""
    F = ba.F
    dev = ba.state.device
    T_wc_eval = lie.se3_inv(ba.T_cw_eval)
    rel0 = torch.einsum("tij,hjk->htik", T_wc_eval, ba.T_cw_eval)
    aff0 = aff_real(ba.state_zero)
    affLL0 = _pair_affs(ba.exposure, aff0)
    AdjT = lie.se3_adj(T_wc_eval)
    adj_ht = AdjT[None].expand(F, F, 6, 6)
    AH = torch.zeros((F, F, 8, 8), dtype=torch.float32, device=dev)
    AT = torch.zeros((F, F, 8, 8), dtype=torch.float32, device=dev)
    AH[..., :6, :6] = adj_ht
    AT[..., :6, :6] = -adj_ht
    a0 = affLL0[..., 0]
    AH[..., 6, 6] = a0
    AH[..., 7, 7] = a0
    AT[..., 6, 6] = -a0
    AT[..., 7, 7] = torch.full_like(a0, -1.0)
    s8 = state8_scale(dev)
    AH = AH * s8[None, None, None, :]
    AT = AT * s8[None, None, None, :]
    return PrecalcEval(R0=rel0[..., :3, :3], t0=rel0[..., :3, 3],
                       b0=aff0[:, 1], adHost=AH, adTarget=AT)


def make_precalc(ba: BAState, ev: PrecalcEval | None = None) -> Precalc:
    """Current-state transforms + the (loop-reusable) eval-point part."""
    if ev is None:
        ev = make_precalc_eval(ba)
    T_cw = state_to_pose(ba.T_cw_eval, ba.state)
    T_wc = lie.se3_inv(T_cw)
    rel = torch.einsum("tij,hjk->htik", T_wc, T_cw)
    affLL = _pair_affs(ba.exposure, aff_real(ba.state))
    delta = ba.state - ba.state_zero
    adHTdelta = (torch.einsum("htij,hj->hti", ev.adHost, delta)
                 + torch.einsum("htij,tj->hti", ev.adTarget, delta))
    return Precalc(R0=ev.R0, t0=ev.t0, R=rel[..., :3, :3], t=rel[..., :3, 3],
                   affLL=affLL, b0=ev.b0, adHost=ev.adHost,
                   adTarget=ev.adTarget, adHTdelta=adHTdelta)


class LinData(NamedTuple):
    """Per-(point,target) factored linearization (RawResidualJacobian)."""

    X: torch.Tensor        # (P,F,2,10)
    Jpdd: torch.Tensor     # (P,F,2)
    resF: torch.Tensor     # (P,F,8)
    JIdx: torch.Tensor     # (P,F,2,8)
    JabF: torch.Tensor     # (P,F,2,8)
    JIdx2: torch.Tensor    # (P,F,2,2)
    JabJIdx: torch.Tensor  # (P,F,2,2)
    Jab2: torch.Tensor     # (P,F,2,2)
    energy: torch.Tensor   # (P,F)
    energy_raw: torch.Tensor  # (P,F)
    new_state: torch.Tensor   # (P,F) int8
    active: torch.Tensor   # (P,F) bool


def huber_weights(abs_r, huber_th: float):
    """Huber weight of each residual magnitude."""
    return torch.where(abs_r < huber_th, torch.ones_like(abs_r),
                       huber_th / torch.clamp(abs_r, min=1e-9))


def linearize(ba: BAState, pre: Precalc, dI: torch.Tensor,
              settings: Settings, w: int, h: int) -> LinData:
    """Batched PointFrameResidual::linearize over the (P,F) residual grid.
    dI: (F,H,W,3) stacked level-0 images of all frames."""
    fx, fy, cx, cy = calib_real(ba)
    pat = pattern(ba.u.device)
    hostP = ba.host.long()
    R0 = pre.R0[hostP]
    t0 = pre.t0[hostP]
    Rc = pre.R[hostP]
    tc = pre.t[hostP]
    affLL = pre.affLL[hostP]
    b0 = pre.b0[hostP]

    # ---- geometry part at FEJ (center pixel, idepth_zero) ----
    KliP = torch.stack([(ba.u - cx) / fx, (ba.v - cy) / fy,
                        torch.ones_like(ba.u)], -1)
    ptp = torch.einsum("pfij,pj->pfi", R0, KliP) \
        + t0 * ba.idepth_zero[:, None, None]
    drescale = 1.0 / ptp[..., 2]
    geo_ok = drescale > 0
    new_idepth = ba.idepth_zero[:, None] * drescale
    u_ = ptp[..., 0] * drescale
    v_ = ptp[..., 1] * drescale
    Ku = u_ * fx + cx
    Kv = v_ * fy + cy
    geo_ok &= (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3)

    d_d = torch.stack([
        drescale * (t0[..., 0] - t0[..., 2] * u_) * SCALE_IDEPTH * fx,
        drescale * (t0[..., 1] - t0[..., 2] * v_) * SCALE_IDEPTH * fy,
    ], -1)
    A = drescale * (R0[..., 2, 0] * u_ - R0[..., 0, 0])
    Bc = fx * drescale * (R0[..., 2, 1] * u_ - R0[..., 0, 1]) / fy
    C = fy * drescale * (R0[..., 2, 0] * v_ - R0[..., 1, 0]) / fx
    Dv = drescale * (R0[..., 2, 1] * v_ - R0[..., 1, 1])
    k0 = KliP[:, None, 0]
    k1 = KliP[:, None, 1]
    d_C_x = torch.stack([(k0 * A + u_) * SCALE_F, k1 * Bc * SCALE_F,
                         (A + 1.0) * SCALE_C, Bc * SCALE_C], -1)
    d_C_y = torch.stack([k0 * C * SCALE_F, (k1 * Dv + v_) * SCALE_F,
                         C * SCALE_C, (Dv + 1.0) * SCALE_C], -1)
    idp = new_idepth
    one = torch.ones_like(u_)
    d_xi_x = torch.stack([idp * fx, 0 * one, -idp * u_ * fx,
                          -u_ * v_ * fx, (1 + u_ * u_) * fx, -v_ * fx], -1)
    d_xi_y = torch.stack([0 * one, idp * fy, -idp * v_ * fy,
                          -(1 + v_ * v_) * fy, u_ * v_ * fy, u_ * fy], -1)
    X = torch.cat([torch.stack([d_C_x, d_C_y], -2),
                   torch.stack([d_xi_x, d_xi_y], -2)], -1)

    # ---- pattern part at current state ----
    up = ba.u[:, None] + pat[None, :, 0]
    vp = ba.v[:, None] + pat[None, :, 1]
    KliPp = torch.stack([(up - cx) / fx, (vp - cy) / fy,
                         torch.ones_like(up)], -1)
    ptp_c = torch.einsum("pfij,pkj->pfki", Rc, KliPp) \
        + tc[:, :, None, :] * ba.idepth[:, None, None, None]
    z = ptp_c[..., 2]
    pat_ok = z > 1e-6
    Kup = ptp_c[..., 0] / z * fx + cx
    Kvp = ptp_c[..., 1] / z * fy + cy
    pat_ok &= (Kup > 1.1) & (Kvp > 1.1) & (Kup < w - 3) & (Kvp < h - 3)
    hit = interp_bilinear_frames(dI, Kup, Kvp)
    ok = geo_ok[:, :, None] & pat_ok & torch.isfinite(hit[..., 0])
    oob = ~torch.all(ok, -1)

    r = hit[..., 0] - (affLL[..., 0:1] * ba.color[:, None, :]
                       + affLL[..., 1:2])
    drdA = ba.color[:, None, :] - b0[:, None, None]
    gx, gy = hit[..., 1], hit[..., 2]
    oc = settings.outlier_th_sum_component
    wgrad = torch.sqrt(oc / (oc + gx * gx + gy * gy))
    wgt = 0.5 * (wgrad + ba.weight[:, None, :])
    hw = huber_weights(torch.abs(r), settings.huber_th)
    energy_raw = torch.sum(wgt * wgt * hw * r * r * (2.0 - hw), -1)
    hw2 = torch.where(hw < 1.0, torch.sqrt(hw), hw) * wgt
    JIdx = torch.stack([gx * hw2, gy * hw2], -2)
    resF = r * hw2
    JabF = torch.stack([drdA * hw2, hw2], -2)
    wJI2 = torch.sum(hw2 * hw2 * (gx * gx + gy * gy), -1)

    th = torch.maximum(ba.energy_th[hostP][:, None], ba.energy_th[None, :])
    outlier = (energy_raw > th) | (wJI2 < 2.0)
    energy = torch.where(outlier, th, energy_raw)
    prev_oob = ba.res_state == RES_OOB
    new_state = torch.where(
        oob | prev_oob, RES_OOB,
        torch.where(outlier, RES_OUTLIER, RES_IN)).to(torch.int8)
    active = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :] \
        & (new_state == RES_IN)
    mask_f = active.to(torch.float32)

    JIdx2 = torch.einsum("pfik,pfjk->pfij", JIdx, JIdx)
    JabJIdx = torch.einsum("pfik,pfjk->pfij", JabF, JIdx)
    Jab2 = torch.einsum("pfik,pfjk->pfij", JabF, JabF)
    m4 = mask_f[..., None, None]
    return LinData(X=X * m4, Jpdd=d_d * mask_f[..., None],
                   resF=resF * mask_f[..., None], JIdx=JIdx * m4,
                   JabF=JabF * m4, JIdx2=JIdx2 * m4, JabJIdx=JabJIdx * m4,
                   Jab2=Jab2 * m4, energy=energy, energy_raw=energy_raw,
                   new_state=new_state, active=active)


def linearize_energy_col(ba: BAState, pre: Precalc, dI: torch.Tensor, k: int,
                         settings: Settings, w: int, h: int,
                         row: int | None = None):
    """Energy + residual state of the single target-frame column `k`: the
    k-column of `linearize(...)`'s (energy, new_state) at 1/F of the
    gather. Used for the dying frame's dso_error sum inside a frame
    marginalization (FullSystemMarginalize.cpp:151-187).

    `row` is the dI row holding slot k's image (defaults to k; the chain
    defers the image-stack compaction and passes its slot -> row map).
    `k` and `row` may be 0-dim device ints: they are gathered on the
    device (`at`), so that a captured chain reads nothing back.

    Returns (energy (P,), new_state (P,) int8)."""
    if row is None:
        row = k
    fx, fy, cx, cy = calib_real(ba)
    H, W = dI.shape[1], dI.shape[2]
    pat = pattern(ba.u.device)
    hostP = ba.host.long()
    R0 = at(pre.R0, k, 1)[hostP]
    t0 = at(pre.t0, k, 1)[hostP]
    Rc = at(pre.R, k, 1)[hostP]
    tc = at(pre.t, k, 1)[hostP]
    affLL = at(pre.affLL, k, 1)[hostP]

    # geometry at FEJ (center pixel, idepth_zero): the OOB gate
    KliP = torch.stack([(ba.u - cx) / fx, (ba.v - cy) / fy,
                        torch.ones_like(ba.u)], -1)
    ptp = torch.einsum("pij,pj->pi", R0, KliP) + t0 * ba.idepth_zero[:, None]
    drescale = 1.0 / ptp[..., 2]
    geo_ok = drescale > 0
    Ku = ptp[..., 0] * drescale * fx + cx
    Kv = ptp[..., 1] * drescale * fy + cy
    geo_ok &= (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) & (Kv < h - 3)

    # pattern at the current state
    up = ba.u[:, None] + pat[None, :, 0]
    vp = ba.v[:, None] + pat[None, :, 1]
    KliPp = torch.stack([(up - cx) / fx, (vp - cy) / fy,
                         torch.ones_like(up)], -1)
    ptp_c = torch.einsum("pij,pkj->pki", Rc, KliPp) \
        + tc[:, None, :] * ba.idepth[:, None, None]
    z = ptp_c[..., 2]
    pat_ok = z > 1e-6
    Kup = ptp_c[..., 0] / z * fx + cx
    Kvp = ptp_c[..., 1] / z * fy + cy
    pat_ok &= (Kup > 1.1) & (Kvp > 1.1) & (Kup < w - 3) & (Kvp < h - 3)
    hit = interp_bilinear(at(dI, row), Kup, Kvp)
    ok = geo_ok[:, None] & pat_ok & torch.isfinite(hit[..., 0])
    oob = ~torch.all(ok, -1)

    r = hit[..., 0] - (affLL[..., 0:1] * ba.color + affLL[..., 1:2])
    gx, gy = hit[..., 1], hit[..., 2]
    oc = settings.outlier_th_sum_component
    wgrad = torch.sqrt(oc / (oc + gx * gx + gy * gy))
    wgt = 0.5 * (wgrad + ba.weight)
    hw = huber_weights(torch.abs(r), settings.huber_th)
    energy_raw = torch.sum(wgt * wgt * hw * r * r * (2.0 - hw), -1)
    hw2 = torch.where(hw < 1.0, torch.sqrt(hw), hw) * wgt
    wJI2 = torch.sum(hw2 * hw2 * (gx * gx + gy * gy), -1)

    th = torch.maximum(ba.energy_th[hostP], at(ba.energy_th, k))
    outlier = (energy_raw > th) | (wJI2 < 2.0)
    energy = torch.where(outlier, th, energy_raw)
    prev_oob = at(ba.res_state, k, 1) == RES_OOB
    new_state = torch.where(
        oob | prev_oob, RES_OOB,
        torch.where(outlier, RES_OUTLIER, RES_IN)).to(torch.int8)
    return energy, new_state


def col_energy(ba: BAState, dI: torch.Tensor, k: int, settings: Settings,
               w: int, h: int, row: int | None = None):
    """Sum and count of the live residual energies targeting slot k on the
    state before its marginalization (`_frame_residual_energy`): the
    ingredients of the exported keyframe's dso_error. Returns two 0-d
    tensors (e_col, n_col)."""
    energy, new_state = linearize_energy_col(ba, make_precalc(ba), dI, k,
                                             settings, w, h, row=row)
    col = at(ba.res_exist, k, 1) & ba.pt_valid & (new_state == RES_IN)
    return (torch.sum(torch.where(col, energy, torch.zeros_like(energy))),
            torch.sum(col))


def res_to_zero(ba: BAState, pre: Precalc, lin: LinData) -> torch.Tensor:
    """FEJ shift: res_toZero = resF - J * delta (fixLinearizationF).
    Returns (P,F,8)."""
    P, F = ba.P, ba.F
    dp = pre.adHTdelta[ba.host.long()]
    dc = ba.c - ba.c_zero
    dd = ba.idepth - ba.idepth_zero
    delta10 = torch.cat([dc.expand(P, F, 4), dp[..., :6]], -1)
    Jp_delta = torch.einsum("pfij,pfj->pfi", lin.X, delta10) \
        + lin.Jpdd * dd[:, None, None]
    shift = (torch.einsum("pfik,pfi->pfk", lin.JIdx, Jp_delta)
             + lin.JabF[:, :, 0, :] * dp[..., 6:7]
             + lin.JabF[:, :, 1, :] * dp[..., 7:8])
    return lin.resF - shift


def _onehot(host: torch.Tensor, F: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(host.long(), F).to(torch.float32)


def accumulate_top(ba: BAState, pre: Precalc, lin: LinData,
                   resApprox: torch.Tensor | None = None):
    """The (D,D) top Hessian and (D,) b from the linearization, in internal
    units, WITHOUT priors (AccumulatedTopHessian addPoint + stitch)."""
    return stitch_acc(ba, pre, *accumulate_cells(ba, lin, resApprox))


def accumulate_cells(ba: BAState, lin: LinData,
                     resApprox: torch.Tensor | None = None):
    """The per-(host, target) relative cells before the stitch: accH
    (F,F,12,12) and accb (F,F,12) (AccumulatedTopHessian addPoint)."""
    F = ba.F
    if resApprox is None:
        resApprox = lin.resF
    JI_r = torch.einsum("pfik,pfk->pfi", lin.JIdx, resApprox)
    Jab_r = torch.einsum("pfik,pfk->pfi", lin.JabF, resApprox)
    onehot = _onehot(ba.host, F)
    G_gg = torch.einsum("pfai,pfab,pfbj->pfij", lin.X, lin.JIdx2, lin.X)
    G_ga = torch.einsum("pfai,pfba->pfib", lin.X, lin.JabJIdx)
    G_gb = torch.einsum("pfai,pfa->pfi", lin.X, JI_r)
    A_gg = torch.einsum("ph,pfij->hfij", onehot, G_gg)
    A_ga = torch.einsum("ph,pfib->hfib", onehot, G_ga)
    A_aa = torch.einsum("ph,pfij->hfij", onehot, lin.Jab2)
    b_g = torch.einsum("ph,pfi->hfi", onehot, G_gb)
    b_a = torch.einsum("ph,pfi->hfi", onehot, Jab_r)
    accH = torch.zeros((F, F, 12, 12), dtype=torch.float32,
                       device=ba.u.device)
    accH[..., :10, :10] = A_gg
    accH[..., :10, 10:] = A_ga
    accH[..., 10:, :10] = A_ga.transpose(-1, -2)
    accH[..., 10:, 10:] = A_aa
    return accH, torch.cat([b_g, b_a], -1)


def stitch_acc(ba: BAState, pre: Precalc, accH: torch.Tensor,
               accb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adjoint stitch of per-(h,t) 12x12 cells into the (D,D) absolute H and
    (D,) b (stitchDouble, AccumulatedTopHessian.cpp:155-301)."""
    F = ba.F
    D = CPARS + 8 * F
    dev = accH.device
    Hcc = accH[..., :4, :4].sum((0, 1))
    Gfc = accH[..., 4:, :4]
    Gff = accH[..., 4:, 4:]
    bc = accb[..., :4].sum((0, 1))
    bf_rel = accb[..., 4:]
    AH, AT = pre.adHost, pre.adTarget
    d_h = torch.einsum("htri,htrs,htsj->hij", AH, Gff, AH)
    d_t = torch.einsum("htri,htrs,htsj->tij", AT, Gff, AT)
    x_ht = torch.einsum("htri,htrs,htsj->htij", AH, Gff, AT)
    Hff = torch.zeros((F, 8, F, 8), dtype=torch.float32, device=dev)
    idxF = torch.arange(F, device=dev)
    Hff[idxF, :, idxF, :] += d_h + d_t
    Hff = Hff + x_ht.permute(0, 2, 1, 3)
    Hff = Hff + x_ht.permute(1, 3, 0, 2)
    Hfc = (torch.einsum("htri,htrc->hic", AH, Gfc)
           + torch.einsum("htri,htrc->tic", AT, Gfc))
    bf = (torch.einsum("htri,htr->hi", AH, bf_rel)
          + torch.einsum("htri,htr->ti", AT, bf_rel))
    H = torch.zeros((D, D), dtype=torch.float32, device=dev)
    H[:4, :4] = Hcc
    H[4:, 4:] = Hff.reshape(8 * F, 8 * F)
    H[4:, :4] = Hfc.reshape(8 * F, 4)
    H[:4, 4:] = Hfc.reshape(8 * F, 4).T
    b = torch.cat([bc, bf.reshape(-1)])
    return H, b


class SchurData(NamedTuple):
    Hdd: torch.Tensor      # (P,)
    HdiF: torch.Tensor     # (P,)
    bd: torch.Tensor       # (P,)
    vcross: torch.Tensor   # (P,D)
    has_res: torch.Tensor  # (P,) bool


def accumulate_schur(ba: BAState, pre: Precalc, lin: LinData,
                     resApprox: torch.Tensor | None = None,
                     shift_prior_to_zero: bool = True,
                     prior_fac: float = 1.0) -> SchurData:
    """Point-elimination quantities (AccumulatedSCHessian.cpp:32-79)."""
    F, P = ba.F, ba.P
    if resApprox is None:
        resApprox = lin.resF
    JI_r = torch.einsum("pfik,pfk->pfi", lin.JIdx, resApprox)
    Ji2_Jpdd = torch.einsum("pfij,pfj->pfi", lin.JIdx2, lin.Jpdd)
    Hdd = torch.sum(torch.einsum("pfi,pfi->pf", Ji2_Jpdd, lin.Jpdd), -1)
    bd = torch.sum(torch.einsum("pfi,pfi->pf", JI_r, lin.Jpdd), -1)
    Hcd = torch.einsum("pfic,pfi->pc", lin.X[..., :4], Ji2_Jpdd)
    JpJd = torch.cat([
        torch.einsum("pfij,pfi->pfj", lin.X[..., 4:], Ji2_Jpdd),
        torch.einsum("pfij,pfj->pfi", lin.JabJIdx, lin.Jpdd),
    ], -1)
    has_res = torch.any(lin.active, -1)
    prior = ba.pt_prior * prior_fac
    Hdd_full = torch.clamp(Hdd + prior, min=1e-10)
    HdiF = torch.where(has_res, 1.0 / Hdd_full, torch.zeros_like(Hdd_full))
    bd_full = bd + (prior * (ba.idepth - ba.idepth_zero)
                    if shift_prior_to_zero else 0.0)
    hostP = ba.host.long()
    AHp = pre.adHost[hostP]
    ATp = pre.adTarget[hostP]
    v_host = torch.einsum("pfri,pfr->pi", AHp, JpJd)
    v_tgt = torch.einsum("pfri,pfr->pfi", ATp, JpJd)
    onehot = _onehot(ba.host, F)
    v_frames = v_tgt + onehot[:, :, None] * v_host[:, None, :]
    v = torch.cat([Hcd, v_frames.reshape(P, 8 * F)], -1)
    return SchurData(Hdd=Hdd_full, HdiF=HdiF, bd=bd_full, vcross=v,
                     has_res=has_res)


def schur_Hb(sc: SchurData):
    H_sc = torch.einsum("pi,p,pj->ij", sc.vcross, sc.HdiF, sc.vcross)
    b_sc = torch.einsum("pi,p->i", sc.vcross, sc.HdiF * sc.bd)
    return H_sc, b_sc


def add_priors(ba: BAState, H: torch.Tensor, b: torch.Tensor,
               settings: Settings):
    """Calib + per-frame diagonal priors (stitchDouble usePrior branch)."""
    F = ba.F
    H = H.clone()
    b = b.clone()
    ci = torch.arange(4, device=H.device)
    H[ci, ci] += settings.initial_calib_hessian
    b[:4] += settings.initial_calib_hessian * (ba.c - ba.c_zero)
    fv = ba.frame_valid[:, None].to(torch.float32)
    fprior = ba.prior * fv
    delta_prior = ba.state * fv
    didx = torch.arange(CPARS, CPARS + 8 * F, device=H.device)
    H[didx, didx] += fprior.reshape(-1)
    b[4:] += (fprior * delta_prior).reshape(-1)
    return H, b


def state_mask(ba: BAState) -> torch.Tensor:
    """(D,) 1.0 for live state dims (calib + valid frames)."""
    fm = ba.frame_valid.to(torch.float32).repeat_interleave(8)
    return torch.cat([torch.ones(4, dtype=torch.float32,
                                 device=fm.device), fm])


def get_stitched_delta(ba: BAState) -> torch.Tensor:
    return torch.cat([ba.c - ba.c_zero, (ba.state - ba.state_zero).reshape(-1)])


def solve_system(ba: BAState, H_top, b_top, H_sc, b_sc, lam: float = 1e-5):
    """The damped, Jacobi-preconditioned solve (solveSystemF,
    EnergyFunctional.cpp:1142-1148) with the FEJ-shifted marg prior.
    Returns x (D,) in internal units (step = -x)."""
    D = H_top.shape[0]
    delta = get_stitched_delta(ba)
    H = H_top + ba.HM
    b = b_top + ba.bM + ba.HM @ delta
    di = torch.arange(D, device=H.device)
    diag = torch.diagonal(H) * (1.0 + lam)
    H = H.clone()
    H[di, di] = diag
    H = H - H_sc * (1.0 / (1.0 + lam))
    b = b - b_sc
    m = state_mask(ba)
    H = H * m[:, None] * m[None, :]
    H = H + torch.diag(1.0 - m)
    b = b * m
    svec_i = 1.0 / torch.sqrt(torch.abs(torch.diagonal(H)) + 10.0)
    Hs = H * svec_i[:, None] * svec_i[None, :]
    return svec_i * solve(Hs, svec_i * b)


def resubstitute(sc: SchurData, x: torch.Tensor) -> torch.Tensor:
    """Per-point idepth step from the frame/calib solution x."""
    bshift = sc.bd - sc.vcross @ x
    return torch.where(sc.has_res, -bshift * sc.HdiF,
                       torch.zeros_like(bshift))
