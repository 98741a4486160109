"""The fused BA iteration (kernel K3) and the activation-GN pass reduce
(kernel K4) — port of sos_slam_tpu/ops/ba_p.py.

K3 `fused_iteration` replaces the TPU kernel ops/ba_p.py:fused_iteration
(`_kernel`): one linearize + top-Hessian + Schur accumulation over the
(P,F) residual grid. As in the JAX package, the current-state projection
and the image-tap gather stay in PyTorch before the kernel; the kernel
(csrc/ba_fused.cu) takes the gathered taps and does the rest. Its plain
twin is the composition of the ops/ba.py forms.

K4 `act_pass` replaces ops/ba_p.py:act_pass (`_act_kernel`): the
post-gather residual/Huber/d_id math and live-masked frame sums of one
1-DoF activation GN pass (csrc/act_pass.cu).

Outputs keep the JAX package's lanes-last layout ((F,P), (D,P)), consumed
through the three lanes-last helpers of ops/ba_t.py that the fused path
uses: SchurDataT, resubstitute_t and update_energy_th_t.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops.image import interp_bilinear_frames
from sos_slam_tpu_torch.ops.numerics import at
from sos_slam_tpu_torch.parallel import comm
from sos_slam_tpu_torch.utils import cuda_build as CB
from sos_slam_tpu_torch.utils.config import CPARS, Settings

MAX_FRAMES = 16   # the kernel's block holds at most 256 (point, frame) pairs


class SchurDataT(NamedTuple):
    """Lanes-last twin of ba.SchurData (vcross is (D,P))."""

    Hdd: torch.Tensor
    HdiF: torch.Tensor
    bd: torch.Tensor
    vcross: torch.Tensor
    has_res: torch.Tensor


class FusedOut(NamedTuple):
    """One fused BA linearization+accumulation (lanes-last outputs)."""

    H_top: torch.Tensor       # (D,D) stitched top Hessian (no priors)
    b_top: torch.Tensor       # (D,)
    H_sc: torch.Tensor        # (D,D) Schur complement
    b_sc: torch.Tensor        # (D,)
    sc: SchurDataT            # per-point Schur data (vcross (D,P))
    energy: torch.Tensor      # (F,P)
    energy_raw: torch.Tensor  # (F,P)
    new_state: torch.Tensor   # (F,P) int8
    active: torch.Tensor      # (F,P) bool (without the pmask restriction)


def resubstitute_t(sc: SchurDataT, x: torch.Tensor) -> torch.Tensor:
    bshift = sc.bd - x @ sc.vcross
    return torch.where(sc.has_res, -bshift * sc.HdiF,
                       torch.zeros_like(bshift))


def update_energy_th_t(ba: B.BAState, fo: FusedOut, settings: Settings,
                       group=None) -> torch.Tensor:
    """Adaptive outlier threshold of the newest frame (setNewFrameEnergyTH,
    FullSystemOptimize.cpp:84-124) from the lanes-last linearization.
    Returns the new energy_th (F,). Reads nothing back: the newest slot,
    the considered count and the order statistic's index stay on the
    device (the index as the f32 product `frame_energy_th_n * n`,
    truncated and clipped, the statistic gathered from the sorted
    energies).

    With a process `group` (a point-sharded step), the order statistic is
    taken over every rank's points: the newest frame's energies and their
    considered flags are gathered in rank order, so the count, the clip of
    its index and the sort are those of the whole point axis."""
    F = ba.F
    newest = B.newest_slot(ba.frame_valid)
    e_raw = at(fo.energy_raw, newest)
    considered = (at(ba.res_exist, newest, 1) & ba.pt_valid
                  & (at(fo.new_state, newest) != B.RES_OOB))
    e = torch.where(considered, e_raw, torch.full_like(e_raw, float("inf")))
    if group is not None:
        both = comm.pgather(torch.stack([e, considered.to(e.dtype)], 1),
                            group)
        e, considered = both[:, 0], both[:, 1] > 0.5
    n = torch.sum(considered)
    fac = float(np.float32(settings.frame_energy_th_n))
    nth = torch.clamp((n.to(torch.float32) * fac).to(torch.int64), 0,
                      e.shape[0] - 1)
    nth_el = torch.sqrt(torch.sort(e).values.gather(0, nth.reshape(1))[0])
    th = nth_el * settings.frame_energy_th_fac_median
    th = (26.0 * settings.frame_energy_th_const_weight
          + th * (1.0 - settings.frame_energy_th_const_weight))
    th = th * th * settings.overall_energy_th_weight ** 2
    th = torch.where(n == 0, torch.full_like(th, 12.0 * 12.0 * 8.0), th)
    return torch.where(torch.arange(F, device=newest.device) == newest, th,
                       ba.energy_th)


def _project_taps(ba: B.BAState, pre: B.Precalc, dI, w: int, h: int):
    """Current-state pattern projection + tap gather (PyTorch, before the
    kernel). Returns (hit (P,F,8,3), okf (P,F,8) f32)."""
    fx, fy, cx, cy = B.calib_real(ba)
    pat = B.pattern(ba.u.device)
    hostP = ba.host.long()
    Rc = pre.R[hostP]
    tc = pre.t[hostP]
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
    okf = (pat_ok & torch.isfinite(hit[..., 0])).to(torch.float32)
    return hit, okf


def _plain_lin(ba: B.BAState, pre: B.Precalc, dI, settings, w: int, h: int,
               pmask, use_rz: bool):
    """The linearization restricted to `pmask`, and the FEJ-shifted
    residuals when `use_rz` (else None)."""
    lin = B.linearize(ba, pre, dI, settings, w, h)
    if pmask is not None:
        f = pmask.to(torch.float32)
        lin = lin._replace(
            X=lin.X * f[:, None, None, None], Jpdd=lin.Jpdd * f[:, None, None],
            resF=lin.resF * f[:, None, None],
            JIdx=lin.JIdx * f[:, None, None, None],
            JabF=lin.JabF * f[:, None, None, None],
            JIdx2=lin.JIdx2 * f[:, None, None, None],
            JabJIdx=lin.JabJIdx * f[:, None, None, None],
            Jab2=lin.Jab2 * f[:, None, None, None],
            active=lin.active & pmask[:, None])
    return lin, (B.res_to_zero(ba, pre, lin) if use_rz else None)


def fused_cells_plain(ba: B.BAState, pre: B.Precalc, dI, settings, w: int,
                      h: int, pmask=None, use_rz: bool = False):
    """The plain per-(host, target) cells (accH (F,F,12,12), accb
    (F,F,12)) that K3 sums into its `acc` output before the stitch."""
    lin, resA = _plain_lin(ba, pre, dI, settings, w, h, pmask, use_rz)
    return B.accumulate_cells(ba, lin, resApprox=resA)


def fused_iteration_plain(ba: B.BAState, pre: B.Precalc, dI, settings,
                          w: int, h: int, pmask=None, use_rz: bool = False,
                          shift_prior_to_zero: bool = True,
                          prior_fac: float = 1.0) -> FusedOut:
    """Plain twin of K3: linearize -> (res_to_zero) -> accumulate_top ->
    accumulate_schur -> schur_Hb, in the lanes-last output layout."""
    lin, resA = _plain_lin(ba, pre, dI, settings, w, h, pmask, use_rz)
    H_top, b_top = B.accumulate_top(ba, pre, lin, resApprox=resA)
    sc = B.accumulate_schur(ba, pre, lin, resApprox=resA,
                            shift_prior_to_zero=shift_prior_to_zero,
                            prior_fac=prior_fac)
    H_sc, b_sc = B.schur_Hb(sc)
    active = (ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :]
              & (lin.new_state == B.RES_IN))
    return FusedOut(
        H_top=H_top, b_top=b_top, H_sc=H_sc, b_sc=b_sc,
        sc=SchurDataT(Hdd=sc.Hdd, HdiF=sc.HdiF, bd=sc.bd,
                      vcross=sc.vcross.T.contiguous(), has_res=sc.has_res),
        energy=lin.energy.T.contiguous(),
        energy_raw=lin.energy_raw.T.contiguous(),
        new_state=lin.new_state.T.contiguous(), active=active.T.contiguous())


# launch_ba_fused: 25 input pointers; P, F, use_rz, shift flag; prior_fac,
# huber_th, outlier_th_sum_component, w - 3, h - 3; the partial-sum scratch
# and 10 outputs; the stream
_BA_ARGS = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 11
            + [ctypes.c_void_p])
_BA_PART_ARGS = [ctypes.c_int, ctypes.c_int]
_K3_OUT = ("v", "srows", "energy", "energy_raw", "state", "active",
           "has_res", "acc", "hsc", "bsc")
# partial-sum scratch of the kernel, one buffer per (P, F, device): the
# launches of one stream run in order, so the next call may overwrite it
_K3_SCRATCH = {}


def _as(t: torch.Tensor, dtype, wide: bool = False) -> torch.Tensor:
    """`t` itself when it already is contiguous `dtype` data (starting on
    16 bytes when the kernel reads it by `wide` 16-byte loads); else such a
    copy."""
    if t.dtype != dtype or not t.is_contiguous():
        return t.to(dtype).contiguous()
    return t.clone() if wide and t.data_ptr() % 16 else t


def k3_pack(ba: B.BAState, pre: B.Precalc, pmask=None):
    """K3's window and table inputs in the kernel's order and types (after
    hit and okf): floats as float32, masks as the bool they are, res_state
    int8, host int32. A tensor that already has its type is passed as it
    is, not copied; a missing pmask stays None (all points)."""
    f32, bl = torch.float32, torch.bool
    return [_as(ba.u, f32), _as(ba.v, f32), _as(ba.idepth, f32),
            _as(ba.idepth_zero, f32), _as(ba.pt_prior, f32),
            _as(ba.pt_valid, bl),
            None if pmask is None else _as(pmask, bl),
            _as(ba.color, f32, True), _as(ba.weight, f32, True),
            _as(ba.host, torch.int32), _as(ba.res_exist, bl),
            _as(ba.res_state, torch.int8), _as(pre.R0, f32),
            _as(pre.t0, f32), _as(pre.affLL, f32), _as(ba.c, f32),
            _as(ba.c_zero, f32), _as(pre.b0, f32), _as(ba.energy_th, f32),
            _as(ba.frame_valid, bl), _as(pre.adHTdelta, f32),
            _as(pre.adHost, f32, True), _as(pre.adTarget, f32, True)]


def _k3_scratch(P: int, F: int, dev) -> torch.Tensor:
    key = (P, F, dev)
    part = _K3_SCRATCH.get(key)
    if part is None:
        n = CB.function("ba_fused", "ba_fused_part_floats",
                        _BA_PART_ARGS)(P, F)
        part = _K3_SCRATCH[key] = torch.empty(n, dtype=torch.float32,
                                              device=dev)
    return part


def k3_prepare(ba: B.BAState, pre: B.Precalc, dI, settings: Settings,
               w: int, h: int, pmask=None, use_rz: bool = False,
               shift_prior_to_zero: bool = True, prior_fac: float = 1.0):
    """K3's PyTorch side before the launch: the current-state projection and
    tap gather, the packed inputs, and the outputs allocated. Nothing here
    copies from the host or reads the card. Returns the record `k3_launch`
    consumes (it keeps every buffer alive)."""
    dev = ba.u.device
    if dev.type != "cuda":
        raise ValueError(f"fused_iteration kernel needs CUDA tensors, got {dev}")
    F, P = ba.F, ba.P
    D = CPARS + 8 * F
    if F > MAX_FRAMES:
        raise ValueError(f"fused_iteration supports F<={MAX_FRAMES}, got {F}")
    if dI.dtype != torch.float32 or dI.device != dev:
        raise ValueError("fused_iteration: dI must be float32 on the "
                         "window's device")
    shapes = dict(u=(ba.u, (P,)), v=(ba.v, (P,)), idepth=(ba.idepth, (P,)),
                  idepth_zero=(ba.idepth_zero, (P,)),
                  pt_prior=(ba.pt_prior, (P,)), pt_valid=(ba.pt_valid, (P,)),
                  host=(ba.host, (P,)),
                  color=(ba.color, (P, 8)), weight=(ba.weight, (P, 8)),
                  res_exist=(ba.res_exist, (P, F)),
                  res_state=(ba.res_state, (P, F)),
                  energy_th=(ba.energy_th, (F,)), c=(ba.c, (CPARS,)),
                  c_zero=(ba.c_zero, (CPARS,)),
                  frame_valid=(ba.frame_valid, (F,)),
                  R0=(pre.R0, (F, F, 3, 3)), t0=(pre.t0, (F, F, 3)),
                  affLL=(pre.affLL, (F, F, 2)), b0=(pre.b0, (F,)),
                  adHTdelta=(pre.adHTdelta, (F, F, 8)),
                  adHost=(pre.adHost, (F, F, 8, 8)),
                  adTarget=(pre.adTarget, (F, F, 8, 8)),
                  dI=(dI, (F, h, w, 3)))
    if pmask is not None:
        shapes["pmask"] = (pmask, (P,))
    for name, (t, shp) in shapes.items():
        if tuple(t.shape) != shp or t.device != dev:
            raise ValueError(f"fused_iteration: {name} has shape "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{shp} on {dev}")
    hit, okf = _project_taps(ba, pre, dI, w, h)
    f32 = torch.float32
    ins = [_as(hit, f32, True), _as(okf, f32, True)] + k3_pack(ba, pre, pmask)
    out = dict(v=torch.empty((D, P), dtype=f32, device=dev),
               srows=torch.empty((4, P), dtype=f32, device=dev),
               energy=torch.empty((F, P), dtype=f32, device=dev),
               energy_raw=torch.empty((F, P), dtype=f32, device=dev),
               state=torch.empty((F, P), dtype=torch.int8, device=dev),
               active=torch.empty((F, P), dtype=torch.bool, device=dev),
               has_res=torch.empty((P,), dtype=torch.bool, device=dev),
               acc=torch.empty((F, F, 13, 13), dtype=f32, device=dev),
               hsc=torch.empty((D, D + 1), dtype=f32, device=dev),
               bsc=torch.empty((D,), dtype=f32, device=dev))
    part = _k3_scratch(P, F, dev)
    args = ([None if t is None else CB.ptr(t) for t in ins]
            + [P, F, int(use_rz), int(shift_prior_to_zero), float(prior_fac),
               float(settings.huber_th),
               float(settings.outlier_th_sum_component),
               float(w - 3), float(h - 3), CB.ptr(part)]
            + [CB.ptr(out[k]) for k in _K3_OUT] + [CB.stream_ptr(dev)])
    return dict(args=args, out=out, keep=(ins, part))


def k3_launch(prep) -> None:
    """The K3 kernel launches on prepared buffers (csrc/ba_fused.cu)."""
    fn = CB.function("ba_fused", "launch_ba_fused", _BA_ARGS)
    CB.check(fn(*prep["args"]), "fused_iteration")


def fused_iteration(ba: B.BAState, pre: B.Precalc, dI, settings: Settings,
                    w: int, h: int, pmask=None, use_rz: bool = False,
                    shift_prior_to_zero: bool = True,
                    prior_fac: float = 1.0) -> FusedOut:
    """K3. On CPU tensors: the plain twin. On CUDA tensors: `k3_prepare`
    (PyTorch projection + tap gather), `k3_launch` (csrc/ba_fused.cu: the
    per-residual block pass and the block sum; one count in
    `fused_iteration.launches`), then the adjoint stitch in PyTorch."""
    dev = ba.u.device
    if dev.type == "cpu":
        return fused_iteration_plain(ba, pre, dI, settings, w, h, pmask,
                                     use_rz, shift_prior_to_zero, prior_fac)
    prep = k3_prepare(ba, pre, dI, settings, w, h, pmask, use_rz,
                      shift_prior_to_zero, prior_fac)
    k3_launch(prep)
    fused_iteration.launches += 1
    o = prep["out"]
    D = CPARS + 8 * ba.F
    H_top, b_top = B.stitch_acc(ba, pre, o["acc"][..., :12, :12],
                                o["acc"][..., :12, 12])
    srows = o["srows"]
    sc = SchurDataT(Hdd=srows[0], HdiF=srows[1], bd=srows[2], vcross=o["v"],
                    has_res=o["has_res"])
    return FusedOut(H_top=H_top, b_top=b_top, H_sc=o["hsc"][:, :D],
                    b_sc=o["bsc"], sc=sc,
                    energy=o["energy"], energy_raw=o["energy_raw"],
                    new_state=o["state"], active=o["active"])


fused_iteration.launches = 0


def act_pass_plain(hit, a, b, okf, color, weights2, ap, oob_in, energy_th,
                   clamp: bool, huber_th: float):
    """Plain twin of K4. hit (N,F,8,3); a/b (N,F,8) the d_id chain-rule
    factors; okf (N,F,8) f32; color/weights2 (N,8); ap (N,F,2); oob_in
    (N,F) f32; energy_th (N,). Returns (e_res (N,F), oob_out (N,F) f32,
    eN, HN, bN (N,)), the sums live-masked with `where` (dead rows can
    hold NaN taps) and eN clamped at energy_th when `clamp`."""
    hi, gx, gy = hit[..., 0], hit[..., 1], hit[..., 2]
    r = hi - (ap[..., 0:1] * color[:, None, :] + ap[..., 1:2])
    hw = B.huber_weights(torch.abs(r), huber_th)
    w2 = weights2[:, None, :]
    e_res = torch.sum(w2 * hw * r * r * (2.0 - hw), -1)
    d_id = gx * a + gy * b
    hww = hw * w2
    Hdd = torch.sum(hww * d_id * d_id, -1)
    bd = torch.sum(hww * r * d_id, -1)
    allok = torch.amin(okf, -1)
    oob_out = torch.maximum(oob_in, (allok < 0.5).to(torch.float32))
    live = oob_out < 0.5
    ec = torch.minimum(e_res, energy_th[:, None]) if clamp else e_res
    zero = torch.zeros_like(e_res)
    return (e_res, oob_out, torch.sum(torch.where(live, ec, zero), -1),
            torch.sum(torch.where(live, Hdd, zero), -1),
            torch.sum(torch.where(live, bd, zero), -1))


_ACT_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float] \
    + [ctypes.c_void_p] * 3 + [ctypes.c_void_p]


def act_pass(hit, a, b, okf, color, weights2, ap, oob_in, energy_th,
             clamp: bool, huber_th: float):
    """K4. On CPU tensors: the plain twin. On CUDA tensors: one launch of
    csrc/act_pass.cu, one thread per (candidate, frame) pair (counted in
    `act_pass.launches`)."""
    dev = hit.device
    if dev.type == "cpu":
        return act_pass_plain(hit, a, b, okf, color, weights2, ap, oob_in,
                              energy_th, clamp, huber_th)
    if dev.type != "cuda":
        raise ValueError(f"act_pass: unsupported device {dev}")
    N, F = hit.shape[0], hit.shape[1]
    shapes = [(hit, (N, F, 8, 3)), (a, (N, F, 8)), (b, (N, F, 8)),
              (okf, (N, F, 8)), (color, (N, 8)), (weights2, (N, 8)),
              (ap, (N, F, 2)), (oob_in, (N, F)), (energy_th, (N,))]
    for t, shp in shapes:
        if tuple(t.shape) != shp or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(f"act_pass: expected float32 {shp} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    ins = [_as(t, torch.float32, True) for t, _ in shapes]
    e_res = torch.empty((N, F), dtype=torch.float32, device=dev)
    oob_out = torch.empty((N, F), dtype=torch.float32, device=dev)
    sums = torch.empty((3, N), dtype=torch.float32, device=dev)
    fn = CB.function("act_pass", "launch_act_pass", _ACT_ARGS)
    CB.check(fn(*[CB.ptr(t) for t in ins], N, F, int(clamp),
                float(huber_th), CB.ptr(e_res), CB.ptr(oob_out),
                CB.ptr(sums), CB.stream_ptr(dev)), "act_pass")
    act_pass.launches += 1
    return e_res, oob_out, sums[0], sums[1], sums[2]


act_pass.launches = 0
