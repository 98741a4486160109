"""Immature points: epipolar-line depth search and activation (port of
sos_slam_tpu/ops/trace.py; reference ImmaturePoint::traceOn,
ImmaturePoint.cpp:70-415, and FullSystem::optimizeImmaturePoint,
FullSystemOptOpt.cpp:47-192).

All candidate points trace in one batched pass: the discrete epipolar
search is an (N, MAX_STEPS) masked sweep, the 3-step GN refinement runs
over arrays, and the status machine keeps the reference's early-return
precedence. Activation is the batched 1-DoF GN against all window frames;
its per-pass reduce is kernel K4 (ops/ba_p.py:act_pass).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import ba_p as BP
from sos_slam_tpu_torch.ops.image import (interp_bilinear,
                                          interp_bilinear_blin,
                                          interp_bilinear_frames)
from sos_slam_tpu_torch.utils.config import Settings

IPS_UNINITIALIZED = 0
IPS_GOOD = 1
IPS_OOB = 2
IPS_OUTLIER = 3
IPS_SKIPPED = 4
IPS_BADCONDITION = 5

MAX_STEPS = 40
SWEEP_PATCH = 56


class ImmatureState(NamedTuple):
    """Fixed-size pool of immature points (padded + masked)."""

    valid: torch.Tensor        # (N,) bool
    host: torch.Tensor         # (N,) int32
    u: torch.Tensor
    v: torch.Tensor
    color: torch.Tensor        # (N,8)
    weights: torch.Tensor      # (N,8)
    gradH: torch.Tensor        # (N,2,2)
    energy_th: torch.Tensor    # (N,)
    idepth_min: torch.Tensor
    idepth_max: torch.Tensor   # inf = uninitialized
    status: torch.Tensor       # (N,) int8
    quality: torch.Tensor
    my_type: torch.Tensor      # (N,) int32


def init_immature(u, v, host, my_type, dI_host, settings: Settings,
                  n_slots: int) -> ImmatureState:
    """Immature points at (u, v) in their host image (the ImmaturePoint
    constructor, ImmaturePoint.cpp:25-60, with the BiLin forward-difference
    gradients)."""
    pat = B.pattern(u.device)
    up = u[:, None] + pat[None, :, 0]
    vp = v[:, None] + pat[None, :, 1]
    ptc = interp_bilinear_blin(dI_host[..., 0], up, vp)
    color = ptc[..., 0]
    g = ptc[..., 1:]
    gradH = torch.einsum("nki,nkj->nij", g, g)
    oc = settings.outlier_th_sum_component
    weights = torch.sqrt(oc / (oc + torch.sum(g * g, -1)))
    energy_th = 8.0 * settings.outlier_th * settings.overall_energy_th_weight ** 2
    n = u.shape[0]
    dev = u.device
    return ImmatureState(
        valid=(my_type > 0) & torch.isfinite(color).all(-1),
        host=host.to(torch.int32), u=u, v=v, color=color, weights=weights,
        gradH=gradH,
        energy_th=torch.full((n,), energy_th, device=dev),
        idepth_min=torch.zeros(n, device=dev),
        idepth_max=torch.full((n,), float("inf"), device=dev),
        status=torch.full((n,), IPS_UNINITIALIZED, dtype=torch.int8,
                          device=dev),
        quality=torch.full((n,), 10000.0, device=dev),
        my_type=my_type.to(torch.int32),
    )


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back: the sweep's matmul operand precision."""
    return x.to(torch.bfloat16).to(torch.float32)


def _sweep_energy_patch(img, ptx, pty, dxn, dyn, rot_pat, color, aff, huber):
    """(N, MAX_STEPS) pattern energies along the epipolar segment. Each
    point samples all MAX_STEPS x 8 taps from one (P,P) patch around its
    segment as two hat-weight contractions with bfloat16 operands and f32
    accumulation — the JAX package's sweep sampler, whose rounding the
    discrete search (a bracket for the f32 GN refinement) inherits."""
    N = ptx.shape[0]
    P = SWEEP_PATCH
    h, w = img.shape
    dev = img.device
    steps = torch.arange(MAX_STEPS, dtype=torch.float32, device=dev)
    sx = ptx[:, None] + steps[None, :] * dxn[:, None]
    sy = pty[:, None] + steps[None, :] * dyn[:, None]
    qx = sx[:, :, None] + rot_pat[:, None, :, 0]
    qy = sy[:, :, None] + rot_pat[:, None, :, 1]

    def origin(q, lim):
        lo = torch.floor(torch.amin(q, dim=(1, 2))) - 2
        lo = torch.where(torch.isnan(lo), torch.zeros_like(lo), lo)
        return torch.clamp(lo, 0, lim - P).to(torch.int64)

    ox = origin(qx, w)
    oy = origin(qy, h)
    ar = torch.arange(P, device=dev)
    rows = (oy[:, None] + ar[None, :])[:, :, None]
    cols = (ox[:, None] + ar[None, :])[:, None, :]
    patches = img.reshape(-1)[rows * w + cols]                 # (N,P,P)
    SK = MAX_STEPS * 8
    lx = torch.clamp(qx - ox[:, None, None], 0.0, P - 2.0).reshape(N, SK)
    ly = torch.clamp(qy - oy[:, None, None], 0.0, P - 2.0).reshape(N, SK)
    ii = torch.arange(P, dtype=torch.float32, device=dev)
    wx = torch.clamp(1.0 - torch.abs(lx[..., None] - ii), min=0.0)
    wy = torch.clamp(1.0 - torch.abs(ly[..., None] - ii), min=0.0)
    t = torch.bmm(_bf16(wx), _bf16(patches).transpose(1, 2))  # (N,SK,P)
    hit = torch.sum(_bf16(t) * _bf16(wy), -1).reshape(N, MAX_STEPS, 8)
    r = hit - (aff[:, None, 0:1] * color[:, None, :] + aff[:, None, 1:2])
    hw = B.huber_weights(torch.abs(r), huber)
    return torch.sum(hw * r * r * (2.0 - hw), -1)


def _pattern_taps(dI, px, py, rot_pat):
    """[I, dx, dy] at the 8 rotated pattern positions around (px, py)."""
    return interp_bilinear(dI, px[..., None] + rot_pat[..., 0],
                           py[..., None] + rot_pat[..., 1])


def trace_points(imm: ImmatureState, dI_new, KRKi, Kt, aff, w: int, h: int,
                 settings: Settings) -> ImmatureState:
    """Batched traceOn of every immature point onto the new frame.
    KRKi (F,3,3) / Kt (F,3): host -> new transforms; aff (F,2)."""
    need = int(2 + (w + h) * settings.max_pix_search
               / max(settings.trace_stepsize, 1e-6)) + 1
    if need > MAX_STEPS:
        raise ValueError(f"MAX_STEPS={MAX_STEPS} cannot cover the epipolar "
                         f"search ({need} steps needed for {w}x{h})")
    N = imm.u.shape[0]
    dev = imm.u.device
    pat = B.pattern(dev)
    max_pix_search = (w + h) * settings.max_pix_search
    hostl = imm.host.long()
    KRKi_p = KRKi[hostl]
    Kt_p = Kt[hostl]
    aff_p = aff[hostl]
    was_oob = imm.status == IPS_OOB

    pr = torch.einsum("nij,nj->ni", KRKi_p,
                      torch.stack([imm.u, imm.v, torch.ones_like(imm.u)], -1))
    ptpMin = pr + Kt_p * imm.idepth_min[:, None]
    uMin = ptpMin[:, 0] / ptpMin[:, 2]
    vMin = ptpMin[:, 1] / ptpMin[:, 2]

    def inb(x, y):
        return (x > 4) & (y > 4) & (x < w - 5) & (y < h - 5)

    oob = ~inb(uMin, vMin)
    has_max = torch.isfinite(imm.idepth_max)
    ptpMax = pr + Kt_p * torch.where(has_max, imm.idepth_max,
                                     torch.full_like(imm.idepth_max, 0.01)
                                     )[:, None]
    uMax0 = ptpMax[:, 0] / ptpMax[:, 2]
    vMax0 = ptpMax[:, 1] / ptpMax[:, 2]
    dist_f = torch.sqrt((uMin - uMax0) ** 2 + (vMin - vMax0) ** 2)
    dnorm = 1.0 / torch.clamp(dist_f, min=1e-9)
    uMax = torch.where(has_max, uMax0,
                       uMin + max_pix_search * (uMax0 - uMin) * dnorm)
    vMax = torch.where(has_max, vMax0,
                       vMin + max_pix_search * (vMax0 - vMin) * dnorm)
    dist = torch.where(has_max, dist_f, torch.full_like(dist_f,
                                                        max_pix_search))
    oob |= ~inb(uMax, vMax)
    skipped = has_max & (dist < settings.trace_slack_interval)
    scale_oob = ~((imm.idepth_min < 0)
                  | ((ptpMin[:, 2] > 0.75) & (ptpMin[:, 2] < 1.5)))

    dx = settings.trace_stepsize * (uMax - uMin)
    dy = settings.trace_stepsize * (vMax - vMin)
    dvec = torch.stack([dx, dy], -1)
    nvec = torch.stack([dy, -dx], -1)
    a = torch.einsum("ni,nij,nj->n", dvec, imm.gradH, dvec)
    b = torch.einsum("ni,nij,nj->n", nvec, imm.gradH, nvec)
    error_px = 0.2 + 0.2 * (a + b) / torch.clamp(a, min=1e-9)
    badcond = (error_px * settings.trace_min_improvement_factor > dist) \
        & has_max
    error_px = torch.clamp(error_px, max=10.0)

    dxn = dx / torch.clamp(dist, min=1e-9)
    dyn = dy / torch.clamp(dist, min=1e-9)
    clamp = dist > max_pix_search
    uMax = torch.where(clamp, uMin + max_pix_search * dxn, uMax)
    vMax = torch.where(clamp, vMin + max_pix_search * dyn, vMax)
    dist = torch.where(clamp, torch.full_like(dist, max_pix_search), dist)
    dir_oob = ~torch.isfinite(dxn) | ~torch.isfinite(dyn)

    nsf = 1.9999 + dist / settings.trace_stepsize
    nsf = torch.where(torch.isnan(nsf), torch.zeros_like(nsf), nsf)
    num_steps = torch.clamp(torch.clamp(nsf, -2.0 ** 31, 2.0 ** 31 - 128)
                            .to(torch.int64), max=MAX_STEPS - 1)
    rshift = uMin * 1000.0 - torch.floor(uMin * 1000.0)
    ptx = uMin - rshift * dxn
    pty = vMin - rshift * dyn

    rot = KRKi_p[:, :2, :2]
    rot_pat = torch.einsum("nij,kj->nki", rot, pat)

    e_steps = _sweep_energy_patch(dI_new[..., 0], ptx, pty, dxn, dyn, rot_pat,
                                  imm.color, aff_p, settings.huber_th)
    steps = torch.arange(MAX_STEPS, dtype=torch.float32, device=dev)
    step_ok = steps[None, :] < num_steps[:, None].to(torch.float32)
    e_steps = torch.where(step_ok, e_steps,
                          torch.full_like(e_steps, float("inf")))
    best_e, best_idx = _min_first(e_steps)
    bestU = ptx + best_idx * dxn
    bestV = pty + best_idx * dyn
    off = torch.abs(torch.arange(MAX_STEPS, device=dev)[None, :]
                    - best_idx[:, None])
    e2 = torch.where(off > settings.min_trace_test_radius, e_steps,
                     torch.full_like(e_steps, float("inf")))
    second = torch.amin(e2, -1)
    new_quality = second / torch.clamp(best_e, min=1e-9)
    quality = torch.where((new_quality < imm.quality) | (num_steps > 10),
                          new_quality, imm.quality)

    # ---- GN refinement along the line (masked accept/backstep) ----
    hub = settings.huber_th
    bu, bv = bestU, bestV
    be = torch.full((N,), 1e5, device=dev)
    ubak, vbak = bestU, bestV
    stepback = torch.zeros(N, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    w2 = imm.weights ** 2
    for _ in range(settings.trace_gn_iterations):
        hit = _pattern_taps(dI_new, bu, bv, rot_pat)
        r = hit[..., 0] - (aff_p[:, 0:1] * imm.color + aff_p[:, 1:2])
        hw = B.huber_weights(torch.abs(r), hub)
        dres = dxn[:, None] * hit[..., 1] + dyn[:, None] * hit[..., 2]
        ok = torch.isfinite(hit[..., 0])
        zero = torch.zeros_like(r)
        Hgn = 1.0 + torch.sum(torch.where(ok, hw * dres * dres, zero), -1)
        bgn = torch.sum(torch.where(ok, hw * r * dres, zero), -1)
        ew = torch.sum(torch.where(ok, w2 * hw * r * r * (2 - hw),
                                   torch.full_like(r, 1e5)), -1)
        worse = ew > be
        sb_new = torch.where(worse, stepback * 0.5, torch.zeros_like(stepback))
        step = torch.clamp(-bgn / Hgn, -0.5, 0.5)
        step = torch.where(torch.isfinite(step), step, torch.zeros_like(step))
        bu2 = torch.where(worse, ubak + sb_new * dxn, bu + step * dxn)
        bv2 = torch.where(worse, vbak + sb_new * dyn, bv + step * dyn)
        ubak2 = torch.where(worse, ubak, bu)
        vbak2 = torch.where(worse, vbak, bv)
        be2 = torch.where(worse, be, ew)
        sb2 = torch.where(worse, sb_new, step)
        upd = ~done
        done2 = done | (torch.abs(sb2) < settings.trace_gn_threshold)
        bu, bv = torch.where(upd, bu2, bu), torch.where(upd, bv2, bv)
        be = torch.where(upd, be2, be)
        ubak, vbak = torch.where(upd, ubak2, ubak), torch.where(upd, vbak2, vbak)
        stepback = torch.where(upd, sb2, stepback)
        done = done2
    bestU, bestV, best_e_gn = bu, bv, be

    outlier = ~(best_e_gn < imm.energy_th * settings.trace_extra_slack_on_th)
    outlier_to_oob = outlier & (imm.status == IPS_OUTLIER)

    use_x = dxn * dxn > dyn * dyn
    eU_lo, eU_hi = bestU - error_px * dxn, bestU + error_px * dxn
    eV_lo, eV_hi = bestV - error_px * dyn, bestV + error_px * dyn
    id_lo_x = (pr[:, 2] * eU_lo - pr[:, 0]) / (Kt_p[:, 0] - Kt_p[:, 2] * eU_lo)
    id_hi_x = (pr[:, 2] * eU_hi - pr[:, 0]) / (Kt_p[:, 0] - Kt_p[:, 2] * eU_hi)
    id_lo_y = (pr[:, 2] * eV_lo - pr[:, 1]) / (Kt_p[:, 1] - Kt_p[:, 2] * eV_lo)
    id_hi_y = (pr[:, 2] * eV_hi - pr[:, 1]) / (Kt_p[:, 1] - Kt_p[:, 2] * eV_hi)
    id_lo = torch.where(use_x, id_lo_x, id_lo_y)
    id_hi = torch.where(use_x, id_hi_x, id_hi_y)
    id_min = torch.minimum(id_lo, id_hi)
    id_max = torch.maximum(id_lo, id_hi)
    bad_interval = ~torch.isfinite(id_min) | ~torch.isfinite(id_max) \
        | (id_max < 0)

    # reference check order (earlier wins): sticky OOB > uv-OOB > SKIPPED >
    # scale-OOB > BADCONDITION > dir-OOB > OUTLIER > bad-interval > GOOD
    def st(code):
        return torch.full((N,), code, dtype=torch.int8, device=dev)

    status = st(IPS_GOOD)
    status = torch.where(bad_interval, st(IPS_OUTLIER), status)
    status = torch.where(outlier, torch.where(outlier_to_oob, st(IPS_OOB),
                                              st(IPS_OUTLIER)), status)
    keep_interval = outlier | bad_interval
    status = torch.where(dir_oob, st(IPS_OOB), status)
    status = torch.where(badcond, st(IPS_BADCONDITION), status)
    status = torch.where(scale_oob, st(IPS_OOB), status)
    status = torch.where(skipped, st(IPS_SKIPPED), status)
    keep_interval |= dir_oob | badcond | scale_oob | skipped
    status = torch.where(oob | was_oob, st(IPS_OOB), status)
    keep_interval |= oob | was_oob
    status = torch.where(imm.valid, status, imm.status)
    keep_interval |= ~imm.valid
    ran_sweep = ~(oob | was_oob | skipped | scale_oob | badcond | dir_oob
                  | ~imm.valid)
    quality = torch.where(ran_sweep, quality, imm.quality)
    new_min = torch.where(keep_interval, imm.idepth_min, id_min)
    new_max = torch.where(keep_interval, imm.idepth_max, id_max)
    return imm._replace(idepth_min=new_min, idepth_max=new_max,
                        status=status, quality=quality)


def _min_first(e: torch.Tensor):
    """(min, first index of the min) along the last axis; a row holding NaN
    yields its first NaN, as jnp.min / jnp.argmin do."""
    isn = torch.isnan(e)
    clean = torch.where(isn, torch.full_like(e, float("inf")), e)
    idx = torch.where(isn.any(-1), torch.argmax(isn.to(torch.uint8), -1),
                      torch.argmin(clean, -1))
    return torch.gather(e, -1, idx[:, None])[:, 0], idx


def activate_points(imm: ImmatureState, candidate, dI, R, t, affLL,
                    frame_valid, intr: Tuple[float, float, float, float],
                    w: int, h: int, settings: Settings):
    """Batched optimizeImmaturePoint: 1-DoF GN on inverse depth against all
    window frames. Each pass projects + gathers in PyTorch, then reduces
    with K4. Returns (idepth (N,), ok (N,) bool, res_in (N,F) bool)."""
    fx, fy, cx, cy = intr
    N = imm.u.shape[0]
    F = dI.shape[0]
    dev = imm.u.device
    pat = B.pattern(dev)
    hostl = imm.host.long()
    Rp = R[hostl]
    tp = t[hostl]
    ap = affLL[hostl]
    is_host = torch.nn.functional.one_hot(hostl, F).to(torch.bool)
    res_ok0 = candidate[:, None] & frame_valid[None, :] & ~is_host
    KliP = torch.stack([(imm.u[:, None] + pat[None, :, 0] - cx) / fx,
                        (imm.v[:, None] + pat[None, :, 1] - cy) / fy,
                        torch.ones((N, 8), device=dev)], -1)
    color = imm.color.contiguous()
    w2 = (imm.weights ** 2).contiguous()
    eth = imm.energy_th.contiguous()

    def linearize_pass(idepth, oob_in, clamp: bool):
        ptp = torch.einsum("nfij,nkj->nfki", Rp, KliP) \
            + tp[:, :, None, :] * idepth[:, None, None, None]
        drescale = 1.0 / ptp[..., 2]
        uu = ptp[..., 0] * drescale
        vv = ptp[..., 1] * drescale
        Ku = uu * fx + cx
        Kv = vv * fy + cy
        ok = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < w - 3) \
            & (Kv < h - 3)
        hit = interp_bilinear_frames(dI, Ku, Kv)
        ok &= torch.isfinite(hit[..., 0])
        a = fx * drescale * (tp[..., 0:1] - tp[..., 2:3] * uu)
        b = fy * drescale * (tp[..., 1:2] - tp[..., 2:3] * vv)
        e_res, oobf, eN, HN, bN = BP.act_pass(
            hit.contiguous(), a.contiguous(), b.contiguous(),
            ok.to(torch.float32), color, w2, ap.contiguous(),
            oob_in.to(torch.float32).contiguous(), eth, clamp=clamp,
            huber_th=float(settings.huber_th))
        return e_res, oobf > 0.5, eN, HN, bN

    idepth0 = 0.5 * (imm.idepth_min + imm.idepth_max)
    idepth0 = torch.where(torch.isfinite(idepth0), idepth0,
                          torch.full_like(idepth0, 0.5))
    e0, oob, energy, Hdd, bd = linearize_pass(idepth0, ~res_ok0, clamp=False)
    idp, e_res = idepth0, e0
    lam = torch.full((N,), 0.1, device=dev)
    for _ in range(settings.gn_its_on_point_activation):
        new_idp = idp - bd / (Hdd * (1.0 + lam))
        e1, oob1, eN, HN, bN = linearize_pass(new_idp, oob, clamp=True)
        accept = eN < energy
        idp = torch.where(accept, new_idp, idp)
        lam = torch.where(accept, lam * 0.5, lam * 5.0)
        Hdd = torch.where(accept, HN, Hdd)
        bd = torch.where(accept, bN, bd)
        energy = torch.where(accept, eN, energy)
        oob = torch.where(accept[:, None], oob1, oob)
        e_res = torch.where(accept[:, None], e1, e_res)
    res_in = ~oob & (e_res <= imm.energy_th[:, None]) & res_ok0
    n_good = torch.sum(res_in, -1)
    ok = (candidate & torch.isfinite(energy)
          & (Hdd >= settings.min_idepth_h_act) & torch.isfinite(idp)
          & (n_good >= 1) & (idp > 0))
    return idp, ok, res_in
