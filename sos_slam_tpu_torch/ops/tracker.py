"""Direct coarse tracking: frame-to-keyframe photometric alignment
(port of sos_slam_tpu/ops/tracker.py; reference CoarseTracker::
trackNewestCoarse / calcResPose / calcGSSSEPose, CoarseTracker.cpp:366-764).

Motion hypotheses are a leading batch axis K throughout: one call tracks K
initial poses at once (the JAX package's vmap). The Levenberg loop runs
while any hypothesis is still active; finished hypotheses are frozen by
masks, which is exactly the batched while-loop semantics of the JAX form.
The loop conditions are read on the host (one sync per LM iteration).

Parity: Jacobian, Huber/cutoff energy, (1/n) normalization, DSO's
conditioning rescale S = [1,1,1,.5,.5,.5,10,1000], lambda schedule
(x0.5 / x4), extrapolation factor, inc-norm break at 1e-3, the
cutoff-doubling loop and the per-level iteration caps {10,20,50,50,50}.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sos_slam_tpu_torch.ops.numerics import solve
from sos_slam_tpu_torch.ops.image import interp_bilinear
from sos_slam_tpu_torch.utils import lie

_SCALE8 = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)
MAX_ITERS_PER_LEVEL = (10, 20, 50, 50, 50, 50)
LAMBDA_EXTRAPOLATION_LIMIT = 1e-3


class LevelTemplate(NamedTuple):
    """Padded semi-dense tracking template at one pyramid level."""

    u: torch.Tensor       # (N,) pixel x in the reference KF
    v: torch.Tensor       # (N,) pixel y
    idepth: torch.Tensor  # (N,) inverse depth in the reference KF
    color: torch.Tensor   # (N,) reference intensity
    valid: torch.Tensor   # (N,) bool


def aff_from_to(exp_f, exp_t, aff_f, aff_t) -> torch.Tensor:
    """Exposure-aware affine transfer (a, b): I_t ~= a * I_f + b.
    aff_* carry [a, b] on their leading axis."""
    exp_f = torch.where(exp_f == 0, torch.ones_like(exp_f), exp_f)
    exp_t = torch.where(exp_t == 0, torch.ones_like(exp_t), exp_t)
    a = torch.exp(aff_t[0] - aff_f[0]) * exp_t / exp_f
    b = aff_t[1] - a * aff_f[1]
    return torch.stack([a, b])


def res_and_hb(dI_new, tmpl: LevelTemplate, T: torch.Tensor, aff_ab, ref_b0,
               intr, cutoff, huber: float, compute_flow: bool = False):
    """One fused residual + Gauss-Newton pass at one level, for K poses.

    T (K,4,4); aff_ab (K,2) transfer [a, b]; ref_b0 scalar; cutoff (K,).
    Returns dict of (K,...) E, num_in, num_sat, H (8,8), b (8,) and
    optionally the flow indicators."""
    fx, fy, cx, cy = intr
    h, w = dI_new.shape[0], dI_new.shape[1]
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    xn = torch.stack([(tmpl.u - cx) / fx, (tmpl.v - cy) / fy,
                      torch.ones_like(tmpl.u)], -1)           # (N,3)
    pt = torch.einsum("nj,kij->kni", xn, R) \
        + t[:, None, :] * tmpl.idepth[None, :, None]          # (K,N,3)
    u_ = pt[..., 0] / pt[..., 2]
    v_ = pt[..., 1] / pt[..., 2]
    Ku = fx * u_ + cx
    Kv = fy * v_ + cy
    new_idepth = tmpl.idepth[None] / pt[..., 2]
    inb = (tmpl.valid[None] & (Ku > 2) & (Kv > 2) & (Ku < w - 3)
           & (Kv < h - 3) & (new_idepth > 0))
    hit = interp_bilinear(dI_new, Ku, Kv)                     # (K,N,3)
    inb = inb & torch.isfinite(hit[..., 0])

    a_t = aff_ab[:, 0:1]
    r = hit[..., 0] - (a_t * tmpl.color[None] + aff_ab[:, 1:2])
    abs_r = torch.abs(r)
    hw = torch.where(abs_r < huber, torch.ones_like(abs_r),
                     huber / torch.clamp(abs_r, min=1e-9))
    cut = cutoff[:, None]
    saturated = inb & (abs_r > cut)
    active = inb & ~saturated
    max_energy = 2.0 * huber * cut - huber * huber
    zero = torch.zeros_like(r)
    E = torch.sum(torch.where(saturated, max_energy.expand_as(r), zero)
                  + torch.where(active, hw * r * r * (2.0 - hw), zero), -1)
    num_in = torch.sum(inb, -1)
    num_sat = torch.sum(saturated, -1)

    dxf = hit[..., 1] * fx
    dyf = hit[..., 2] * fy
    idp = new_idepth
    J = torch.stack([
        idp * dxf,
        idp * dyf,
        -idp * (u_ * dxf + v_ * dyf),
        -(u_ * v_ * dxf + dyf * (1.0 + v_ * v_)),
        u_ * v_ * dyf + dxf * (1.0 + u_ * u_),
        u_ * dyf - v_ * dxf,
        (a_t * (ref_b0 - tmpl.color[None])).expand_as(u_),
        -torch.ones_like(u_),
    ], -1)
    Jr = torch.cat([J, r[..., None]], -1)                     # (K,N,9)
    wts = torch.where(active, hw, zero)
    M = torch.einsum("kni,knj->kij", Jr * wts[..., None], Jr)
    n_act = torch.clamp(torch.sum(active, -1).to(torch.float32), min=1.0)
    H = M[:, :8, :8] / n_act[:, None, None]
    b = M[:, :8, 8] / n_act[:, None]
    out = dict(E=E, num_in=num_in, num_sat=num_sat, H=H, b=b)

    if compute_flow:
        N = tmpl.u.shape[0]
        stride = tmpl.valid & (torch.arange(N, device=tmpl.u.device) % 32 == 0)
        tid = t[:, None, :] * tmpl.idepth[None, :, None]

        def shift(pp):
            uu = fx * (pp[..., 0] / pp[..., 2]) + cx
            vv = fy * (pp[..., 1] / pp[..., 2]) + cy
            return (uu - tmpl.u) ** 2 + (vv - tmpl.v) ** 2

        ptT = xn[None] + tid
        ptT2 = xn[None] - tid
        pt3 = torch.einsum("nj,kij->kni", xn, R) - tid
        zf = torch.zeros_like(u_)
        ssT = torch.sum(torch.where(stride, shift(ptT) + shift(ptT2), zf), -1)
        ssRT = torch.sum(torch.where(stride, shift(pt) + shift(pt3), zf), -1)
        n_flow = 2.0 * torch.sum(stride)
        out["flow_t"] = ssT / (n_flow + 0.1)
        out["flow_rt"] = ssRT / (n_flow + 0.1)
    return out


def _solve_damped(H, b, lam, fix_a: bool, fix_b: bool):
    """Scaled, damped 8x8 solve for K systems. Returns (scaled step, raw
    inc for the norm check), both (K,8)."""
    S = torch.tensor(_SCALE8, dtype=H.dtype, device=H.device)
    Hs = H * S[:, None] * S[None, :]
    bs = b * S
    Hl = Hs + torch.diag_embed(torch.diagonal(Hs, dim1=-2, dim2=-1)) \
        * lam[:, None, None]
    mask = torch.tensor([1.0] * 6 + [0.0 if fix_a else 1.0,
                                     0.0 if fix_b else 1.0],
                        dtype=H.dtype, device=H.device)
    Hl = Hl * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    bs = bs * mask
    inc = solve(Hl, -bs)
    extrap = torch.where(
        lam < LAMBDA_EXTRAPOLATION_LIMIT,
        torch.sqrt(torch.sqrt(LAMBDA_EXTRAPOLATION_LIMIT
                              / torch.clamp(lam, min=1e-12))),
        torch.ones_like(lam))
    inc = inc * extrap[:, None]
    inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
    return inc * S * mask, inc


def _sel(m, a, b):
    """Per-hypothesis select: m (K,) against a/b (K, ...)."""
    return torch.where(m.reshape(m.shape + (1,) * (a.dim() - 1)), a, b)


def track_level(dI_new, tmpl: LevelTemplate, T0, aff0, ref_aff, exposures,
                intr, max_iters: int, coarse_cutoff_th: float, huber: float,
                fix_a: bool = False, fix_b: bool = False):
    """LM at one pyramid level for K hypotheses. T0 (K,4,4), aff0 (K,2).
    Returns (T, aff, rms, cutoff_repeat, flow_t, flow_rt), each (K,...)."""
    K = T0.shape[0]
    dev = T0.device

    def res_pass(T, aff, cutoff, flow=False):
        aff_ab = aff_from_to(exposures[0], exposures[1], ref_aff[:, None],
                             aff.T).T
        return res_and_hb(dI_new, tmpl, T, aff_ab, ref_aff[1], intr, cutoff,
                          huber, compute_flow=flow)

    cut0 = torch.full((K,), coarse_cutoff_th, dtype=torch.float32, device=dev)
    r0 = res_pass(T0, aff0, cut0, flow=True)
    sat = r0["num_sat"] / torch.clamp(r0["num_in"], min=1)
    rep = torch.ones(K, dtype=torch.float32, device=dev)
    while True:
        go = (sat > 0.6) & (rep < 50.0)
        if not bool(go.any()):
            break
        rep = torch.where(go, rep * 2.0, rep)
        r = res_pass(T0, aff0, coarse_cutoff_th * rep)
        sat = torch.where(go, r["num_sat"] / torch.clamp(r["num_in"], min=1),
                          sat)
    cutoff = coarse_cutoff_th * rep
    redo = rep > 1.0
    if bool(redo.any()):
        r1 = res_pass(T0, aff0, cutoff, flow=True)
        r0 = {k: _sel(redo, r1[k], r0[k]) for k in r0}

    s = dict(it=torch.zeros(K, dtype=torch.int32, device=dev), T=T0,
             aff=aff0, E=r0["E"], num=r0["num_in"], H=r0["H"], b=r0["b"],
             lam=torch.full((K,), 0.01, dtype=torch.float32, device=dev),
             done=torch.zeros(K, dtype=torch.bool, device=dev))
    while True:
        active = ~s["done"] & (s["it"] < max_iters)
        if not bool(active.any()):
            break
        step, inc_raw = _solve_damped(s["H"], s["b"], s["lam"], fix_a, fix_b)
        T_new = lie.se3_exp(step[:, :6]) @ s["T"]
        aff_new = s["aff"] + step[:, 6:8]
        rn = res_pass(T_new, aff_new, cutoff)
        nan = torch.full_like(rn["E"], float("nan"))
        mean_new = torch.where(rn["num_in"] > 0, rn["E"] / rn["num_in"], nan)
        mean_old = torch.where(s["num"] > 0, s["E"] / s["num"], nan)
        accept = active & (mean_new < mean_old)
        new_lam = torch.where(accept, s["lam"] * 0.5,
                              torch.clamp(s["lam"] * 4.0,
                                          min=LAMBDA_EXTRAPOLATION_LIMIT))
        done = s["done"] | (active & (torch.linalg.norm(inc_raw, dim=-1)
                                      <= 1e-3))
        s = dict(
            it=s["it"] + active.to(torch.int32),
            T=_sel(accept, T_new, s["T"]),
            aff=_sel(accept, aff_new, s["aff"]),
            E=_sel(accept, rn["E"], s["E"]),
            num=_sel(accept, rn["num_in"], s["num"]),
            H=_sel(accept, rn["H"], s["H"]),
            b=_sel(accept, rn["b"], s["b"]),
            lam=torch.where(active, new_lam, s["lam"]),
            done=done,
        )
    rms = torch.sqrt(torch.where(
        s["num"] > 0, s["E"] / torch.clamp(s["num"], min=1),
        torch.full_like(s["E"], float("nan"))))
    return s["T"], s["aff"], rms, rep, r0["flow_t"], r0["flow_rt"]


def track_newest_coarse(pyramid_new, templates, T_init, aff_init, ref_aff,
                        exposures, min_res_for_abort, intrinsics,
                        n_levels: int, coarse_cutoff_th: float = 20.0,
                        huber: float = 9.0, fix_a: bool = False,
                        fix_b: bool = False, min_level: int = 0):
    """Coarse-to-fine track of K hypotheses down to `min_level`.

    T_init (K,4,4); aff_init (2,); min_res_for_abort (6,) with NaN = no
    bound. Returns dict of (K,...) T, aff, residuals (6,), flow (2,),
    good."""
    K = T_init.shape[0]
    dev = T_init.device
    T = T_init
    aff = aff_init[None].expand(K, 2).clone()
    residuals = torch.full((K, 6), float("nan"), dtype=torch.float32,
                           device=dev)
    flow = torch.zeros((K, 2), dtype=torch.float32, device=dev)
    good = torch.ones(K, dtype=torch.bool, device=dev)
    have_repeated = torch.zeros(K, dtype=torch.bool, device=dev)

    for lvl in range(n_levels - 1, min_level - 1, -1):
        max_it = MAX_ITERS_PER_LEVEL[min(lvl, len(MAX_ITERS_PER_LEVEL) - 1)]

        def run(T_, aff_, lvl=lvl, max_it=max_it):
            return track_level(pyramid_new[lvl], templates[lvl], T_, aff_,
                               ref_aff, exposures, intrinsics[lvl], max_it,
                               coarse_cutoff_th, huber, fix_a, fix_b)

        T1, aff1, rms, cut_rep, ft, frt = run(T, aff)
        do_rep = (cut_rep > 1.0) & ~have_repeated
        have_repeated = have_repeated | do_rep
        if bool(do_rep.any()):
            T2, aff2, rms2, _, ft2, frt2 = run(T1, aff1)
            T1, aff1 = _sel(do_rep, T2, T1), _sel(do_rep, aff2, aff1)
            rms, ft, frt = (_sel(do_rep, rms2, rms), _sel(do_rep, ft2, ft),
                            _sel(do_rep, frt2, frt))

        bound = min_res_for_abort[lvl]
        lvl_ok = torch.isnan(bound) | (rms <= 1.5 * bound)
        good = good & lvl_ok & torch.isfinite(rms)
        T = _sel(good, T1, T)
        aff = _sel(good, aff1, aff)
        residuals[:, lvl] = torch.where(good, rms, torch.full_like(rms,
                                                                   float("nan")))
        if lvl == 0:
            flow = torch.stack([torch.where(good, ft, flow[:, 0]),
                                torch.where(good, frt, flow[:, 1])], -1)

    good = good & (torch.abs(aff[:, 0]) < 1.2) & (torch.abs(aff[:, 1]) < 200.0)
    good = good & torch.isfinite(T).reshape(K, -1).all(-1)
    return dict(T=T, aff=aff, residuals=residuals, flow=flow, good=good)


def track_hypotheses(pyramid_new, templates, T_inits, aff_init, ref_aff,
                     exposures, intrinsics, n_levels: int, min_level: int = 0,
                     **kw):
    """The batched multi-hypothesis track (FullSystem::trackNewCoarse's
    restarts as one batch, FullSystem.cpp:188-270)."""
    nan6 = torch.full((6,), float("nan"), dtype=torch.float32,
                      device=T_inits.device)
    return track_newest_coarse(pyramid_new, templates, T_inits, aff_init,
                               ref_aff, exposures, nan6, tuple(intrinsics),
                               n_levels, min_level=min_level, **kw)
