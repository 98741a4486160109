"""Direct coarse tracking: frame-to-keyframe photometric alignment
(port of sos_slam_tpu/ops/tracker.py; reference CoarseTracker::
trackNewestCoarse / calcResPose / calcGSSSEPose, CoarseTracker.cpp:366-764).

Motion hypotheses are a leading batch axis K throughout: one call tracks K
initial poses at once (the JAX package's vmap). The Levenberg loop runs
while any hypothesis is still active; finished hypotheses are frozen by
masks, which is exactly the batched while-loop semantics of the JAX form.

Every control point (the cutoff-doubling loop, the re-pass at a raised
cutoff, the LM loop, the level repeat) runs in one of two forms:
  * eager (the default): the host reads the condition, one sync a trip,
    and leaves a loop early;
  * bounded (`bounded=True`), with no host read: each loop is an
    `ops/control.py` `while_loop` and each branch a `cond`, which inside a
    CUDA graph's capture are conditional nodes (the JAX package's
    `lax.while_loop` and `lax.cond`: the loop leaves, the branch is
    skipped, on the device) and elsewhere run each loop to its bound and
    each branch always. Each update is chosen by the masks (`go`, `redo`,
    `active`, `do_rep`), so a trip past the early exit changes no bit:
    both give the eager form's bits (as the JAX package's `SOS_TRACK_UNROLL`
    cond unroll gives its while loop's).

Parity: Jacobian, Huber/cutoff energy, (1/n) normalization, DSO's
conditioning rescale S = [1,1,1,.5,.5,.5,10,1000], lambda schedule
(x0.5 / x4), extrapolation factor, inc-norm break at 1e-3, the
cutoff-doubling loop and the per-level iteration caps {10,20,50,50,50}.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops.numerics import solve
from sos_slam_tpu_torch.ops.image import interp_bilinear
from sos_slam_tpu_torch.utils import lie

_SCALE8 = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)
MAX_ITERS_PER_LEVEL = (10, 20, 50, 50, 50, 50)
LAMBDA_EXTRAPOLATION_LIMIT = 1e-3
CUTOFF_DOUBLINGS = 6   # the repeat runs 1 -> 64 under repeat < 50


def _own(bounded: bool, d: dict) -> dict:
    """A loop's state: the bounded forms write their updates in place, so
    they start from copies of their own."""
    return control.clone(d) if bounded else d


def _set(d: dict, bounded: bool, **new) -> None:
    """Update a loop's state: in place in the bounded forms (a CUDA graph
    keeps the buffers it captured), by rebinding in the eager one."""
    if bounded:
        for k, v in new.items():
            d[k].copy_(v)
    else:
        d.update(new)


def _loop(bounded: bool, go_fn, body, cap: int) -> int:
    """`body()` while `go_fn()` holds on any lane, at most `cap` times: a
    `control.while_loop` in the bounded form (returns 0), read on the host
    each trip in the eager one (returns the trips made)."""
    if bounded:
        control.while_loop(lambda: go_fn().any(), body, cap)
        return 0
    k = 0
    while k < cap and bool(go_fn().any()):
        body()
        k += 1
    return k


def _branch(bounded: bool, pred, fn, out: dict) -> None:
    """`out.update(fn())` where the lane mask `pred` holds on any lane (fn
    selects by the lanes itself): a `control.cond` into `out`'s tensors
    in the bounded form, read on the host in the eager one."""
    if bounded:
        control.cond(pred.any(), fn, None, out=out)
    elif bool(pred.any()):
        out.update(fn())


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


# made once per device and shared (read-only): making one is a host-to-device
# copy, which a CUDA graph cannot capture and which stalls the eager form
@functools.lru_cache(maxsize=None)
def _scale_and_mask(device, dtype, fix_a: bool, fix_b: bool):
    """The conditioning scale S and the fixed-affine mask of the damped
    solve."""
    S = torch.tensor(_SCALE8, dtype=dtype, device=device)
    mask = torch.tensor([1.0] * 6 + [0.0 if fix_a else 1.0,
                                     0.0 if fix_b else 1.0],
                        dtype=dtype, device=device)
    return S, mask


def _solve_damped(H, b, lam, fix_a: bool, fix_b: bool):
    """Scaled, damped 8x8 solve for K systems. Returns (scaled step, raw
    inc for the norm check), both (K,8)."""
    S, mask = _scale_and_mask(H.device, H.dtype, fix_a, fix_b)
    Hs = H * S[:, None] * S[None, :]
    bs = b * S
    Hl = Hs + torch.diag_embed(torch.diagonal(Hs, dim1=-2, dim2=-1)) \
        * lam[:, None, None]
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
                fix_a: bool = False, fix_b: bool = False,
                bounded: bool = False):
    """LM at one pyramid level for K hypotheses. T0 (K,4,4), aff0 (K,2).
    Returns (T, aff, rms, cutoff_repeat, flow_t, flow_rt, iterations),
    each (K,...). `bounded`: the bounded form (module docstring)."""
    K = T0.shape[0]
    dev = T0.device

    def res_pass(T, aff, cutoff, flow=False):
        aff_ab = aff_from_to(exposures[0], exposures[1], ref_aff[:, None],
                             aff.T).T
        return res_and_hb(dI_new, tmpl, T, aff_ab, ref_aff[1], intr, cutoff,
                          huber, compute_flow=flow)

    def sat_of(r):
        return r["num_sat"] / torch.clamp(r["num_in"], min=1)

    cut0 = torch.full((K,), coarse_cutoff_th, dtype=torch.float32, device=dev)
    r0 = _own(bounded, res_pass(T0, aff0, cut0, flow=True))
    c = _own(bounded, dict(rep=torch.ones(K, dtype=torch.float32, device=dev),
                           sat=sat_of(r0)))

    def c_go():
        return (c["sat"] > 0.6) & (c["rep"] < 50.0)

    def c_body():
        go = c_go()
        rep = torch.where(go, c["rep"] * 2.0, c["rep"])
        r = res_pass(T0, aff0, coarse_cutoff_th * rep)
        _set(c, bounded, rep=rep, sat=torch.where(go, sat_of(r), c["sat"]))

    _loop(bounded, c_go, c_body, CUTOFF_DOUBLINGS)
    rep = c["rep"]
    cutoff = coarse_cutoff_th * rep
    redo = rep > 1.0

    def repass():
        r1 = res_pass(T0, aff0, cutoff, flow=True)
        return {k: _sel(redo, r1[k], r0[k]) for k in r0}

    _branch(bounded, redo, repass, r0)

    s = _own(bounded, dict(
        it=torch.zeros(K, dtype=torch.int32, device=dev), T=T0, aff=aff0,
        E=r0["E"], num=r0["num_in"], H=r0["H"], b=r0["b"],
        lam=torch.full((K,), 0.01, dtype=torch.float32, device=dev),
        done=torch.zeros(K, dtype=torch.bool, device=dev)))

    def lm_go():
        return ~s["done"] & (s["it"] < max_iters)

    def lm_body():
        active = lm_go()
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
        _set(s, bounded,
             it=s["it"] + active.to(torch.int32),
             T=_sel(accept, T_new, s["T"]),
             aff=_sel(accept, aff_new, s["aff"]),
             E=_sel(accept, rn["E"], s["E"]),
             num=_sel(accept, rn["num_in"], s["num"]),
             H=_sel(accept, rn["H"], s["H"]),
             b=_sel(accept, rn["b"], s["b"]),
             lam=torch.where(active, new_lam, s["lam"]),
             done=done)

    _loop(bounded, lm_go, lm_body, max_iters)
    rms = torch.sqrt(torch.where(
        s["num"] > 0, s["E"] / torch.clamp(s["num"], min=1),
        torch.full_like(s["E"], float("nan"))))
    return s["T"], s["aff"], rms, rep, r0["flow_t"], r0["flow_rt"], s["it"]


def track_newest_coarse(pyramid_new, templates, T_init, aff_init, ref_aff,
                        exposures, min_res_for_abort, intrinsics,
                        n_levels: int, coarse_cutoff_th: float = 20.0,
                        huber: float = 9.0, fix_a: bool = False,
                        fix_b: bool = False, min_level: int = 0,
                        bounded: bool = False, iters=None):
    """Coarse-to-fine track of K hypotheses down to `min_level`.

    T_init (K,4,4); aff_init (2,); min_res_for_abort (6,) with NaN = no
    bound. Returns dict of (K,...) T, aff, residuals (6,), flow (2,),
    good. `bounded`: the form (module docstring). `iters`: None, or a
    (K, n_levels) int32 tensor that the LM iterations run at each level
    (the repeat's included) are added to."""
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
                               coarse_cutoff_th, huber, fix_a, fix_b,
                               bounded)

        T1, aff1, rms, cut_rep, ft, frt, it1 = run(T, aff)
        lv = dict(T=T1, aff=aff1, rms=rms, ft=ft, frt=frt)
        do_rep = (cut_rep > 1.0) & ~have_repeated
        have_repeated = have_repeated | do_rep
        if iters is not None:
            iters[:, lvl] += it1
            lv["it"] = iters[:, lvl]

        def repeat(T1=T1, aff1=aff1, rms=rms, ft=ft, frt=frt, do_rep=do_rep,
                   lv=lv, run=run):
            T2, aff2, rms2, _, ft2, frt2, it2 = run(T1, aff1)
            new = dict(T=_sel(do_rep, T2, T1), aff=_sel(do_rep, aff2, aff1),
                       rms=_sel(do_rep, rms2, rms), ft=_sel(do_rep, ft2, ft),
                       frt=_sel(do_rep, frt2, frt))
            if "it" in lv:
                new["it"] = lv["it"] + torch.where(do_rep, it2,
                                                   torch.zeros_like(it2))
            return new

        _branch(bounded, do_rep, repeat, lv)
        if iters is not None and not bounded:
            iters[:, lvl] = lv["it"]
        T1, aff1, rms, ft, frt = (lv[k] for k in ("T", "aff", "rms", "ft",
                                                  "frt"))

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
