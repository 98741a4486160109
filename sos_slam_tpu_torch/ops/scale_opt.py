"""Stereo 1-DoF metric-scale optimization (port of
sos_slam_tpu/ops/scale_opt.py; reference ScaleOptimizer.cpp:120-437 and
FullSystem::optimizeScale, FullSystem.cpp:1117-1180).

The left keyframe's semi-dense template (the one the coarse tracker uses)
is warped into the right camera at p1 = s * R01 K0^-1 x + t01 * id; a
coarse-to-fine 1-DoF LM solves for the scale s.

Scale guesses are a leading batch axis G throughout: `optimize_scale`
takes a (G,) start and the multi-guess initialization
{0.1, 0.2, 0.5, 1, 2, 5, 10} is one call with G = 7 (the JAX package's
vmap). The cutoff-doubling loop and the LM loop run while any guess is
still active; a finished guess is frozen by masks, and the per-level
repeat runs for every guess and is kept only where it is due, which is
what the JAX while loops and cond do under vmap.

Two forms of the same loops: the eager one reads each loop condition on
the host (one sync per trip) and leaves early; the bounded one
(`bounded=True`) reads nothing back: each loop is an `ops/control.py`
`while_loop` and the repeat a `cond`, which inside a CUDA graph's capture
are conditional nodes (the JAX package's `while_loop`s and `cond`: the
loop leaves, the repeat is skipped, on the device) and elsewhere run each
loop to its bound (`rep < 50` allows 6 cutoff doublings, the LM loop
`max_iters` trips) and the repeat always, kept where due; the finished
guesses are frozen, so both forms give the eager form's bits. The
scale-independent part of a level's warp (the template's bearings and the
Jacobian's numerators) is made once a level.
"""

from __future__ import annotations

import collections
import functools
from typing import Tuple

import torch

from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops.image import interp_bilinear
from sos_slam_tpu_torch.ops.tracker import (LAMBDA_EXTRAPOLATION_LIMIT,
                                            MAX_ITERS_PER_LEVEL,
                                            LevelTemplate, _loop, _set)

SCALE_GUESSES = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0)   # FullSystem.cpp:1135


def _level_consts(tmpl: LevelTemplate, R01, t01, intr0):
    """The scale-independent part of a level's warp: the template points'
    rotated bearings R01 K0^-1 x and the numerators of du/ds and dv/ds
    (calcGSSSEScale, ScaleOptimizer.cpp:232-271)."""
    fx0, fy0, cx0, cy0 = intr0
    xn = torch.stack([(tmpl.u - cx0) / fx0, (tmpl.v - cy0) / fy0,
                      torch.ones_like(tmpl.u)], -1)
    rKx = xn @ R01.T                                      # (N,3)
    rx = rKx / torch.clamp(tmpl.idepth, min=1e-12)[:, None]
    xno = rx[:, 0] * t01[2] - rx[:, 2] * t01[0]
    yno = rx[:, 1] * t01[2] - rx[:, 2] * t01[1]
    return rKx, rx, xno, yno


def _res(dI_right, tmpl, consts, scale, t01, intr1, cutoff, huber) -> dict:
    """`res_and_hb_scale` on a level's `_level_consts`."""
    rKx, rx, xno, yno = consts
    fx1, fy1, cx1, cy1 = intr1
    h, w = dI_right.shape[0], dI_right.shape[1]
    pt = scale[:, None, None] * rKx[None] \
        + t01[None, None, :] * tmpl.idepth[None, :, None]  # (G,N,3)
    u_ = pt[..., 0] / pt[..., 2]
    v_ = pt[..., 1] / pt[..., 2]
    Ku = fx1 * u_ + cx1
    Kv = fy1 * v_ + cy1
    new_idepth = tmpl.idepth[None] / pt[..., 2]

    inb = (tmpl.valid[None] & (Ku > 2) & (Kv > 2) & (Ku < w - 3)
           & (Kv < h - 3) & (new_idepth > 0))
    hit = interp_bilinear(dI_right, Ku, Kv)               # (G,N,3)
    inb = inb & torch.isfinite(hit[..., 0])

    r = hit[..., 0] - tmpl.color[None]
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

    # dr/ds with rx = R K^-1 x / id: du/ds = (rx0*tz - rx2*tx) /
    # (s*rx2 + tz)^2, alike for v
    denom = scale[:, None] * rx[None, :, 2] + t01[2]
    deno = 1.0 / torch.clamp(denom * denom, min=1e-18)
    J = hit[..., 1] * fx1 * deno * xno + hit[..., 2] * fy1 * deno * yno

    wts = torch.where(active, hw, zero)
    n_act = torch.clamp(torch.sum(active, -1).to(torch.float32), min=1.0)
    H = torch.sum(wts * J * J, -1) / n_act
    b = torch.sum(wts * J * r, -1) / n_act
    return dict(E=E, num_in=num_in, num_sat=num_sat, H=H, b=b)


def res_and_hb_scale(dI_right: torch.Tensor, tmpl: LevelTemplate,
                     scale: torch.Tensor, R01: torch.Tensor,
                     t01: torch.Tensor, intr0: Tuple, intr1: Tuple,
                     cutoff: torch.Tensor, huber: float) -> dict:
    """Energy and 1-DoF normal equations at one level for G scales.
    scale and cutoff (G,). Returns dict of (G,) E, num_in, num_sat, H, b."""
    return _res(dI_right, tmpl, _level_consts(tmpl, R01, t01, intr0), scale,
                t01, intr1, cutoff, huber)


# the cutoff doubles while rep < 50: at most 6 times from 1
MAX_DOUBLINGS = 6


# the eager form's trips, counted by (G, level, doublings, LM trips,
# repeat's doublings, repeat's LM trips)
TRIPS = collections.Counter()


def scale_level(dI_right, tmpl, scale0, R01, t01, intr0, intr1,
                max_iters: int, coarse_cutoff_th: float, huber: float,
                bounded: bool = False):
    """1-DoF LM at one level with the cutoff-doubling loop, for G scales
    scale0 (G,), in the eager or the bounded form (module docstring).
    Returns (scale, rms, cutoff_repeat, (doublings, LM trips) made; 0 in
    the bounded form), each of the first three (G,)."""
    G = scale0.shape[0]
    dev = scale0.device
    consts = _level_consts(tmpl, R01, t01, intr0)

    def res(s, cutoff):
        return _res(dI_right, tmpl, consts, s, t01, intr1, cutoff, huber)

    c = dict(rep=torch.ones(G, dtype=torch.float32, device=dev))
    r0 = res(scale0, coarse_cutoff_th * c["rep"])
    c["sat"] = r0["num_sat"] / torch.clamp(r0["num_in"], min=1)

    def c_go():
        return (c["sat"] > 0.6) & (c["rep"] < 50.0)

    def c_body():
        go = c_go()
        rep = torch.where(go, c["rep"] * 2.0, c["rep"])
        rr = res(scale0, coarse_cutoff_th * rep)
        _set(c, bounded, rep=rep, sat=torch.where(
            go, rr["num_sat"] / torch.clamp(rr["num_in"], min=1), c["sat"]))

    n_dbl = _loop(bounded, c_go, c_body, MAX_DOUBLINGS)
    rep = c["rep"]
    cutoff = coarse_cutoff_th * rep
    r0 = res(scale0, cutoff)

    s = dict(it=torch.zeros(G, dtype=torch.int32, device=dev),
             scale=scale0.clone() if bounded else scale0,
             E=r0["E"], num=r0["num_in"], H=r0["H"], b=r0["b"],
             lam=torch.full((G,), 0.01, dtype=torch.float32, device=dev),
             done=torch.zeros(G, dtype=torch.bool, device=dev))

    def lm_go():
        return (s["it"] < max_iters) & ~s["done"]

    def lm_body():
        active = lm_go()
        Hl = s["H"] * (1.0 + s["lam"])
        inc = -s["b"] / torch.where(torch.abs(Hl) < 1e-18,
                                    torch.full_like(Hl, 1e-18), Hl)
        extrap = torch.where(
            s["lam"] < LAMBDA_EXTRAPOLATION_LIMIT,
            torch.sqrt(torch.sqrt(LAMBDA_EXTRAPOLATION_LIMIT
                                  / torch.clamp(s["lam"], min=1e-12))),
            torch.ones_like(s["lam"]))
        inc = inc * extrap
        inc = torch.where(torch.isfinite(inc) & (torch.abs(inc) <= s["scale"]),
                          inc, torch.zeros_like(inc))
        s_new = s["scale"] + inc
        rn = res(s_new, cutoff)
        nan = torch.full_like(rn["E"], float("nan"))
        mean_new = torch.where(rn["num_in"] > 0, rn["E"] / rn["num_in"], nan)
        mean_old = torch.where(s["num"] > 0, s["E"] / s["num"], nan)
        accept = active & (mean_new < mean_old)

        def sel(a, b_):
            return torch.where(accept, a, b_)

        new_lam = torch.where(accept, s["lam"] * 0.5,
                              torch.clamp(s["lam"] * 4.0,
                                          min=LAMBDA_EXTRAPOLATION_LIMIT))
        _set(s, bounded, it=s["it"] + active.to(torch.int32),
                scale=sel(s_new, s["scale"]),
                E=sel(rn["E"], s["E"]), num=sel(rn["num_in"], s["num"]),
                H=sel(rn["H"], s["H"]), b=sel(rn["b"], s["b"]),
                lam=torch.where(active, new_lam, s["lam"]),
                done=torch.where(active, ~(inc > 1e-3), s["done"]))

    n_lm = _loop(bounded, lm_go, lm_body, max_iters)
    rms = torch.sqrt(torch.where(
        s["num"] > 0, s["E"] / torch.clamp(s["num"], min=1),
        torch.full_like(s["E"], float("nan"))))
    return s["scale"], rms, rep, (n_dbl, n_lm)


def optimize_scale(pyr_right, templates, scale_init: torch.Tensor,
                   R01: torch.Tensor, t01: torch.Tensor, intr0: Tuple,
                   intr1: Tuple, n_levels: int,
                   coarse_cutoff_th: float = 20.0, huber: float = 9.0):
    """Coarse-to-fine scale LM (ScaleOptimizer::optimizeScale) for G start
    scales scale_init (G,), eagerly. Returns (scale, rms at level 0), each
    (G,)."""
    return scale_lm(pyr_right, templates, scale_init, R01, t01, intr0,
                    intr1, n_levels, coarse_cutoff_th, huber)


def scale_lm(pyr_right, templates, scale_init: torch.Tensor,
             R01: torch.Tensor, t01: torch.Tensor, intr0: Tuple,
             intr1: Tuple, n_levels: int, coarse_cutoff_th: float = 20.0,
             huber: float = 9.0, bounded: bool = False):
    """`optimize_scale` in either form (module docstring). Returns (scale,
    rms at level 0), each (G,)."""
    scale = scale_init
    G = scale.shape[0]
    rms0 = torch.full_like(scale, float("nan"))
    have_rep = torch.zeros_like(scale, dtype=torch.bool)
    for lvl in range(n_levels - 1, -1, -1):
        max_it = MAX_ITERS_PER_LEVEL[min(lvl, len(MAX_ITERS_PER_LEVEL) - 1)]

        def run(s, lvl=lvl, max_it=max_it):
            return scale_level(pyr_right[lvl], templates[lvl], s, R01, t01,
                               intr0[lvl], intr1[lvl], max_it,
                               coarse_cutoff_th, huber, bounded)

        scale, rms, cut_rep, made = run(scale)
        do_rep = (cut_rep > 1.0) & ~have_rep
        have_rep = have_rep | do_rep

        def repeat(scale=scale, rms=rms, do_rep=do_rep, run=run):
            scale2, rms2, _, made2 = run(scale)
            repeat.made = made2
            return (torch.where(do_rep, scale2, scale),
                    torch.where(do_rep, rms2, rms))

        repeat.made = (0, 0)
        if bounded:
            control.cond(do_rep.any(), repeat, None, out=(scale, rms))
        else:
            if bool(do_rep.any()):
                scale, rms = repeat()
            TRIPS[(G, lvl) + made + repeat.made] += 1
        if lvl == 0:
            rms0 = rms
    return scale, rms0


@functools.lru_cache(maxsize=None)
def _guesses(device) -> torch.Tensor:
    """SCALE_GUESSES on `device`, uploaded once."""
    return torch.tensor(SCALE_GUESSES, dtype=torch.float32, device=device)


def optimize_scale_multi_guess(pyr_right, templates, R01, t01, intr0, intr1,
                               n_levels: int, **kw):
    """The untrapped multi-guess initialization (FullSystem.cpp:1135-1147):
    every guess in one batch, eagerly. Returns (best scale, its error),
    0-d."""
    return multi_guess(pyr_right, templates, R01, t01, intr0, intr1,
                       n_levels, **kw)


def multi_guess(pyr_right, templates, R01, t01, intr0, intr1, n_levels: int,
                **kw):
    """`optimize_scale_multi_guess` in either form (`scale_lm`'s
    `bounded`). Returns (best scale, its error), 0-d."""
    scales, errs = scale_lm(
        pyr_right, templates, _guesses(R01.device), R01, t01, tuple(intr0),
        tuple(intr1), n_levels, **kw)
    errs = torch.where(torch.isfinite(errs) & (errs > 0), errs,
                       torch.full_like(errs, float("inf")))
    i = torch.argmin(errs).reshape(1)
    return scales.index_select(0, i)[0], errs.index_select(0, i)[0]
