"""Sliding-window bundle adjustment driver + marginalization (port of
sos_slam_tpu/models/energy.py; reference FullSystem::optimize,
FullSystemOptimize.cpp:305-489, and EnergyFunctional::{marginalizeFrame,
marginalizePointsF}, EnergyFunctional.cpp:730-936).

Up to `max_opt_iterations` Gauss-Newton steps at fixed damping 1e-5, steps
always accepted, early break on small step norms; afterwards the newest
frame's FEJ point moves to its current pose and a final linearization
drops OOB/outlier residuals. Every linearization goes through kernel K3
(ops/ba_p.py:fused_iteration) at the `_iter_quants` and `_marg_Hb` seams.
The loop conditions are read on the host.
"""

from __future__ import annotations

import torch

from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import ba_p as BP
from sos_slam_tpu_torch.ops.numerics import inv
from sos_slam_tpu_torch.utils.config import CPARS, Settings


def _iter_quants(ba: B.BAState, pre: B.Precalc, dI, settings: Settings,
                 w: int, h: int) -> dict:
    """Everything one GN iteration consumes from the (P,F) linearization."""
    fo = BP.fused_iteration(ba, pre, dI, settings, w, h)
    return dict(Htop=fo.H_top, btop=fo.b_top, Hsc=fo.H_sc, bsc=fo.b_sc,
                resub=lambda x: BP.resubstitute_t(fo.sc, x), HdiF=fo.sc.HdiF,
                energy_pf=fo.energy.T, new_state_pf=fo.new_state.T,
                fo=fo, n_active=torch.sum(fo.active))


def _marg_Hb(ba: B.BAState, pre: B.Precalc, dI, marg, settings: Settings,
             w: int, h: int):
    """(H, b, H_sc, b_sc) of the marginalized-point subset, mode 2
    (FEJ-shifted res_toZero residuals)."""
    fo = BP.fused_iteration(ba, pre, dI, settings, w, h, pmask=marg,
                            use_rz=True, shift_prior_to_zero=False,
                            prior_fac=settings.idepth_fix_prior_marg_fac)
    return fo.H_top, fo.b_top, fo.H_sc, fo.b_sc


def gn_step(ba: B.BAState, dI, settings: Settings, w: int, h: int,
            ev: B.PrecalcEval | None = None):
    """One damped GN iteration. Returns (new ba, canbreak, energy)."""
    pre = B.make_precalc(ba, ev)
    q = _iter_quants(ba, pre, dI, settings, w, h)
    ba = ba._replace(energy_th=BP.update_energy_th_t(ba, q["fo"], settings))
    H_top, b_top = B.add_priors(ba, q["Htop"], q["btop"], settings)
    x = B.solve_system(ba, H_top, b_top, q["Hsc"], q["bsc"])
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    fv = ba.frame_valid[:, None].to(torch.float32)
    step_fr = -x[CPARS:].reshape(ba.F, 8) * fv
    step_c = -x[:CPARS]
    step_pt = q["resub"](x) * ba.pt_valid
    step_pt = torch.where(torch.isfinite(step_pt), step_pt,
                          torch.zeros_like(step_pt))
    new_id = ba.idepth + step_pt

    nvalid = max(int(torch.sum(ba.frame_valid)), 1)
    sumA = torch.sum(step_fr[:, 6] ** 2) / nvalid
    sumB = torch.sum(step_fr[:, 7] ** 2) / nvalid
    sumT = torch.sum(step_fr[:, 0:3] ** 2) / nvalid
    sumR = torch.sum(step_fr[:, 3:6] ** 2) / nvalid
    npt = max(int(torch.sum(ba.pt_valid)), 1)
    sumNID = torch.sum(torch.abs(ba.idepth) * ba.pt_valid) / npt
    th = settings.th_opt_iterations
    canbreak = ((torch.sqrt(sumA) < 0.0005 * th)
                & (torch.sqrt(sumB) < 0.00005 * th)
                & (torch.sqrt(sumR) < 0.00005 * th)
                & (torch.sqrt(sumT) * sumNID < 0.00005 * th))

    ns = q["new_state_pf"]
    live = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :] \
        & (ns != B.RES_OOB)
    energy = torch.sum(torch.where(live, q["energy_pf"],
                                   torch.zeros_like(q["energy_pf"])))
    ba = ba._replace(state=ba.state + step_fr, c=ba.c + step_c,
                     idepth=new_id, idepth_zero=new_id, res_state=ns)
    return ba, canbreak, energy


def optimize(ba: B.BAState, dI, settings: Settings, w: int, h: int,
             max_its: int = 6, min_its: int = 1):
    """The windowed BA (FullSystem::optimize). Returns (ba, stats dict)."""
    ba = ba._replace(res_state=torch.where(
        ba.res_exist, torch.full_like(ba.res_state, B.RES_IN), ba.res_state))
    ev = B.make_precalc_eval(ba)
    it = 0
    canbreak = False
    while it < max_its and not (canbreak and it >= min_its):
        ba, cb, _ = gn_step(ba, dI, settings, w, h, ev=ev)
        canbreak = bool(cb)
        it += 1

    newest = int(torch.sum(ba.frame_valid)) - 1
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    zero_pose = ba.state.clone()
    zero_pose[:, :6] = 0.0
    new_eval = ba.T_cw_eval.clone()
    new_eval[newest] = T_cw[newest]
    new_state = ba.state.clone()
    new_state[newest] = zero_pose[newest]
    new_zero = ba.state_zero.clone()
    new_zero[newest] = zero_pose[newest]
    ba = ba._replace(T_cw_eval=new_eval, state=new_state, state_zero=new_zero)

    pre = B.make_precalc(ba)
    q = _iter_quants(ba, pre, dI, settings, w, h)
    ns = q["new_state_pf"]
    ba = ba._replace(energy_th=BP.update_energy_th_t(ba, q["fo"], settings),
                     res_exist=ba.res_exist & (ns == B.RES_IN), res_state=ns)
    n_active = q["n_active"]
    live = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :]
    energy_final = torch.sum(torch.where(live, q["energy_pf"],
                                         torch.zeros_like(q["energy_pf"])))
    rmse = torch.sqrt(energy_final / torch.clamp(8.0 * n_active, min=1.0))
    return ba, dict(energy=energy_final, rmse=rmse, n_its=it,
                    n_active=n_active, is_lost=~torch.isfinite(energy_final),
                    HdiF=q["HdiF"])


def marginalize_points(ba: B.BAState, dI, marg, settings: Settings,
                       w: int, h: int) -> B.BAState:
    """Fold flagged points into HM/bM (marginalizePointsF) and drop them."""
    marg = marg & ba.pt_valid
    pre = B.make_precalc(ba)
    H, b, H_sc, b_sc = _marg_Hb(ba, pre, dI, marg, settings, w, h)
    HM = ba.HM + settings.marg_weight_fac * (H - H_sc)
    HM = 0.5 * (HM + HM.T)   # kill f32 rounding asymmetry
    bM = ba.bM + settings.marg_weight_fac * (b - b_sc)
    return ba._replace(HM=HM, bM=bM, pt_valid=ba.pt_valid & ~marg,
                       res_exist=ba.res_exist & ~marg[:, None])


def drop_points(ba: B.BAState, drop) -> B.BAState:
    """Remove points without marginalization (dropPointsF)."""
    drop = drop & ba.pt_valid
    return ba._replace(pt_valid=ba.pt_valid & ~drop,
                       res_exist=ba.res_exist & ~drop[:, None])


def marginalize_frame(ba: B.BAState, k: int) -> B.BAState:
    """Schur-marginalize frame slot k out of HM/bM and compact the window
    (EnergyFunctional::marginalizeFrame). Requires no remaining points
    hosted in k and no residuals targeting k."""
    F = ba.F
    D = CPARS + 8 * F
    dev = ba.HM.device
    n = int(torch.sum(ba.frame_valid))
    HM = ba.HM.clone()
    bM = ba.bM.clone()
    didx = CPARS + 8 * k + torch.arange(8, device=dev)
    HM[didx, didx] += ba.prior[k]
    bM[didx] += ba.prior[k] * ba.state[k]

    order = [b for b in range(F) if b != k and b < n] + [k] \
        + list(range(n, F))
    order_t = torch.tensor(order, device=dev)
    perm = torch.cat([torch.arange(CPARS, device=dev),
                      (CPARS + 8 * order_t[:, None]
                       + torch.arange(8, device=dev)[None, :]).reshape(-1)])
    HMp = HM[perm][:, perm]
    bMp = bM[perm]
    sl = CPARS + 8 * (n - 1)
    dim_idx = torch.arange(D, device=dev)
    in_marg = (dim_idx >= sl) & (dim_idx < sl + 8)
    svec = torch.sqrt(torch.abs(torch.diagonal(HMp)) + 10.0)
    svec_i = 1.0 / svec
    Hs = HMp * svec_i[:, None] * svec_i[None, :]
    bs = bMp * svec_i
    Hmm = Hs[sl:sl + 8, sl:sl + 8]
    Hmm = 0.5 * (Hmm + Hmm.T)
    Hmm_inv = inv(Hmm)
    Hmm_inv = 0.5 * (Hmm_inv + Hmm_inv.T)
    keep = (~in_marg).to(torch.float32)
    Hxm = Hs[:, sl:sl + 8] * keep[:, None]
    bli = Hxm @ Hmm_inv
    Hs_new = (Hs - bli @ Hxm.T) * keep[:, None] * keep[None, :]
    bs_new = (bs - bli @ bs[sl:sl + 8]) * keep
    HM2 = Hs_new * svec[:, None] * svec[None, :]
    HM2 = 0.5 * (HM2 + HM2.T)
    bM2 = bs_new * svec

    last = torch.arange(F, device=dev) == (n - 1)
    frame_valid = ba.frame_valid[order_t] & ~last
    fvf = frame_valid[:, None].to(torch.float32)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return ba._replace(
        frame_valid=frame_valid,
        T_cw_eval=torch.where(frame_valid[:, None, None],
                              ba.T_cw_eval[order_t], eye),
        state=ba.state[order_t] * fvf,
        state_zero=ba.state_zero[order_t] * fvf,
        exposure=ba.exposure[order_t], energy_th=ba.energy_th[order_t],
        prior=ba.prior[order_t] * fvf,
        host=torch.where(ba.host > k, ba.host - 1, ba.host),
        res_exist=ba.res_exist[:, order_t] & frame_valid[None, :],
        res_state=ba.res_state[:, order_t],
        HM=HM2, bM=bM2,
    )
