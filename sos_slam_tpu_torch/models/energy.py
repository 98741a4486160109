"""Sliding-window bundle adjustment driver + marginalization (port of
sos_slam_tpu/models/energy.py; reference FullSystem::optimize,
FullSystemOptimize.cpp:305-489, and EnergyFunctional::{marginalizeFrame,
marginalizePointsF}, EnergyFunctional.cpp:730-936).

Up to `max_opt_iterations` Gauss-Newton steps at fixed damping 1e-5, steps
always accepted, early break on small step norms; afterwards the newest
frame's FEJ point moves to its current pose and a final linearization
drops OOB/outlier residuals. Every linearization goes through kernel K3
(ops/ba_p.py:fused_iteration) at the `_iter_quants` and `_marg_Hb` seams.
The loop conditions are read on the host. The visual-inertial twins
(`gn_step_vio`, `optimize_vio`, `marginalize_frame_vio`,
`marginalize_points_vio`) solve the (5+29F)-dim KKT system of
models/imu.py around the same K3 linearizations.
"""

from __future__ import annotations

import torch

from sos_slam_tpu_torch.models import imu as IM
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


def _canbreak(ba: B.BAState, step_fr, settings: Settings):
    """The early-break test on a GN step's frame increments and the point
    depths (FullSystem::optimize's canbreak)."""
    nvalid = max(int(torch.sum(ba.frame_valid)), 1)
    sumA = torch.sum(step_fr[:, 6] ** 2) / nvalid
    sumB = torch.sum(step_fr[:, 7] ** 2) / nvalid
    sumT = torch.sum(step_fr[:, 0:3] ** 2) / nvalid
    sumR = torch.sum(step_fr[:, 3:6] ** 2) / nvalid
    npt = max(int(torch.sum(ba.pt_valid)), 1)
    sumNID = torch.sum(torch.abs(ba.idepth) * ba.pt_valid) / npt
    th = settings.th_opt_iterations
    return ((torch.sqrt(sumA) < 0.0005 * th)
            & (torch.sqrt(sumB) < 0.00005 * th)
            & (torch.sqrt(sumR) < 0.00005 * th)
            & (torch.sqrt(sumT) * sumNID < 0.00005 * th))


def _live_energy(ba: B.BAState, q: dict):
    """The energy of the linearization `q` over its live, in-bounds
    residuals."""
    live = ba.res_exist & ba.pt_valid[:, None] & ba.frame_valid[None, :] \
        & (q["new_state_pf"] != B.RES_OOB)
    return torch.sum(torch.where(live, q["energy_pf"],
                                 torch.zeros_like(q["energy_pf"])))


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
    canbreak = _canbreak(ba, step_fr, settings)
    energy = _live_energy(ba, q)
    ba = ba._replace(state=ba.state + step_fr, c=ba.c + step_c,
                     idepth=new_id, idepth_zero=new_id,
                     res_state=q["new_state_pf"])
    return ba, canbreak, energy


def _fej_reset_newest(ba: B.BAState):
    """Move the newest frame's FEJ point to its current pose (the affine
    stays in state_zero). Returns (ba, newest slot)."""
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
    return ba._replace(T_cw_eval=new_eval, state=new_state,
                       state_zero=new_zero), newest


def _final_linearization(ba: B.BAState, dI, settings: Settings, w: int,
                         h: int, n_its: int):
    """The linearization after the GN loop: it drops OOB/outlier residuals
    for good and gives the stats. Returns (ba, stats dict)."""
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
    return ba, dict(energy=energy_final, rmse=rmse, n_its=n_its,
                    n_active=n_active, is_lost=~torch.isfinite(energy_final),
                    HdiF=q["HdiF"])


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
    ba, _ = _fej_reset_newest(ba)
    return _final_linearization(ba, dI, settings, w, h, it)


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


# ----------------------------------------------------------------------
# visual-inertial mode (the imu_valid branches of solveSystemF and
# marginalizeFrame; EnergyFunctional.cpp:730-1184)
# ----------------------------------------------------------------------

def gn_step_vio(ba: B.BAState, imu: IM.ImuState, dI, settings: Settings,
                w: int, h: int, ev: B.PrecalcEval | None = None):
    """One VIO GN iteration: vision linearization (K3) + IMU Hessian + KKT
    solve. Returns (ba, imu, canbreak, energy)."""
    pre = B.make_precalc(ba, ev)
    q = _iter_quants(ba, pre, dI, settings, w, h)
    ba = ba._replace(energy_th=BP.update_energy_th_t(ba, q["fo"], settings))

    H_top, b_top = B.add_priors(ba, q["Htop"], q["btop"], settings)
    x8, x_scale, x_imu = IM.solve_vio(ba, imu, H_top, b_top, q["Hsc"],
                                      q["bsc"], imu.HM, imu.bM, settings)
    x8 = torch.where(torch.isfinite(x8), x8, torch.zeros_like(x8))
    x_imu = torch.where(torch.isfinite(x_imu), x_imu, torch.zeros_like(x_imu))
    x_scale = torch.where(torch.isfinite(x_scale), x_scale,
                          torch.zeros_like(x_scale))

    fv = ba.frame_valid[:, None].to(torch.float32)
    step_fr = -x8[CPARS:].reshape(ba.F, 8) * fv
    step_pt = q["resub"](x8) * ba.pt_valid
    step_pt = torch.where(torch.isfinite(step_pt), step_pt,
                          torch.zeros_like(step_pt))

    new_imu_state = imu.state - x_imu * imu.bias_valid[:, None]
    new_scale = imu.scale - (0.0 if settings.enable_scale_opt else x_scale)
    canbreak = _canbreak(ba, step_fr, settings)
    energy = _live_energy(ba, q)
    new_id = ba.idepth + step_pt
    ba = ba._replace(state=ba.state + step_fr, c=ba.c - x8[:CPARS],
                     idepth=new_id, idepth_zero=new_id,
                     res_state=q["new_state_pf"])
    imu = imu._replace(state=new_imu_state, scale=new_scale)
    return ba, imu, canbreak, energy


def optimize_vio(ba: B.BAState, imu: IM.ImuState, dI, settings: Settings,
                 w: int, h: int, max_its: int = 6, min_its: int = 1):
    """FullSystem::optimize with the IMU initialized: the VIO KKT solve per
    step, then the newest frame's FEJ reset, its velocity update and the
    final linearization. Returns (ba, imu, stats dict)."""
    ba = ba._replace(res_state=torch.where(
        ba.res_exist, torch.full_like(ba.res_state, B.RES_IN), ba.res_state))
    ev = B.make_precalc_eval(ba)
    it = 0
    canbreak = False
    while it < max_its and not (canbreak and it >= min_its):
        ba, imu, cb, _ = gn_step_vio(ba, imu, dI, settings, w, h, ev=ev)
        canbreak = bool(cb)
        it += 1
    ba, newest = _fej_reset_newest(ba)

    # updateVel(newest) from the second-newest window frame
    prev = max(newest - 1, 0)
    t = imu.timestamps[prev] - imu.timestamps[newest]
    T_cw2 = B.state_to_pose(ba.T_cw_eval, ba.state)
    tsl_diff = T_cw2[prev, :3, 3] - T_cw2[newest, :3, 3]
    sq = (imu.state[newest] * IM._s21(imu.state))[9:12]
    vel_new = tsl_diff / torch.where(torch.abs(t) < 1e-6,
                                     torch.full_like(t, -1e-6), t) \
        - t * sq - t * t * sq
    vel = imu.vel.clone()
    vel[newest] = torch.where(imu.scale_trapped, vel_new, imu.vel[newest])
    state_zero = imu.state_zero.clone()
    state_zero[newest] = imu.state[newest]
    imu = imu._replace(vel=vel, state_zero=state_zero)
    ba, stats = _final_linearization(ba, dI, settings, w, h, it)
    return ba, imu, stats


def marginalize_frame_vio(ba: B.BAState, imu: IM.ImuState, k: int,
                          settings: Settings, jax_form: bool = False):
    """VIO-mode frame marginalization (EnergyFunctional::marginalizeFrame,
    IMU branch): fold the dying frame's IMU links into HM, Schur out its
    29-dim block, compact both states. Returns (ba, imu).

    A dim of the dying block that carries no information (its row is
    zero: the 15 spline dims, which are zeroed when the slot's spline is
    not valid, or the translation of a frame no marginalized point
    constrains) is folded out without it: a 1 on its diagonal of the
    inverted block keeps the block regular, and its zero couplings keep
    it out of the fold. `jax_form=True` inverts the block as the JAX
    package does, singular with such dims, which leaves the whole prior
    NaN (for the parity tests only)."""
    F = ba.F
    D = IM.vio_dim(F)
    dev = ba.state.device
    n = int(torch.sum(ba.frame_valid))
    fr = torch.arange(F, device=dev)

    # --- IMU connection terms of the pairs (k-1, k) and (k, k+1) ---
    imu_m = imu._replace(
        bias_valid=imu.bias_valid & (fr >= k - 1) & (fr <= k + 1),
        spline_valid=imu.spline_valid & ((fr == k) | (fr == k + 1)))
    HM_change, bM_change, _, _, _ = IM.imu_hessian(ba, imu_m, settings)
    # delta2: the neighbours' deltas only (slot k stays zero)
    dims = torch.arange(D, device=dev)
    dim_frame = torch.div(dims - (CPARS + 1), 29, rounding_mode="floor")
    keep_delta = (dim_frame != k) | (dims < CPARS + 1)
    delta = IM.get_vio_delta(ba, imu) * keep_delta
    bM_change = bM_change - HM_change @ delta
    HM = imu.HM + settings.marg_weight_fac * HM_change
    bM = imu.bM + settings.marg_weight_fac * bM_change

    # --- add the dying frame's dso prior ---
    didx = CPARS + 1 + 29 * k + torch.arange(8, device=dev)
    HM[didx, didx] += ba.prior[k]
    bM[didx] += ba.prior[k] * ba.state[k]

    # --- discard the unconstrained spline dims of the dying frame ---
    spline_dead = not (k > 0 and bool(imu.spline_valid[k]))
    dim_in_frame = torch.remainder(dims - (CPARS + 1), 29)
    dead = (dim_frame == k) & (dim_in_frame >= 14) & spline_dead
    keepm = (~dead).to(torch.float32)
    HM = HM * keepm[:, None] * keepm[None, :]
    bM = bM * keepm

    # --- move frame k's 29-block to the last valid block, Schur it out ---
    order = [b for b in range(F) if b != k and b < n] + [k] \
        + list(range(n, F))
    order_t = torch.tensor(order, device=dev)
    perm = torch.cat([torch.arange(CPARS + 1, device=dev),
                      (CPARS + 1 + 29 * order_t[:, None]
                       + torch.arange(29, device=dev)[None, :]).reshape(-1)])
    HMp = HM[perm][:, perm]
    bMp = bM[perm]
    sl = CPARS + 1 + 29 * (n - 1)
    in_marg = (dims >= sl) & (dims < sl + 29)
    svec = torch.sqrt(torch.abs(torch.diagonal(HMp)) + 10.0)
    svec_i = 1.0 / svec
    Hs = HMp * svec_i[:, None] * svec_i[None, :]
    bs = bMp * svec_i
    Hmm = Hs[sl:sl + 29, sl:sl + 29]
    Hmm = 0.5 * (Hmm + Hmm.T)
    if not jax_form:
        uninformed = torch.diag((Hs[sl:sl + 29] == 0).all(1))
        Hmm = torch.where(uninformed, torch.ones_like(Hmm), Hmm)
    Hmm_inv = inv(Hmm)
    Hmm_inv = 0.5 * (Hmm_inv + Hmm_inv.T)
    keep = (~in_marg).to(torch.float32)
    Hxm = Hs[:, sl:sl + 29] * keep[:, None]
    bli = Hxm @ Hmm_inv
    Hs_new = (Hs - bli @ Hxm.T) * keep[:, None] * keep[None, :]
    bs_new = (bs - bli @ bs[sl:sl + 29]) * keep
    HM2 = Hs_new * svec[:, None] * svec[None, :]
    HM2 = 0.5 * (HM2 + HM2.T)
    bM2 = bs_new * svec

    # --- compact the imu frame arrays ---
    fv_new = ba.frame_valid[order_t] & (fr != n - 1)
    fvf = fv_new[:, None].to(torch.float32)
    spline_valid = imu.spline_valid[order_t] & fv_new
    # the frame now following slot k-1 lost its spline predecessor
    spline_valid[min(max(k, 0), F - 1)] = False
    imu = imu._replace(
        state=imu.state[order_t] * fvf,
        state_zero=imu.state_zero[order_t] * fvf,
        vel=imu.vel[order_t], timestamps=imu.timestamps[order_t],
        bias_valid=imu.bias_valid[order_t] & fv_new,
        spline_valid=spline_valid,
        acc=imu.acc[order_t], gyro=imu.gyro[order_t], ts=imu.ts[order_t],
        imu_valid=imu.imu_valid[order_t] & fv_new[:, None],
        HM=HM2, bM=bM2)
    prior = ba.prior.clone()
    prior[k] = 0.0
    return marginalize_frame(ba._replace(prior=prior), k), imu


def marginalize_points_vio(ba: B.BAState, imu: IM.ImuState, dI, marg,
                           settings: Settings, w: int, h: int):
    """Point marginalization in VIO mode: the vision H (K3, use_rz) goes
    into the expanded (5+29F) HM (marginalizePointsF + expandHbtoFitImu).
    Returns (ba, imu)."""
    marg = marg & ba.pt_valid
    pre = B.make_precalc(ba)
    H, b, H_sc, b_sc = _marg_Hb(ba, pre, dI, marg, settings, w, h)
    He, be = IM.expand_vision_Hb(H - H_sc, b - b_sc, ba.F)
    HM = imu.HM + settings.marg_weight_fac * He
    HM = 0.5 * (HM + HM.T)
    bM = imu.bM + settings.marg_weight_fac * be
    imu = imu._replace(HM=HM, bM=bM)
    ba = ba._replace(pt_valid=ba.pt_valid & ~marg,
                     res_exist=ba.res_exist & ~marg[:, None])
    return ba, imu
