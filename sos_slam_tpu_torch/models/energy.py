"""Sliding-window bundle adjustment driver + marginalization (port of
sos_slam_tpu/models/energy.py; reference FullSystem::optimize,
FullSystemOptimize.cpp:305-489, and EnergyFunctional::{marginalizeFrame,
marginalizePointsF}, EnergyFunctional.cpp:730-936).

Up to `max_opt_iterations` Gauss-Newton steps at fixed damping 1e-5, steps
always accepted, early break on small step norms; afterwards the newest
frame's FEJ point moves to its current pose and a final linearization
drops OOB/outlier residuals. Every linearization goes through kernel K3
(ops/ba_p.py:fused_iteration) at the `_iter_quants` and `_marg_Hb` seams.
`optimize` reads its loop condition on the host; `optimize(bounded=True)`
reads nothing back: its loop is an `ops/control.py` `while_loop` (the JAX
package's `lax.while_loop`; inside a CUDA graph's capture a WHILE node,
which leaves after the break), whose plain twin runs the step count to
its bound with the steps after the break frozen, which gives the same
bits. The visual-inertial twins
(`gn_step_vio`, `optimize_vio`, `marginalize_frame_vio`,
`marginalize_points_vio`) solve the (5+29F)-dim KKT system of
models/imu.py around the same K3 linearizations.
"""

from __future__ import annotations

import torch

from sos_slam_tpu_torch.models import imu as IM
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import ba_p as BP
from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops.numerics import at, inv, live_pinv
from sos_slam_tpu_torch.parallel import comm
from sos_slam_tpu_torch.utils import lie
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


def _canbreak(ba: B.BAState, step_fr, settings: Settings, sums: dict):
    """The early-break test on a GN step's frame increments and the point
    depths (FullSystem::optimize's canbreak), a device bool; the point
    counts come from `_point_sums`."""
    nvalid = torch.clamp(torch.sum(ba.frame_valid), min=1)
    sumA = torch.sum(step_fr[:, 6] ** 2) / nvalid
    sumB = torch.sum(step_fr[:, 7] ** 2) / nvalid
    sumT = torch.sum(step_fr[:, 0:3] ** 2) / nvalid
    sumR = torch.sum(step_fr[:, 3:6] ** 2) / nvalid
    npt = torch.clamp(sums["npt"], min=1)
    sumNID = sums["sum_abs_idepth"] / npt
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


# the cross-point sums of a GN step that `_stitch` adds over the ranks
_STITCHED = ("Htop", "btop", "Hsc", "bsc", "n_active")
_SUMS = ("energy", "npt", "sum_abs_idepth")


def _point_sums(ba: B.BAState, q: dict) -> dict:
    """The step's sums over the points that the solve does not change: its
    live energy, and the point count and |idepth| sum of the early-break
    test."""
    return dict(energy=_live_energy(ba, q), npt=torch.sum(ba.pt_valid),
                sum_abs_idepth=torch.sum(torch.abs(ba.idepth) * ba.pt_valid))


def _stitch(q: dict, sums: dict, group):
    """The point-sharded step's stitch: K3's H_top, b_top, H_sc, b_sc,
    the active count and the `_point_sums`, each added over the ranks of
    `group` in one all_reduce. With no group, (q, sums) unchanged."""
    if group is None:
        return q, sums
    out = comm.psum([q[k] for k in _STITCHED] + [sums[k] for k in _SUMS],
                    group)
    q = dict(q, **dict(zip(_STITCHED, out)))
    return q, dict(zip(_SUMS, out[len(_STITCHED):]))


def gn_step(ba: B.BAState, dI, settings: Settings, w: int, h: int,
            ev: B.PrecalcEval | None = None, group=None):
    """One damped GN iteration. Returns (new ba, canbreak, energy).

    With a process `group`, `ba` holds this rank's rows of the point axis
    (parallel/sharded.py): the cross-point sums are added over the ranks
    (`_stitch`), the newest frame's energy threshold is taken over every
    rank's points, the priors and the marginalization prior are added
    once to the stitched system, the solve runs replicated (and must give
    the same x on every rank), and the point updates stay local."""
    pre = B.make_precalc(ba, ev)
    q = _iter_quants(ba, pre, dI, settings, w, h)
    q, sums = _stitch(q, _point_sums(ba, q), group)
    ba = ba._replace(energy_th=BP.update_energy_th_t(ba, q["fo"], settings,
                                                     group))
    H_top, b_top = B.add_priors(ba, q["Htop"], q["btop"], settings)
    x = B.solve_system(ba, H_top, b_top, q["Hsc"], q["bsc"])
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    comm.assert_replicated(x, group, "the GN step's solution x")
    fv = ba.frame_valid[:, None].to(torch.float32)
    step_fr = -x[CPARS:].reshape(ba.F, 8) * fv
    step_c = -x[:CPARS]
    step_pt = q["resub"](x) * ba.pt_valid
    step_pt = torch.where(torch.isfinite(step_pt), step_pt,
                          torch.zeros_like(step_pt))
    new_id = ba.idepth + step_pt
    canbreak = _canbreak(ba, step_fr, settings, sums)
    energy = sums["energy"]
    ba = ba._replace(state=ba.state + step_fr, c=ba.c + step_c,
                     idepth=new_id, idepth_zero=new_id,
                     res_state=q["new_state_pf"])
    return ba, canbreak, energy


def _fej_reset_newest(ba: B.BAState):
    """Move the newest frame's FEJ point to its current pose (the affine
    stays in state_zero), with the newest slot read nothing back."""
    F = ba.F
    dev = ba.state.device
    newest = B.newest_slot(ba.frame_valid)
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    sel = (torch.arange(F, device=dev) == newest)[:, None]
    pose_dims = (torch.arange(8, device=dev) < 6)[None, :]
    zero_pose = torch.where(pose_dims, torch.zeros_like(ba.state), ba.state)
    return ba._replace(
        T_cw_eval=torch.where(sel[..., None], T_cw, ba.T_cw_eval),
        state=torch.where(sel, zero_pose, ba.state),
        state_zero=torch.where(sel, zero_pose, ba.state_zero))


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


# the bootstrap's GN budgets (`_kf_chain_jit`'s ladder: 20 while the
# window holds fewer than 3 keyframes, 15 at 3)
BOOT_ITS = (20, 15)


def _loop_bound(max_its, settings: Settings, it, done):
    """The bounded GN loop's trip cap and its go test: for a host int
    `max_its`, that many trips while `done` is unset; for a device
    `max_its` (the budget chained on the device), the largest budget the
    ladder gives, while `done` is unset and `it < max_its` (the JAX
    `while_loop`'s bound)."""
    if not torch.is_tensor(max_its):
        return max_its, lambda: ~done
    return max(BOOT_ITS + (settings.max_opt_iterations,)), \
        lambda: ~done & (it < max_its)


def optimize(ba: B.BAState, dI, settings: Settings, w: int, h: int,
             max_its: int = 6, min_its: int = 1, bounded: bool = False):
    """The windowed BA (FullSystem::optimize). Returns (ba, stats dict).

    The loop leaves early on the break test, read on the host after each
    step. `bounded=True` reads nothing back: the loop is a
    `control.while_loop` of at most `max_its` steps (a host int, or a
    device int under the ladder's largest cap, `_loop_bound`) while a
    device `done` is unset (set once the break test holds with `min_its` steps made),
    each step updating the state in place and keeping every field as it
    was once `done` is set (`torch.where`), counting the steps made on the
    device (stats' `n_its`, a 0-dim tensor). Both forms give the same
    bits."""
    ba = ba._replace(res_state=torch.where(
        ba.res_exist, torch.full_like(ba.res_state, B.RES_IN), ba.res_state))
    ev = B.make_precalc_eval(ba)
    if bounded:
        dev = ba.state.device
        ba = control.clone(ba)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        cap, more = _loop_bound(max_its, settings, it, done)

        def step():
            new, cb, _ = gn_step(ba, dI, settings, w, h, ev=ev)
            live = more()
            control.copy_into(ba, _freeze(live, new, ba))
            it.copy_(it + live.to(torch.int32))
            done.copy_(done | (live & cb & (it >= min_its)))

        control.while_loop(more, step, cap)
    else:
        it = 0
        canbreak = False
        while it < max_its and not (canbreak and it >= min_its):
            ba, cb, _ = gn_step(ba, dI, settings, w, h, ev=ev)
            canbreak = bool(cb)
            it += 1
    ba = _fej_reset_newest(ba)
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


# ----------------------------------------------------------------------
# gauge null spaces (FullSystem::getNullspaces, FullSystemOptimize.cpp:
# 528-576; per-frame parts FrameHessian::setStateZero, HessianBlocks.cpp:
# 66-102) and the EnergyFunctional::orthogonalize projection
# (EnergyFunctional.cpp:971-1027). As in the reference, the solver does
# not apply the projection by default; both are here for parity and
# diagnostics.
# ----------------------------------------------------------------------

def frame_nullspaces(T_cw_eval, exposure, aff_a0):
    """Per-frame gauge null-space directions at the FEJ pose, batched over
    leading dims: the central-difference derivative of the left-increment
    coordinates under a global gauge change (HessianBlocks.cpp:70-101).
    Returns (pose (…,6,6) column i = direction i, scale (…,6), affine
    (…,2,2) columns [A, B])."""
    eps = 1e-3
    T = T_cw_eval
    Ti = lie.se3_inv(T)
    basis = torch.eye(6, dtype=T.dtype, device=T.device) * eps
    Tb, Tib = T[..., None, :, :], Ti[..., None, :, :]
    logP = lie.se3_log(Tb @ lie.se3_exp(basis) @ Tib)
    logM = lie.se3_log(Tb @ lie.se3_exp(-basis) @ Tib)
    ns_pose = ((logP - logM) / (2.0 * eps)).transpose(-1, -2)
    Tp, Tm = T.clone(), T.clone()
    Tp[..., :3, 3] = T[..., :3, 3] * 1.00001
    Tm[..., :3, 3] = T[..., :3, 3] / 1.00001
    ns_scale = (lie.se3_log(Tp @ Ti) - lie.se3_log(Tm @ Ti)) / (2.0 * eps)
    col = torch.stack([torch.ones_like(exposure),
                       torch.exp(aff_a0) * exposure], -1)
    ns_aff = torch.eye(2, dtype=T.dtype, device=T.device) * col[..., None, :]
    return ns_pose, ns_scale, ns_aff


def get_nullspaces(ba: B.BAState) -> torch.Tensor:
    """Window-wide null-space vectors in internal (scaled) state units.

    Returns (9, 4+8F): rows 0-5 global pose gauge, 6-7 affine A/B gauge,
    8 global scale gauge, in the order of the reference's
    nullspaces_x0_pre (FullSystemOptimize.cpp:537-575), with the
    SCALE_*_INVERSE factors folded in. Entries of invalid frame slots are
    zero."""
    F = ba.F
    dev = ba.state.device
    a0 = B.aff_real(ba.state_zero)[:, 0]
    ns_pose, ns_scale, ns_aff = frame_nullspaces(ba.T_cw_eval, ba.exposure,
                                                 a0)
    fv = ba.frame_valid.to(torch.float32)
    inv_s = 1.0 / B.state8_scale(dev)
    zc = torch.zeros(CPARS, dtype=torch.float32, device=dev)

    def row(cols, part):
        blk = torch.zeros((F, 8), dtype=torch.float32, device=dev)
        blk[:, cols] = part
        blk = blk * inv_s[None, :] * fv[:, None]
        return torch.cat([zc, blk.reshape(-1)])

    rows = [row(slice(0, 6), ns_pose[:, :, i]) for i in range(6)]
    rows += [row(slice(6, 8), ns_aff[:, :, i]) for i in range(2)]
    rows.append(row(slice(0, 6), ns_scale))
    return torch.stack(rows)


def orthogonalize(b, H, nullspaces, delta: float = 1e-5):
    """Project (b, H) onto the complement of the gauge null spaces
    (EnergyFunctional::orthogonalize, EnergyFunctional.cpp:971-1027).

    nullspaces: (K, D) rows; like the reference, callers pass the pose (6)
    and scale (1) rows. delta mirrors setting_solverModeDelta."""
    norms = torch.linalg.vector_norm(nullspaces, dim=1, keepdim=True)
    N = (nullspaces / torch.clamp(norms, min=1e-12)).T
    U, S, Vt = torch.linalg.svd(N, full_matrices=False)
    keep = S > delta * torch.max(S)
    S_inv = torch.where(keep, 1.0 / torch.clamp(S, min=1e-30),
                        torch.zeros_like(S))
    Npi = (U * S_inv[None, :]) @ Vt
    NNpiT = N @ Npi.T
    NNpiTS = 0.5 * (NNpiT + NNpiT.T)
    return b - NNpiTS @ b, H - NNpiTS @ H @ NNpiTS


def marginalize_frame(ba: B.BAState, k) -> B.BAState:
    """Schur-marginalize frame slot k out of HM/bM and compact the window
    (EnergyFunctional::marginalizeFrame). Requires no remaining points
    hosted in k and no residuals targeting k. `k`: an int or a 0-dim int
    tensor on the window's device; nothing is read back (the window count,
    the block order and the dying block's dims stay on the device)."""
    F = ba.F
    D = CPARS + 8 * F
    dev = ba.HM.device
    if not torch.is_tensor(k):
        k = torch.tensor(k, device=dev)
    k = k.reshape(())
    n = torch.sum(ba.frame_valid)
    ar8 = torch.arange(8, device=dev)
    didx = CPARS + 8 * k + ar8
    prior_k, state_k = at(ba.prior, k), at(ba.state, k)
    HM = ba.HM.clone()
    bM = ba.bM.clone()
    HM[didx, didx] += prior_k
    bM[didx] += prior_k * state_k

    # new block order [0..k-1, k+1..n-1, k, n..F-1]: old slot per new slot
    blk = torch.arange(F, device=dev)
    shifted = torch.where((blk >= k) & (blk < n - 1), blk + 1, blk)
    order_t = torch.where(blk == n - 1, k, shifted)
    perm = torch.cat([torch.arange(CPARS, device=dev),
                      (CPARS + 8 * order_t[:, None] + ar8[None, :])
                      .reshape(-1)])
    HMp = HM[perm][:, perm]
    bMp = bM[perm]
    sl = CPARS + 8 * (n - 1)
    gidx = sl + ar8
    dim_idx = torch.arange(D, device=dev)
    in_marg = (dim_idx >= sl) & (dim_idx < sl + 8)
    svec = torch.sqrt(torch.abs(torch.diagonal(HMp)) + 10.0)
    svec_i = 1.0 / svec
    Hs = HMp * svec_i[:, None] * svec_i[None, :]
    bs = bMp * svec_i
    Hmm = Hs[gidx][:, gidx]
    Hmm = 0.5 * (Hmm + Hmm.T)
    Hmm_inv = inv(Hmm)
    Hmm_inv = 0.5 * (Hmm_inv + Hmm_inv.T)
    keep = (~in_marg).to(torch.float32)
    Hxm = Hs[:, gidx] * keep[:, None]
    bli = Hxm @ Hmm_inv
    Hs_new = (Hs - bli @ Hxm.T) * keep[:, None] * keep[None, :]
    bs_new = (bs - bli @ bs[gidx]) * keep
    HM2 = Hs_new * svec[:, None] * svec[None, :]
    HM2 = 0.5 * (HM2 + HM2.T)
    bM2 = bs_new * svec

    last = blk == (n - 1)
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
                w: int, h: int, ev: B.PrecalcEval | None = None, group=None):
    """One VIO GN iteration: vision linearization (K3) + IMU Hessian + KKT
    solve. Returns (ba, imu, canbreak, energy). With a process `group`,
    as `gn_step`: the vision blocks are stitched over the ranks, and the
    IMU Hessian and the KKT solve run replicated on them."""
    pre = B.make_precalc(ba, ev)
    q = _iter_quants(ba, pre, dI, settings, w, h)
    q, sums = _stitch(q, _point_sums(ba, q), group)
    ba = ba._replace(energy_th=BP.update_energy_th_t(ba, q["fo"], settings,
                                                     group))

    H_top, b_top = B.add_priors(ba, q["Htop"], q["btop"], settings)
    x8, x_scale, x_imu = IM.solve_vio(ba, imu, H_top, b_top, q["Hsc"],
                                      q["bsc"], imu.HM, imu.bM, settings)
    x8 = torch.where(torch.isfinite(x8), x8, torch.zeros_like(x8))
    x_imu = torch.where(torch.isfinite(x_imu), x_imu, torch.zeros_like(x_imu))
    x_scale = torch.where(torch.isfinite(x_scale), x_scale,
                          torch.zeros_like(x_scale))
    if group is not None:
        comm.assert_replicated(torch.cat([x8, x_scale[None],
                                          x_imu.reshape(-1)]), group,
                               "the VIO step's solution x")

    fv = ba.frame_valid[:, None].to(torch.float32)
    step_fr = -x8[CPARS:].reshape(ba.F, 8) * fv
    step_pt = q["resub"](x8) * ba.pt_valid
    step_pt = torch.where(torch.isfinite(step_pt), step_pt,
                          torch.zeros_like(step_pt))

    new_imu_state = imu.state - x_imu * imu.bias_valid[:, None]
    new_scale = imu.scale - (0.0 if settings.enable_scale_opt else x_scale)
    canbreak = _canbreak(ba, step_fr, settings, sums)
    energy = sums["energy"]
    new_id = ba.idepth + step_pt
    ba = ba._replace(state=ba.state + step_fr, c=ba.c - x8[:CPARS],
                     idepth=new_id, idepth_zero=new_id,
                     res_state=q["new_state_pf"])
    imu = imu._replace(state=new_imu_state, scale=new_scale)
    return ba, imu, canbreak, energy


def optimize_vio(ba: B.BAState, imu: IM.ImuState, dI, settings: Settings,
                 w: int, h: int, max_its: int = 6, min_its: int = 1,
                 bounded: bool = False):
    """FullSystem::optimize with the IMU initialized: the VIO KKT solve per
    step, then the newest frame's FEJ reset, its velocity update and the
    final linearization. Returns (ba, imu, stats dict).

    As `optimize`: the loop leaves early on the break test read on the
    host; `bounded=True` runs it as a `control.while_loop` of at most
    `max_its` steps with every field of both states frozen by
    `torch.where` once a device `done` is set, counts the steps on the
    device and reads nothing back (the JAX package's `lax.while_loop`).
    Both forms give the same bits."""
    ba = ba._replace(res_state=torch.where(
        ba.res_exist, torch.full_like(ba.res_state, B.RES_IN), ba.res_state))
    ev = B.make_precalc_eval(ba)
    if bounded:
        dev = ba.state.device
        ba, imu = control.clone(ba), control.clone(imu)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)

        cap, more = _loop_bound(max_its, settings, it, done)

        def step():
            nba, nimu, cb, _ = gn_step_vio(ba, imu, dI, settings, w, h,
                                           ev=ev)
            live = more()
            control.copy_into(ba, _freeze(live, nba, ba))
            control.copy_into(imu, _freeze(live, nimu, imu))
            it.copy_(it + live.to(torch.int32))
            done.copy_(done | (live & cb & (it >= min_its)))

        control.while_loop(more, step, cap)
    else:
        it = 0
        canbreak = False
        while it < max_its and not (canbreak and it >= min_its):
            ba, imu, cb, _ = gn_step_vio(ba, imu, dI, settings, w, h, ev=ev)
            canbreak = bool(cb)
            it += 1
    ba = _fej_reset_newest(ba)
    F = ba.F
    newest = B.newest_slot(ba.frame_valid)
    sel = (torch.arange(F, device=ba.state.device) == newest)[:, None]

    # updateVel(newest) from the second-newest window frame
    prev = torch.clamp(newest - 1, min=0)
    t = at(imu.timestamps, prev) - at(imu.timestamps, newest)
    T_cw2 = B.state_to_pose(ba.T_cw_eval, ba.state)
    tsl_diff = at(T_cw2, prev)[:3, 3] - at(T_cw2, newest)[:3, 3]
    st_new = at(imu.state, newest)
    sq = (st_new * IM._s21(imu.state))[9:12]
    vel_new = tsl_diff / torch.where(torch.abs(t) < 1e-6,
                                     torch.full_like(t, -1e-6), t) \
        - t * sq - t * t * sq
    vel_new = torch.where(imu.scale_trapped, vel_new, at(imu.vel, newest))
    imu = imu._replace(vel=torch.where(sel, vel_new, imu.vel),
                       state_zero=torch.where(sel, st_new, imu.state_zero))
    ba, stats = _final_linearization(ba, dI, settings, w, h, it)
    return ba, imu, stats


def _freeze(live, new, old):
    """`new` where the device bool `live` holds, else `old`, field by
    field of a NamedTuple state."""
    return type(old)(*(a if b is a else torch.where(live, b, a)
                       for a, b in zip(old, new)))


def marginalize_frame_vio(ba: B.BAState, imu: IM.ImuState, k,
                          settings: Settings, jax_form: bool = False):
    """VIO-mode frame marginalization (EnergyFunctional::marginalizeFrame,
    IMU branch): fold the dying frame's IMU links into HM, Schur out its
    29-dim block, compact both states. Returns (ba, imu). `k`: an int or a
    0-dim int tensor on the window's device; nothing is read back (the
    window count, the dying slot's spline, the block order and the dying
    block's dims stay on the device), as in `marginalize_frame`.

    Directions of the dying block that carry no information (the 15
    spline dims, which are zeroed when the slot's spline is not valid,
    the translation of a frame no marginalized point constrains, or any
    combination of dims at f32 rounding) are folded out without it
    (`fold_vio_block`). `jax_form=True` inverts the block as the JAX
    package does, singular with such dims, which leaves the whole prior
    NaN (for the parity tests only)."""
    F = ba.F
    D = IM.vio_dim(F)
    dev = ba.state.device
    if not torch.is_tensor(k):
        k = torch.tensor(k, device=dev)
    k = k.reshape(())
    n = torch.sum(ba.frame_valid)
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
    prior_k = at(ba.prior, k)
    HM[didx, didx] += prior_k
    bM[didx] += prior_k * at(ba.state, k)

    # --- discard the unconstrained spline dims of the dying frame ---
    spline_dead = ~((k > 0) & at(imu.spline_valid, k))
    dim_in_frame = torch.remainder(dims - (CPARS + 1), 29)
    dead = (dim_frame == k) & (dim_in_frame >= 14) & spline_dead
    keepm = (~dead).to(torch.float32)
    HM = HM * keepm[:, None] * keepm[None, :]
    bM = bM * keepm

    # --- move frame k's 29-block to the last valid block, Schur it out ---
    # new block order [0..k-1, k+1..n-1, k, n..F-1]: old slot per new slot
    shifted = torch.where((fr >= k) & (fr < n - 1), fr + 1, fr)
    order_t = torch.where(fr == n - 1, k, shifted)
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
    Hs_new, bs_new = fold_vio_block(Hs, bs, sl, in_marg, jax_form)
    HM2 = Hs_new * svec[:, None] * svec[None, :]
    HM2 = 0.5 * (HM2 + HM2.T)
    bM2 = bs_new * svec

    # --- compact the imu frame arrays ---
    fv_new = ba.frame_valid[order_t] & (fr != n - 1)
    fvf = fv_new[:, None].to(torch.float32)
    # the frame now following slot k-1 lost its spline predecessor
    spline_valid = imu.spline_valid[order_t] & fv_new \
        & (fr != torch.clamp(k, 0, F - 1))
    imu = imu._replace(
        state=imu.state[order_t] * fvf,
        state_zero=imu.state_zero[order_t] * fvf,
        vel=imu.vel[order_t], timestamps=imu.timestamps[order_t],
        bias_valid=imu.bias_valid[order_t] & fv_new,
        spline_valid=spline_valid,
        acc=imu.acc[order_t], gyro=imu.gyro[order_t], ts=imu.ts[order_t],
        imu_valid=imu.imu_valid[order_t] & fv_new[:, None],
        HM=HM2, bM=bM2)
    prior = torch.where((fr == k)[:, None], torch.zeros_like(ba.prior),
                        ba.prior)
    return marginalize_frame(ba._replace(prior=prior), k), imu


# the VIO fold keeps the eigen-directions of the scaled 29x29 block whose
# eigenvalue exceeds LIVE_CUT times the largest (the block is summed in f32:
# below ~1e-7 of the largest an eigenvalue is rounding)
LIVE_CUT = 1e-6


def fold_vio_block(Hs, bs, sl, in_marg, jax_form: bool = False):
    """The Schur fold of the scaled VIO prior (Hs, bs) over its 29 dims
    from `sl` (`in_marg`; `sl` an int or a 0-dim device int, the block
    taken by `index_select`). Returns the folded (Hs, bs), zero on the
    folded dims.

    The fold runs in float64 over the numerically live subspace of the
    block only (`numerics.live_pinv`): a direction the marginalized
    points and IMU terms do not inform (a zero row, the dead spline's,
    or a combination of dims with an eigenvalue at f32 rounding) is left
    out, where an f32 inverse of the whole block would flood the prior
    with its rounding. `jax_form=True` inverts the whole block in f32 as
    the JAX package does, which leaves the prior NaN when the block is
    singular (for the parity tests only)."""
    gi = sl + torch.arange(29, device=Hs.device)
    keep = ~in_marg
    if jax_form:
        Hmm = Hs.index_select(0, gi).index_select(1, gi)
        Hmm_inv = inv(0.5 * (Hmm + Hmm.T))
        Hmm_inv = 0.5 * (Hmm_inv + Hmm_inv.T)
        keep = keep.to(Hs.dtype)
    else:
        Hs, bs, keep = Hs.double(), bs.double(), keep.double()
        Hmm_inv = live_pinv(Hs.index_select(0, gi).index_select(1, gi),
                            LIVE_CUT)
    Hxm = Hs.index_select(1, gi) * keep[:, None]
    bli = Hxm @ Hmm_inv
    Hs_new = (Hs - bli @ Hxm.T) * keep[:, None] * keep[None, :]
    bs_new = (bs - bli @ bs.index_select(0, gi)) * keep
    return Hs_new.float(), bs_new.float()


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
