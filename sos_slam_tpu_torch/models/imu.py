"""Continuous-time cubic-spline visual-inertial fusion (port of
sos_slam_tpu/models/imu.py; reference HessianBlocks.{h,cpp} and
EnergyFunctional.cpp:256-494).

  * a 21-dim per-keyframe IMU state [ba(3), bg(3), l_rot(3), q(6), c(6)]
    with spline evaluators for predicted acc / gyro / relative rotation;
  * per-sample IMU residual Jacobians (getImuHi, HessianBlocks.cpp:178-223);
  * closed-form initialization from 5 keyframe poses (initializeImu);
  * per-keyframe spline propagation from raw IMU (propagateImuState);
  * the BA-side IMU Hessian: bias random walk, spline rotation / velocity
    constraints (KKT rows), per-sample dynamics terms with FEJ
    (getImuHessian), batched over frames and samples with masks;
  * the global metric scale with trapping (CalibHessian::tryTrapScale).

State layout inside the (5 + 29F)-dim VIO system: [c(4), scale(1)] +
per-frame [dso(8), ba(3), bg(3), l_rot(3), q_t(3), q_r(3), c_t(3), c_r(3)].
All states in DSO internal units (scales below). Every matmul is full f32
(the package keeps TF32 off).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops.numerics import at, solve
from sos_slam_tpu_torch.utils import lie
from sos_slam_tpu_torch.utils.config import CPARS, Settings

# internal-unit scales (HessianBlocks.h:71-89)
SCALE_SCALE = 200.0
IMU_SCALE21 = np.array([100.0] * 3      # ba
                       + [1.0] * 3      # bg
                       + [100.0] * 3    # l_rot
                       + [1000.0] * 6   # q (trans, rot)
                       + [1000.0] * 6,  # c (trans, rot)
                       np.float32)

N_IMU = 128          # padded IMU samples per keyframe interval


class ImuState(NamedTuple):
    """Per-window IMU data + states (fixed shapes, slot-aligned with BAState)."""

    state: torch.Tensor        # (F,21) internal units
    state_zero: torch.Tensor   # (F,21) FEJ zero
    vel: torch.Tensor          # (F,3) velInWorld per KF
    bias_valid: torch.Tensor   # (F,) frames with imu states
    spline_valid: torch.Tensor  # (F,) spline usable between (i-1, i)
    timestamps: torch.Tensor   # (F,)
    acc: torch.Tensor          # (F,N_IMU,3) raw accelerometer
    gyro: torch.Tensor         # (F,N_IMU,3)
    ts: torch.Tensor           # (F,N_IMU) sample time minus frame time (<=0)
    imu_valid: torch.Tensor    # (F,N_IMU)
    # scale state (CalibHessian)
    scale: torch.Tensor        # () internal (real = *SCALE_SCALE)
    scale_zero: torch.Tensor
    scale_trapped: torch.Tensor  # () bool
    scale_queue: torch.Tensor    # (10,)
    queue_i: torch.Tensor        # () int32
    # VIO-mode marginalization prior at full (5+29F) dim
    HM: torch.Tensor
    bM: torch.Tensor


def empty_imu(F: int, device, scale_scaled: float = 1.0) -> ImuState:
    D = vio_dim(F)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    s0 = torch.tensor(np.float32(scale_scaled / SCALE_SCALE), device=device)
    return ImuState(
        state=z(F, 21), state_zero=z(F, 21), vel=z(F, 3),
        bias_valid=z(F, dtype=torch.bool), spline_valid=z(F, dtype=torch.bool),
        timestamps=z(F), acc=z(F, N_IMU, 3), gyro=z(F, N_IMU, 3),
        ts=z(F, N_IMU), imu_valid=z(F, N_IMU, dtype=torch.bool),
        scale=s0, scale_zero=s0.clone(),
        scale_trapped=z(dtype=torch.bool), scale_queue=z(10),
        queue_i=z(dtype=torch.int32), HM=z(D, D), bM=z(D))


@functools.lru_cache(maxsize=None)
def _const(values: tuple, shape: tuple, device: torch.device) -> torch.Tensor:
    """A constant f32 tensor, uploaded once per device."""
    return torch.tensor(np.asarray(values, np.float32).reshape(shape),
                        device=device)


def _s21(like: torch.Tensor) -> torch.Tensor:
    return _const(tuple(IMU_SCALE21.tolist()), (21,), like.device)


def _consts(settings: Settings, device):
    """(rot_imu_cam (3,3), gravity (3,)) on `device`."""
    dev = torch.device(device)
    return (_const(tuple(settings.rot_imu_cam), (3, 3), dev),
            _const(tuple(settings.gravity), (3,), dev))


# ---------------------------------------------------------------------------
# spline evaluators (scaled/real units; state internal)
# ---------------------------------------------------------------------------

def _scaled(state21):
    return state21 * _s21(state21)


def spline_acc(state21, t):
    """World-frame translational acceleration (…, 3); t (…)."""
    s = _scaled(state21)
    return 2.0 * s[..., 9:12] + 6.0 * t[..., None] * s[..., 15:18]


def spline_gyro(state21, t):
    s = _scaled(state21)
    return (s[..., 6:9] + 2.0 * t[..., None] * s[..., 12:15]
            + 3.0 * (t * t)[..., None] * s[..., 18:21])


def spline_rot_c_t(state21, t):
    """R_{cam@frame <- cam@t}: (…,3,3)."""
    s = _scaled(state21)
    t2 = t * t
    so3 = (t[..., None] * s[..., 6:9] + t2[..., None] * s[..., 12:15]
           + (t * t2)[..., None] * s[..., 18:21])
    return lie.so3_exp(so3)


def spline_t_c2t(state21, vel, t):
    """Translation of cam@t relative to cam@frame in world (…,3)."""
    s = _scaled(state21)
    t2 = t * t
    return (t[..., None] * vel + t2[..., None] * s[..., 9:12]
            + (t * t2)[..., None] * s[..., 15:18])


def ordered_rotations(R0: torch.Tensor, w: torch.Tensor, dt: torch.Tensor):
    """R_k = R_{k-1} @ so3_exp(w_k dt_k) from R_0 = R0, multiplied in sample
    order as the JAX package's scan does (the exponentials are one batched
    call). w (N,3), dt (N,). Returns (N,3,3): the rotation after each
    sample."""
    E = lie.so3_exp(w * dt[:, None])
    out = []
    R = R0
    for k in range(E.shape[0]):
        R = R @ E[k]
        out.append(R)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# the IMU Hessian (vision-window side)
# ---------------------------------------------------------------------------

def vio_dim(F: int) -> int:
    return CPARS + 1 + 29 * F


def _idx8(F: int, device) -> torch.Tensor:
    return torch.cat([torch.arange(CPARS, device=device),
                      (CPARS + 1 + 29 * torch.arange(F, device=device)[:, None]
                       + torch.arange(8, device=device)[None, :]).reshape(-1)])


def expand_vision_Hb(H8: torch.Tensor, b8: torch.Tensor, F: int):
    """Scatter the (4+8F) vision system into the (5+29F) VIO layout
    (expandHbtoFitImu, EnergyFunctional.cpp:256-286)."""
    D = vio_dim(F)
    idx = _idx8(F, H8.device)
    H = torch.zeros((D, D), dtype=H8.dtype, device=H8.device)
    H[idx[:, None], idx[None, :]] = H8
    b = torch.zeros((D,), dtype=b8.dtype, device=b8.device)
    b[idx] = b8
    return H, b


def _frame_block(i):
    return CPARS + 1 + 29 * i


def imu_sample_jacobians(ba: B.BAState, imu: ImuState, settings: Settings,
                         rot_imu_cam, gravity, weight_imu):
    """Per-(frame, sample) residuals + FEJ Jacobians (getImuHi batched).

    Returns (r (F,N,6), Js (F,N,6), Jf (F,N,6,29), valid (F,N)). Jacobian
    state: state_imu_zero + camToWorld_evalPT + scale_zero when trapped,
    current otherwise (the reference's split)."""
    F = ba.F
    dev = ba.state.device
    tt = imu.ts                                   # (F,N) <= 0
    trapped = imu.scale_trapped

    st_cur = imu.state
    st_jac = torch.where(trapped, imu.state_zero, imu.state)
    s_cur = imu.scale * SCALE_SCALE
    s_jac = torch.where(trapped, imu.scale_zero, imu.scale) * SCALE_SCALE

    # residual at the CURRENT state
    R_ct = spline_rot_c_t(st_cur[:, None, :], tt)        # (F,N,3,3)
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    R_wc = T_cw[:, :3, :3].transpose(-1, -2)             # worldToCam current
    acc_w = s_cur * spline_acc(st_cur[:, None, :], tt) + gravity
    rot_t_w = torch.einsum("fnji,fjk->fnik", R_ct, R_wc)
    acc_pred = torch.einsum("ij,fnjk,fnk->fni", rot_imu_cam, rot_t_w, acc_w)
    gyro_pred = torch.einsum("ij,fnj->fni", rot_imu_cam,
                             spline_gyro(st_cur[:, None, :], tt))
    bias = _scaled(st_cur)[:, :6]
    r = torch.cat([acc_pred, gyro_pred], -1) + bias[:, None, :] \
        - torch.cat([imu.acc, imu.gyro], -1)             # (F,N,6)

    # Jacobians at the FEJ state
    R_ct0 = spline_rot_c_t(st_jac[:, None, :], tt)
    R_wc0 = ba.T_cw_eval[:, :3, :3].transpose(-1, -2)
    acc_w0 = s_jac * spline_acc(st_jac[:, None, :], tt) + gravity
    rot_t_w0 = torch.einsum("fnji,fjk->fnik", R_ct0, R_wc0)
    rot_i_w = torch.einsum("ij,fnjk->fnik", rot_imu_cam, rot_t_w0)
    Racc = torch.einsum("fnij,fnj->fni", rot_t_w0, acc_w0)
    R_acc_hat = torch.einsum("ij,fnjk->fnik", rot_imu_cam, lie.so3_hat(Racc))

    N = tt.shape[1]
    Jf = torch.zeros((F, N, 6, 29), device=dev)
    I3 = torch.eye(3, device=dev)
    tt1 = tt[..., None, None]
    # acc rows (0:3)
    acc_rot_dso = torch.einsum("fnij,fnjk->fnik", rot_i_w,
                               lie.so3_hat(acc_w0))      # d acc / d dso-rot
    Jf[..., 0:3, 3:6] = torch.where(trapped, B.SCALE_XI_ROT * acc_rot_dso,
                                    torch.zeros_like(acc_rot_dso))
    Jf[..., 0:3, 8:11] = 100.0 * I3                                 # ba
    Jf[..., 0:3, 14:17] = 100.0 * R_acc_hat * tt1                   # l_rot
    Jf[..., 0:3, 20:23] = 1000.0 * R_acc_hat * tt1 ** 2
    Jf[..., 0:3, 26:29] = 1000.0 * R_acc_hat * tt1 ** 3
    Jf[..., 0:3, 17:20] = 1000.0 * rot_i_w * 2.0 * s_jac            # q_trans
    Jf[..., 0:3, 23:26] = 1000.0 * rot_i_w * 6.0 * tt1 * s_jac      # c_trans
    # gyro rows (3:6)
    Jf[..., 3:6, 11:14] = 1.0 * I3                                  # bg
    Jf[..., 3:6, 14:17] = 100.0 * rot_imu_cam
    Jf[..., 3:6, 20:23] = 1000.0 * rot_imu_cam * 2.0 * tt1
    Jf[..., 3:6, 26:29] = 1000.0 * rot_imu_cam * 3.0 * tt1 ** 2

    Js = torch.zeros((F, N, 6), device=dev)
    Js[..., 0:3] = SCALE_SCALE * torch.einsum(
        "fnij,fnj->fni", rot_i_w, spline_acc(st_jac[:, None, :], tt))
    valid = imu.imu_valid & imu.spline_valid[:, None] \
        & ba.frame_valid[:, None]
    return r, Js, Jf, valid


def imu_hessian(ba: B.BAState, imu: ImuState, settings: Settings):
    """H, b, J_cst, r_cst, cst_valid for the (5+29F)-dim VIO system
    (getImuHessian, EnergyFunctional.cpp:457-494)."""
    F = ba.F
    D = vio_dim(F)
    dev = ba.state.device
    w_imu, w_bias = settings.imu_weights()
    weight_imu, weight_bias = (
        _const(tuple(np.asarray(w, np.float32).ravel().tolist()),
               np.shape(w), dev) for w in (w_imu, w_bias))
    rot_imu_cam, gravity = _consts(settings, dev)

    H = torch.zeros((D, D), device=dev)
    b = torch.zeros(D, device=dev)

    # ---- bias random walk between consecutive frames ----
    dts = imu.timestamps[1:] - imu.timestamps[:-1]      # (F-1,)
    pair_valid = ba.frame_valid[1:] & ba.frame_valid[:-1] \
        & imu.bias_valid[1:] & imu.bias_valid[:-1]
    sba = _const((100.0,) * 3 + (1.0,) * 3, (6,), dev)
    Wb = weight_bias * sba[:, None] * sba[None, :]
    bias = imu.state[:, :6]   # internal
    zero = torch.zeros((), device=dev)
    for i in range(F - 1):
        blk_p = _frame_block(i) + 8
        blk_c = _frame_block(i + 1) + 8
        wi = torch.where(pair_valid[i],
                         1.0 / torch.clamp(dts[i], min=1e-3), zero)
        Hb = Wb * wi
        H[blk_p:blk_p + 6, blk_p:blk_p + 6] += Hb
        H[blk_c:blk_c + 6, blk_c:blk_c + 6] += Hb
        H[blk_p:blk_p + 6, blk_c:blk_c + 6] += -Hb
        H[blk_c:blk_c + 6, blk_p:blk_p + 6] += -Hb
        r_b = (bias[i + 1] - bias[i]) * sba       # real-unit residual
        tb = (weight_bias * wi) @ r_b * sba
        b[blk_p:blk_p + 6] += -tb
        b[blk_c:blk_c + 6] += tb

    # ---- per-sample dynamics terms ----
    r, Js, Jf, valid = imu_sample_jacobians(
        ba, imu, settings, rot_imu_cam, gravity, weight_imu)
    vf = valid.to(torch.float32)
    JfW = torch.einsum("fnri,rs->fnis", Jf, weight_imu)        # (F,N,29,6)
    Hff = torch.einsum("fnis,fnsj->fij", JfW * vf[..., None, None], Jf)
    Hfs = torch.einsum("fnis,fns->fi", JfW * vf[..., None, None], Js)
    Hss = torch.einsum("fnr,rs,fns,fn->", Js, weight_imu, Js, vf)
    bf = torch.einsum("fnis,fns,fn->fi", JfW, r, vf)
    bs = torch.einsum("fnr,rs,fns,fn->", Js, weight_imu, r, vf)

    H[CPARS, CPARS] += Hss
    b[CPARS] += bs
    for i in range(F):
        blk = _frame_block(i)
        H[blk:blk + 29, blk:blk + 29] += Hff[i]
        H[blk:blk + 29, CPARS] += Hfs[i]
        H[CPARS, blk:blk + 29] += Hfs[i]
        b[blk:blk + 29] += bf[i]

    # ---- spline rotation + velocity constraints (KKT rows) ----
    C = 6 * (F - 1)
    J_cst = torch.zeros((C, D), device=dev)
    r_cst = torch.zeros(C, device=dev)
    cst_valid = torch.zeros(C, dtype=torch.bool, device=dev)
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    R_w_eval = ba.T_cw_eval[:, :3, :3]
    I3 = torch.eye(3, device=dev)
    for i in range(1, F):
        row = 6 * (i - 1)
        blk_p, blk_c = _frame_block(i - 1), _frame_block(i)
        tpf = imu.timestamps[i - 1] - imu.timestamps[i]
        sv = imu.spline_valid[i] & ba.frame_valid[i] & ba.frame_valid[i - 1]
        svf = sv.to(torch.float32)
        # rotation constraint
        R_pred = spline_rot_c_t(imu.state[i], tpf)
        R_meas = T_cw[i, :3, :3].transpose(-1, -2) @ T_cw[i - 1, :3, :3]
        r_rot = lie.so3_log(R_meas.T @ R_pred)
        rot_p_w = R_w_eval[i - 1].transpose(-1, -2)
        J_cst[row:row + 3, blk_p + 3:blk_p + 6] = \
            -B.SCALE_XI_ROT * rot_p_w * svf
        J_cst[row:row + 3, blk_c + 3:blk_c + 6] = \
            B.SCALE_XI_ROT * rot_p_w * svf
        J_cst[row:row + 3, blk_c + 14:blk_c + 17] = 100.0 * tpf * I3 * svf
        J_cst[row:row + 3, blk_c + 20:blk_c + 23] = \
            1000.0 * tpf ** 2 * I3 * svf
        J_cst[row:row + 3, blk_c + 26:blk_c + 29] = \
            1000.0 * tpf ** 3 * I3 * svf
        r_cst[row:row + 3] = r_rot * svf
        cst_valid[row:row + 3] = sv

        # velocity constraint (needs a next frame)
        if i + 1 < F:
            blk_n = _frame_block(i + 1)
            tnf = imu.timestamps[i] - imu.timestamps[i + 1]
            vv = sv & imu.spline_valid[i + 1] & ba.frame_valid[i + 1]
            vvf = vv.to(torch.float32)
            small = torch.full_like(tpf, -1e-6)
            tpf_s = torch.where(torch.abs(tpf) < 1e-6, small, tpf)
            tnf_s = torch.where(torch.abs(tnf) < 1e-6, small, tnf)
            sq_c = _scaled(imu.state[i])
            sq_n = _scaled(imu.state[i + 1])
            d_vel_dso = (T_cw[i - 1, :3, 3] - T_cw[i, :3, 3]) / tpf_s \
                - (T_cw[i, :3, 3] - T_cw[i + 1, :3, 3]) / tnf_s
            d_vel_imu = (tpf * sq_c[9:12] + tpf ** 2 * sq_c[15:18]
                         + tnf * sq_n[9:12] + 2 * tnf ** 2 * sq_n[15:18])
            J_cst[row + 3:row + 6, blk_p:blk_p + 3] = \
                -B.SCALE_XI_TRANS / tpf_s * I3 * vvf
            J_cst[row + 3:row + 6, blk_c:blk_c + 3] = \
                B.SCALE_XI_TRANS * (1.0 / tpf_s + 1.0 / tnf_s) * I3 * vvf
            J_cst[row + 3:row + 6, blk_n:blk_n + 3] = \
                -B.SCALE_XI_TRANS / tnf_s * I3 * vvf
            J_cst[row + 3:row + 6, blk_c + 17:blk_c + 20] = \
                1000.0 * tpf * I3 * vvf
            J_cst[row + 3:row + 6, blk_c + 23:blk_c + 26] = \
                1000.0 * tpf ** 2 * I3 * vvf
            J_cst[row + 3:row + 6, blk_n + 17:blk_n + 20] = \
                1000.0 * tnf * I3 * vvf
            J_cst[row + 3:row + 6, blk_n + 23:blk_n + 26] = \
                1000.0 * 2 * tnf ** 2 * I3 * vvf
            r_cst[row + 3:row + 6] = (d_vel_imu - d_vel_dso) * vvf
            cst_valid[row + 3:row + 6] = vv

    return H, b, J_cst, r_cst, cst_valid


def vio_state_mask(ba: B.BAState, imu: ImuState, settings: Settings):
    """(D,) live-dimension mask: calib + (scale iff not stereo-driven) +
    per-frame [8 dso | 6 bias | 15 spline iff spline_valid]
    (the unconstrained-state elision, EnergyFunctional.cpp:1113-1132)."""
    F = ba.F
    fv = ba.frame_valid.to(torch.float32)
    bv = fv * imu.bias_valid
    sv = fv * (imu.spline_valid & imu.bias_valid)
    per = torch.cat([fv[:, None].expand(F, 8), bv[:, None].expand(F, 6),
                     sv[:, None].expand(F, 15)], 1)
    head = _const((1.0,) * CPARS
                  + (0.0 if settings.enable_scale_opt else 1.0,),
                  (CPARS + 1,), fv.device)
    return torch.cat([head, per.reshape(-1)])


def solve_vio(ba: B.BAState, imu: ImuState, H8, b8, H8_sc, b8_sc, HM, bM,
              settings: Settings, lam: float = 1e-5):
    """The full VIO KKT solve (solveSystemF, EnergyFunctional.cpp:1029-1184).

    Returns (x8 (4+8F) vision step source, x_scale, x_imu (F,21))."""
    F = ba.F
    D = vio_dim(F)
    dev = H8.device
    H, b = expand_vision_Hb(H8, b8, F)
    H_sc, b_sc = expand_vision_Hb(H8_sc, b8_sc, F)

    H_imu, b_imu, J_cst, r_cst, cst_valid = imu_hessian(ba, imu, settings)
    H = H + H_imu
    b = b + b_imu

    # marg prior with FEJ delta (delta2 construction, :1073-1088)
    delta8 = get_vio_delta(ba, imu)
    H = H + HM
    b = b + bM + HM @ delta8

    # damping + Schur part
    di = torch.arange(D, device=dev)
    H[di, di] = H[di, di] * (1.0 + lam)
    H = H - H_sc / (1.0 + lam)
    b = b - b_sc

    # elision masking
    m = vio_state_mask(ba, imu, settings)
    H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    b = b * m
    J_cst = J_cst * m[None, :]

    # KKT assembly
    C = J_cst.shape[0]
    cm = cst_valid.to(torch.float32)
    J_cst = J_cst * cm[:, None]
    r_cst = r_cst * cm
    K = torch.zeros((D + C, D + C), device=dev)
    K[:D, :D] = H
    K[:D, D:] = J_cst.T
    K[D:, :D] = J_cst
    ci = D + torch.arange(C, device=dev)
    K[ci, ci] = 1.0 - cm
    rhs = torch.cat([b, r_cst])

    svec_i = 1.0 / torch.sqrt(torch.abs(torch.diagonal(K)) + 10.0)
    Ks = K * svec_i[:, None] * svec_i[None, :]
    x_full = svec_i * solve(Ks, svec_i * rhs)
    x = x_full[:D]

    # extract: vision 8F part, scale, imu 21F part
    x8 = x[_idx8(F, dev)]
    x_scale = x[CPARS]
    idx21 = (CPARS + 1 + 8 + 29 * torch.arange(F, device=dev)[:, None]
             + torch.arange(21, device=dev)[None, :]).reshape(-1)
    x_imu = x[idx21].reshape(F, 21)
    return x8, x_scale, x_imu


def get_vio_delta(ba: B.BAState, imu: ImuState) -> torch.Tensor:
    """FEJ delta in the (5+29F) layout; imu/scale deltas only once trapped."""
    d8 = ba.state - ba.state_zero
    d21 = torch.where(imu.scale_trapped, imu.state - imu.state_zero,
                      torch.zeros_like(imu.state))
    ds = torch.where(imu.scale_trapped, imu.scale - imu.scale_zero,
                     torch.zeros_like(imu.scale))
    return torch.cat([ba.c - ba.c_zero, ds[None],
                      torch.cat([d8, d21], 1).reshape(-1)])


# ---------------------------------------------------------------------------
# initialization / propagation / scale trapping
# ---------------------------------------------------------------------------

def initialize_imu(ba: B.BAState, imu: ImuState, settings: Settings):
    """Closed-form spline + gyro-bias + scale init from 5 KFs
    (FrameHessian::initializeImu, HessianBlocks.cpp:253-355).
    Returns (imu, ok) with ok a 0-d bool tensor."""
    dev = ba.state.device
    rot_imu_cam, gravity = _consts(settings, dev)
    s21 = _s21(ba.state)
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    base = 4    # newest of the 5 KFs (slots 0..4)
    ts = imu.timestamps

    # cubic fit through relative poses of frames 1..3 wrt base
    A = torch.zeros((3, 3), device=dev)
    rhs = torch.zeros((3, 6), device=dev)
    for i in range(3):
        t0 = ts[i + 1] - ts[base]
        A[i] = torch.stack([t0, t0 * t0, t0 ** 3])
        rel = lie.se3_log(lie.se3_inv(T_cw[base]) @ T_cw[i + 1])
        rhs[i, 3:] = rel[3:]
        rhs[i, :3] = T_cw[i + 1, :3, 3] - T_cw[base, :3, 3]
    x = solve(A, rhs)                       # rows: l0, q0, c0 (real units)
    l0, q0, c0 = x[0], x[1], x[2]

    state = imu.state.clone()
    vel = imu.vel.clone()
    for i in range(5):
        t0 = ts[i] - ts[base]
        v = l0 + 2 * q0 * t0 + 3 * c0 * t0 * t0
        q_i = q0 + 3 * c0 * t0
        s = torch.cat([torch.zeros(6, device=dev), v[3:], q_i[:3], q_i[3:],
                       c0[:3], c0[3:]])
        state[i] = s / s21
        vel[i] = v[:3]

    # gyro bias from frames 2..4 samples against the base spline
    sel = torch.zeros(ba.F, dtype=torch.bool, device=dev)
    sel[2:5] = True
    mask = imu.imu_valid & sel[:, None]
    t_all = (imu.ts + ts[:, None]) - ts[base]   # sample time wrt base frame
    gyro_pred = torch.einsum("ij,fnj->fni", rot_imu_cam,
                             spline_gyro(state[base][None, None, :], t_all))
    dg = torch.where(mask[..., None], imu.gyro - gyro_pred,
                     torch.zeros_like(gyro_pred))
    n_samples = torch.clamp(torch.sum(mask), min=1)
    gyro_bias = torch.sum(dg, (0, 1)) / n_samples
    state[:5, 3:6] = gyro_bias[None, :] / 1.0   # SCALE_BG = 1

    # scale (mono+imu only): LSQ acc_pred*s = acc_meas - R g
    scale_scaled = imu.scale * SCALE_SCALE
    if not settings.enable_scale_opt:
        R_ct = spline_rot_c_t(state[base][None, None, :], t_all)
        R_wc = T_cw[base, :3, :3].transpose(-1, -2)
        rot_ti_w = torch.einsum("ij,fnkj,kl->fnil", rot_imu_cam, R_ct, R_wc)
        acc_pred = torch.einsum("fnij,fnj->fni", rot_ti_w,
                                spline_acc(state[base][None, None, :], t_all))
        acc_meas = imu.acc - torch.einsum("fnij,j->fni", rot_ti_w, gravity)
        msk = mask[..., None].to(torch.float32)
        num = torch.sum(acc_pred * acc_meas * msk)
        den = torch.clamp(torch.sum(acc_pred * acc_pred * msk), min=1e-9)
        scale_scaled = num / den

    ok = scale_scaled > 0
    spline_valid = imu.spline_valid.clone()
    spline_valid[1:5] = True
    imu = imu._replace(
        state=state, state_zero=state, vel=vel,
        bias_valid=imu.bias_valid | (torch.arange(ba.F, device=dev) < 5),
        spline_valid=spline_valid,
        scale=scale_scaled / SCALE_SCALE, scale_zero=scale_scaled / SCALE_SCALE)
    return imu, ok


def propagate_imu_state(imu: ImuState, slot, last_ts, last_vel,
                        last_R_wc_world, last_bias6, settings: Settings):
    """Fit this frame's spline from raw IMU between the last KF and now
    (propagateImuState, HessianBlocks.cpp:357-404). `slot`: an int or a
    0-dim device int; its rows are read by `at` and written by a one-hot
    `torch.where`, which reads nothing back."""
    dev = imu.state.device
    rot_imu_cam, gravity = _consts(settings, dev)
    acc = at(imu.acc, slot)
    gyro = at(imu.gyro, slot)
    ts_rel = at(imu.ts, slot)
    valid = at(imu.imu_valid, slot)
    ts_slot = at(imu.timestamps, slot)
    scale_scaled = imu.scale * SCALE_SCALE

    ub_acc = acc - last_bias6[:3]
    ub_gyro = gyro - last_bias6[3:]

    # integrate gyro to world rotations at each sample (in sample order)
    ts_abs = ts_rel + ts_slot
    dt = torch.diff(ts_abs, prepend=torch.reshape(last_ts, (1,)))
    dt = torch.where(valid, torch.clamp(dt, min=0.0), torch.zeros_like(dt))
    R_stack = ordered_rotations(last_R_wc_world, ub_gyro, dt)
    t = ts_rel
    Aa = torch.stack([torch.zeros_like(t), 2 * scale_scaled * torch.ones_like(t),
                      6 * t * scale_scaled], -1)          # (N,3)
    ba_rhs = torch.einsum("nij,jk,nk->ni", R_stack, rot_imu_cam.T, ub_acc) \
        - gravity
    Ag = torch.stack([torch.ones_like(t), 2 * t, 3 * t * t], -1)
    bg_rhs = torch.einsum("ij,nj->ni", rot_imu_cam.T, ub_gyro)

    vm = valid.to(torch.float32)[:, None]
    eye = torch.eye(3, device=dev)
    AtA_a = (Aa * vm).T @ Aa + 1e-6 * eye
    xa = solve(AtA_a, (Aa * vm).T @ ba_rhs)      # (3,3) rows 1,2 used
    AtA_g = (Ag * vm).T @ Ag + 1e-6 * eye
    xg = solve(AtA_g, (Ag * vm).T @ bg_rhs)

    s21 = torch.cat([last_bias6, xg[0], xa[1], xg[1], xa[2], xg[2]])
    sc = s21 / _s21(s21)
    t_last = last_ts - ts_slot
    vel_new = last_vel - (2 * t_last * s21[9:12]
                          + 3 * t_last ** 2 * s21[15:18])
    sel = torch.arange(imu.state.shape[0], device=dev) == slot
    row = sel[:, None]
    return imu._replace(state=torch.where(row, sc, imu.state),
                        state_zero=torch.where(row, sc, imu.state_zero),
                        vel=torch.where(row, vel_new, imu.vel),
                        bias_valid=imu.bias_valid | sel)


def try_trap_scale(imu: ImuState, thres: float) -> ImuState:
    """Scale trapping by queue variance (tryTrapScale)."""
    q = torch.where(torch.arange(10, device=imu.scale.device)
                    == imu.queue_i, imu.scale, imu.scale_queue)
    qi = (imu.queue_i + 1) % 10
    var = (SCALE_SCALE ** 2 / 9.0) * torch.sum((q - q.mean()) ** 2)
    trapped = var < thres
    return imu._replace(
        scale_queue=q, queue_i=qi.to(torch.int32),
        scale_trapped=imu.scale_trapped | trapped,
        scale_zero=torch.where(trapped, q.mean(), imu.scale))
