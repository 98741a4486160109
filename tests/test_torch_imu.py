"""The port's spline VIO (models/imu.py) against the JAX package.

Inputs: the five-keyframe cubic-trajectory window of
tests/test_imu.py::make_vio_window (poses, 200 Hz IMU samples with a gyro
bias) and the JAX package's closed-form IMU initialization of it, carried
across with utils/convert; seeded numpy draws for the evaluators, the
vision systems and the perturbations. Every function is checked in both
FEJ branches (scale untrapped: Jacobians at the current state; trapped:
at the FEJ zero, with the state moved off it).

Tolerances (tests/test_torch_helpers.py): floats rtol 2e-4, atol
2e-4 * max(1, max|a|); masks, counters and validity exact; the KKT solve
and its steps 5e-3 (a whole GN solve)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_slam_tpu.models import imu as JIM
from sos_slam_tpu.ops import ba as JB
from sos_slam_tpu.utils.config import default_settings as j_settings
from sos_slam_tpu_torch.models import imu as TIM
from sos_slam_tpu_torch.ops import ba as TB
from sos_slam_tpu_torch.utils.config import default_settings as t_settings
from tests.test_imu import F, make_vio_window
from tests.test_torch_helpers import GN_TOL, close, exact, port_state, t

SETTINGS_J = {False: j_settings(weight_imu_dso=6.0),
              True: j_settings(weight_imu_dso=6.0, scale_opt_thres=12.0)}
SETTINGS_T = {False: t_settings(weight_imu_dso=6.0),
              True: t_settings(weight_imu_dso=6.0, scale_opt_thres=12.0)}


def _perturb(ba, imu, trapped, seed):
    """The window off its FEJ point: frame states and IMU states moved by a
    seeded draw; trapped: the scale trapped with its FEJ zero apart."""
    r = np.random.RandomState(seed)
    fv = np.asarray(ba.frame_valid)[:, None]
    ba = ba._replace(state=ba.state + jnp.asarray(
        (2e-3 * r.randn(F, 8) * fv).astype(np.float32)))
    zero = imu.state
    imu = imu._replace(state=imu.state + jnp.asarray(
        (1e-4 * r.randn(F, 21) * fv).astype(np.float32)))
    if trapped:
        imu = imu._replace(scale_trapped=jnp.array(True), state_zero=zero,
                           scale_zero=imu.scale * jnp.float32(0.98))
    return ba, imu


@pytest.fixture(scope="module", params=[False, True], ids=["free", "trapped"])
def win(request):
    """(JAX ba, JAX imu, port ba, port imu, trapped) on the initialized
    window."""
    ba, imu, _ = make_vio_window()
    imu, ok = JIM.initialize_imu(ba, imu, SETTINGS_J[False])
    assert bool(ok)
    ba, imu = _perturb(ba, imu, request.param, seed=7)
    return (ba, imu, port_state(TB.BAState, ba),
            port_state(TIM.ImuState, imu), request.param)


def test_constants_and_empty_state():
    assert TIM.SCALE_SCALE == JIM.SCALE_SCALE and TIM.N_IMU == JIM.N_IMU
    exact(TIM.IMU_SCALE21, JIM.IMU_SCALE21)
    assert TIM.vio_dim(F) == JIM.vio_dim(F)
    ej, et = JIM.empty_imu(F, 2.0), TIM.empty_imu(F, "cpu", 2.0)
    for k in ej._fields:
        a, b = np.asarray(getattr(ej, k)), getattr(et, k).numpy()
        assert a.shape == b.shape, k
        exact(a, b)


def test_spline_evaluators():
    r = np.random.RandomState(1)
    st = (1e-3 * r.randn(F, 21)).astype(np.float32)
    tt = (-0.25 * r.rand(F, 16)).astype(np.float32)
    vel = r.randn(F, 3).astype(np.float32)
    sj, tj = jnp.asarray(st)[:, None, :], jnp.asarray(tt)
    s_, t_ = t(st)[:, None, :], t(tt)
    close(JIM.spline_acc(sj, tj), TIM.spline_acc(s_, t_))
    close(JIM.spline_gyro(sj, tj), TIM.spline_gyro(s_, t_))
    close(JIM.spline_rot_c_t(sj, tj), TIM.spline_rot_c_t(s_, t_))
    close(JIM.spline_t_c2t(sj, jnp.asarray(vel)[:, None, :], tj),
          TIM.spline_t_c2t(s_, t(vel)[:, None, :], t_))


def test_expand_vision_Hb():
    r = np.random.RandomState(2)
    D8 = 4 + 8 * F
    H8 = r.randn(D8, D8).astype(np.float32)
    b8 = r.randn(D8).astype(np.float32)
    Hj, bj = JIM.expand_vision_Hb(jnp.asarray(H8), jnp.asarray(b8), F)
    Ht, bt = TIM.expand_vision_Hb(t(H8), t(b8), F)
    exact(Hj, Ht)
    exact(bj, bt)


def test_imu_sample_jacobians(win):
    ba, imu, bt, it, _ = win
    s = SETTINGS_J[False]
    w_imu, _ = s.imu_weights()
    ric = np.asarray(s.rot_imu_cam, np.float32).reshape(3, 3)
    g = np.asarray(s.gravity, np.float32)
    oj = JIM.imu_sample_jacobians(ba, imu, s, jnp.asarray(ric),
                                  jnp.asarray(g), jnp.asarray(w_imu))
    ot = TIM.imu_sample_jacobians(bt, it, SETTINGS_T[False], t(ric), t(g),
                                  t(w_imu))
    for a, b in zip(oj[:3], ot[:3]):
        close(a, b)
    exact(oj[3], ot[3])


@pytest.mark.parametrize("stereo", [False, True])
def test_imu_hessian_mask_and_delta(win, stereo):
    ba, imu, bt, it, _ = win
    Hj, bj, Jj, rj, cj = JIM.imu_hessian(ba, imu, SETTINGS_J[stereo])
    Ht, btt, Jt, rt, ct = TIM.imu_hessian(bt, it, SETTINGS_T[stereo])
    for a, b in ((Hj, Ht), (bj, btt), (Jj, Jt), (rj, rt)):
        close(a, b)
    exact(cj, ct)
    exact(JIM.vio_state_mask(ba, imu, SETTINGS_J[stereo]),
          TIM.vio_state_mask(bt, it, SETTINGS_T[stereo]))
    close(JIM.get_vio_delta(ba, imu), TIM.get_vio_delta(bt, it))


def _vision_system(seed):
    """A seeded vision system at the window's size: an SPD (4+8F) H8 with
    its b8, the Schur part of a few points, and a small (5+29F) prior."""
    r = np.random.RandomState(seed)
    D8, D = 4 + 8 * F, TIM.vio_dim(F)
    A = r.randn(D8, D8)
    S = r.randn(D8, 6)
    M = 0.1 * r.randn(D, 12)
    sysm = dict(H8=A @ A.T * 10 + 100 * np.eye(D8), b8=10 * r.randn(D8),
                H8_sc=S @ S.T, b8_sc=r.randn(D8), HM=M @ M.T,
                bM=0.1 * r.randn(D))
    return {k: v.astype(np.float32) for k, v in sysm.items()}


@pytest.mark.parametrize("stereo", [False, True])
def test_solve_vio(win, stereo):
    ba, imu, bt, it, _ = win
    sysm = _vision_system(3)
    names = ("H8", "b8", "H8_sc", "b8_sc", "HM", "bM")
    xj = JIM.solve_vio(ba, imu, *(jnp.asarray(sysm[k]) for k in names),
                       SETTINGS_J[stereo])
    xt = TIM.solve_vio(bt, it, *(t(sysm[k]) for k in names),
                       SETTINGS_T[stereo])
    for a, b in zip(xj, xt):
        assert np.isfinite(b.numpy()).all()
        close(a, b, tol=GN_TOL)


@pytest.mark.parametrize("stereo", [False, True])
def test_initialize_imu(stereo):
    """The closed-form spline + gyro-bias init, and with mono the scale LSQ
    (skipped with stereo, where the solve owns the scale)."""
    ba, imu, _ = make_vio_window()
    ba = ba._replace(T_cw_eval=ba.T_cw_eval.at[:, :3, 3].mul(0.5))
    ij, okj = JIM.initialize_imu(ba, imu, SETTINGS_J[stereo])
    it, okt = TIM.initialize_imu(port_state(TB.BAState, ba),
                                 port_state(TIM.ImuState, imu),
                                 SETTINGS_T[stereo])
    assert bool(okj) == bool(okt)
    for k in ("state", "state_zero", "vel", "scale", "scale_zero"):
        close(getattr(ij, k), getattr(it, k))
    for k in ("bias_valid", "spline_valid"):
        exact(getattr(ij, k), getattr(it, k))


def test_propagate_imu_state(win):
    """The spline of slot 4 fitted from its raw samples after slot 3 (the
    gyro integrated in sample order)."""
    ba, imu, bt, it, _ = win
    T_j = JB.state_to_pose(ba.T_cw_eval, ba.state)
    T_t = TB.state_to_pose(bt.T_cw_eval, bt.state)
    slot, prev = 4, 3
    bias_j = (imu.state[prev] * JIM.IMU_SCALE21)[:6]
    bias_t = (it.state[prev] * TIM._s21(it.state))[:6]
    pj = JIM.propagate_imu_state(imu, slot, imu.timestamps[prev],
                                 imu.vel[prev], T_j[prev, :3, :3], bias_j,
                                 SETTINGS_J[False])
    pt = TIM.propagate_imu_state(it, slot, it.timestamps[prev], it.vel[prev],
                                 T_t[prev, :3, :3], bias_t, SETTINGS_T[False])
    for k in ("state", "state_zero", "vel"):
        close(getattr(pj, k), getattr(pt, k))
    exact(pj.bias_valid, pt.bias_valid)


def test_try_trap_scale():
    """Sixteen scales through the trapping queue of ten: the queue wraps,
    the variance gate traps once ten settled scales fill it, the FEJ zero
    follows."""
    r = np.random.RandomState(4)
    scales = (1.0 + np.concatenate([0.2 * r.randn(4), 1e-4 * r.randn(12)])
              ) / JIM.SCALE_SCALE
    ij, it = JIM.empty_imu(F), TIM.empty_imu(F, "cpu")
    for s in scales.astype(np.float32):
        ij = JIM.try_trap_scale(ij._replace(scale=jnp.float32(s)), 1e-4)
        it = TIM.try_trap_scale(it._replace(scale=torch.tensor(s)), 1e-4)
        for k in ("queue_i", "scale_trapped"):
            exact(getattr(ij, k), getattr(it, k))
        for k in ("scale_queue", "scale_zero"):
            close(getattr(ij, k), getattr(it, k))
    assert bool(it.scale_trapped) and bool(ij.scale_trapped)


@pytest.mark.parametrize("ts_thresh", [-0.1, -0.001])
def test_imu_hypothesis_on_device(ts_thresh):
    """The fused path's gyro-integrated tracking hypothesis from a staged
    sample block (30 of 128 samples valid): with at least two samples
    after `ts_thresh` it leads and the constant-motion one shifts into the
    retry batch; with fewer the hypotheses pass through unchanged."""
    from sos_slam_tpu.models.full_system import _imu_hyp_device as j_hyp
    from sos_slam_tpu.utils import lie as JL
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import synthetic
    r = np.random.RandomState(9)
    N = TIM.N_IMU

    def pose():
        return np.asarray(JL.se3_exp(jnp.asarray(
            (0.1 * r.randn(6)).astype(np.float32))))

    T_prev, T_ref, T_prim = pose(), pose(), pose()
    T_hyps = np.stack([pose() for _ in range(5)])
    gyro = (0.2 * r.randn(N, 3)).astype(np.float32)
    j = np.arange(N)
    ts = np.where(j < 30, -(30 - j) / 200.0, 0.0).astype(np.float32)
    valid = j < 30
    bg = (0.01 * r.randn(3)).astype(np.float32)
    s = SETTINGS_J[False]
    pj, hj = j_hyp(*(jnp.asarray(a) for a in (T_prev, T_ref, T_prim, T_hyps,
                                               gyro, ts, valid)),
                   jnp.float32(ts_thresh), jnp.asarray(bg), s)
    fs = FullSystem(synthetic.default_calib(128, 96), SETTINGS_T[False],
                    device="cpu")
    pt, ht = fs._imu_hyp_device(*(t(a) for a in (T_prev, T_ref, T_prim,
                                                 T_hyps, gyro, ts, valid)),
                                float(np.float32(ts_thresh)), t(bg))
    close(pj, pt)
    close(hj, ht)
    if ts_thresh > -0.005:
        exact(pt, T_prim)
        exact(ht, T_hyps)


@pytest.mark.parametrize("ts_thresh", [-0.1, -0.001])
def test_imu_hypothesis_reads_nothing_back(ts_thresh):
    """The same hypothesis with the window start staged on the device (a
    0-dim tensor, as the fused dispatch stages it) under the host-read
    guard: the choice between the gyro-integrated and the constant-motion
    hypothesis is made on the device, and the result is the float-input
    result's bits."""
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.utils import lie, synthetic
    from tests.test_torch_helpers import no_host_reads
    r = np.random.RandomState(9)
    N = TIM.N_IMU

    def pose():
        return lie.se3_exp(torch.as_tensor(
            (0.1 * r.randn(6)).astype(np.float32)))

    T_prev, T_ref, T_prim = pose(), pose(), pose()
    T_hyps = torch.stack([pose() for _ in range(5)])
    gyro = torch.as_tensor((0.2 * r.randn(N, 3)).astype(np.float32))
    j = np.arange(N)
    ts = torch.as_tensor(np.where(j < 30, -(30 - j) / 200.0, 0.0)
                         .astype(np.float32))
    valid = torch.as_tensor(j < 30)
    bg = torch.as_tensor((0.01 * r.randn(3)).astype(np.float32))
    fs = FullSystem(synthetic.default_calib(128, 96), SETTINGS_T[False],
                    device="cpu")
    args = (T_prev, T_ref, T_prim, T_hyps, gyro, ts, valid)
    pf, hf = fs._imu_hyp_device(*args, float(np.float32(ts_thresh)), bg)
    staged = torch.full((), float(np.float32(ts_thresh)))
    with no_host_reads():
        pt, ht = fs._imu_hyp_device(*args, staged, bg)
    exact(pf, pt)
    exact(hf, ht)
    used = ts_thresh < -0.005
    assert torch.equal(pt, T_prim) != used
    assert torch.equal(ht[0], T_prim) == used
