"""The port's visual-inertial BA steps (models/energy.py: gn_step_vio,
optimize_vio, marginalize_points_vio, marginalize_frame_vio) against the
JAX package.

Inputs, all from seeded numpy draws handed to both packages: the BA window
of utils/synthetic.make_window (P = 300 points of mixed hosts over F = 6
frames of the textured plane, off its FEJ point) and an ImuState of the
same six frames (IMU states at their internal-unit scales, 50 samples per
frame, a spline on frames 1-5, a small SPD marginalization prior), with
the scale free and trapped. Every K3 linearization runs through its plain
twin here and through the Pallas kernel's interpret mode in the JAX
package.

Tolerances (tests/test_torch_helpers.py): a whole GN step, its KKT solve
and what follows from it (the moved states, the folded priors) 5e-3;
energies and the vision H/b of a point marginalization 2e-4; residual
states, masks and counters exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_slam_tpu.models import energy as JE
from sos_slam_tpu.models import imu as JIM
from sos_slam_tpu.ops import ba as JB
from sos_slam_tpu.utils.config import default_settings as j_settings
from sos_slam_tpu_torch.models import energy as TE
from sos_slam_tpu_torch.models import imu as TIM
from sos_slam_tpu_torch.ops import ba as TB
from sos_slam_tpu_torch.utils import convert, synthetic
from sos_slam_tpu_torch.utils.config import default_settings as t_settings
from tests.test_torch_helpers import GN_TOL, close, exact, gram_close, t

P, F = 300, 6
SJ = j_settings(weight_imu_dso=6.0)
ST = t_settings(weight_imu_dso=6.0)


def _imu_arrays(seed, trapped):
    """A seeded ImuState of F frames as numpy arrays by field name."""
    r = np.random.RandomState(seed)
    N, D = JIM.N_IMU, JIM.vio_dim(F)
    per = np.array([1e-4] * 3 + [5e-3] * 3 + [5e-4] * 3 + [5e-5] * 6
                   + [1e-5] * 6)
    state = r.randn(F, 21) * per
    n = 50
    j = np.arange(N)
    ts = np.where(j < n, -(n - j) / 200.0, 0.0)
    M = 0.1 * r.randn(D, 12)
    f32 = np.float32
    return dict(
        state=state.astype(f32),
        state_zero=(state + 0.05 * r.randn(F, 21) * per).astype(f32),
        vel=(0.3 * r.randn(F, 3)).astype(f32),
        bias_valid=np.ones(F, bool), spline_valid=np.arange(F) > 0,
        timestamps=(0.25 * np.arange(F)).astype(f32),
        acc=(np.array([0.0, 0.0, 9.81]) + 0.3 * r.randn(F, N, 3)).astype(f32),
        gyro=(0.1 * r.randn(F, N, 3)).astype(f32),
        ts=np.broadcast_to(ts, (F, N)).astype(f32),
        imu_valid=np.broadcast_to(j < n, (F, N)).copy(),
        scale=f32(1.0 / JIM.SCALE_SCALE),
        scale_zero=f32(0.99 / JIM.SCALE_SCALE),
        scale_trapped=np.bool_(trapped),
        scale_queue=np.zeros(10, f32), queue_i=np.int32(0),
        HM=(M @ M.T).astype(f32), bM=(0.1 * r.randn(D)).astype(f32))


@pytest.fixture(scope="module", params=[False, True], ids=["free", "trapped"])
def win(request):
    """(JAX ba, imu, dI), (port ba, imu, dI), (w, h)."""
    fields, dI = synthetic.make_window(P, F, seed=11)
    imu = _imu_arrays(12, request.param)
    jax_side = (JB.BAState(**{k: jnp.asarray(v) for k, v in fields.items()}),
                JIM.ImuState(**{k: jnp.asarray(v) for k, v in imu.items()}),
                jnp.asarray(dI))
    port_side = (convert.from_numpy(TB.BAState, fields, "cpu"),
                 convert.from_numpy(TIM.ImuState, imu, "cpu"), t(dI))
    return jax_side, port_side, (dI.shape[2], dI.shape[1])


def test_gn_step_vio(win):
    (ba, imu, dI), (bt, it, dIt), (w, h) = win
    bj, ij, cj, ej = JE.gn_step_vio(ba, imu, dI, SJ, w, h)
    b2, i2, c2, e2 = TE.gn_step_vio(bt, it, dIt, ST, w, h)
    exact(bj.res_state, b2.res_state)
    close(bj.energy_th, b2.energy_th)
    close(ej, e2)
    for k in ("state", "c", "idepth", "idepth_zero"):
        close(getattr(bj, k), getattr(b2, k), tol=GN_TOL)
    close(ij.state, i2.state, tol=GN_TOL)
    close(ij.scale, i2.scale, tol=GN_TOL)
    assert bool(cj) == bool(c2)


def test_optimize_vio(win):
    """Two VIO GN steps, the newest frame's FEJ reset, its velocity update
    and the final linearization."""
    (ba, imu, dI), (bt, it, dIt), (w, h) = win
    bj, ij, sj = JE.optimize_vio(ba, imu, dI, SJ, w, h, max_its=2)
    b2, i2, s2 = TE.optimize_vio(bt, it, dIt, ST, w, h, max_its=2)
    assert int(sj["n_its"]) == s2["n_its"]
    assert abs(int(sj["n_active"]) - int(s2["n_active"])) <= 2
    close(sj["rmse"], s2["rmse"], tol=GN_TOL)
    for k in ("state", "state_zero", "T_cw_eval", "c"):
        close(getattr(bj, k), getattr(b2, k), tol=GN_TOL)
    for k in ("state", "state_zero", "vel", "scale"):
        close(getattr(ij, k), getattr(i2, k), tol=GN_TOL)


def test_marginalize_points_vio(win):
    """K3 in use_rz mode on every fourth point, folded into the (5+29F)
    prior."""
    (ba, imu, dI), (bt, it, dIt), (w, h) = win
    marg = np.asarray((np.arange(P) % 4 == 1) & np.asarray(ba.pt_valid))
    bj, ij = JE.marginalize_points_vio(ba, imu, dI, jnp.asarray(marg), SJ,
                                       w, h)
    b2, i2 = TE.marginalize_points_vio(bt, it, dIt, t(marg), ST, w, h)
    exact(bj.pt_valid, b2.pt_valid)
    exact(bj.res_exist, b2.res_exist)
    close(ij.HM, i2.HM)
    close(ij.bM, i2.bM)


def _marg_frame(win, k, spline_valid_k=True, no_translation=False,
                weak_translation=0.0, **kw):
    """Both packages' marginalize_frame_vio of slot k, after the window
    drops what the fold requires: the points hosted in k and the residuals
    into k. `no_translation`: the prior holds nothing on slot k's
    translation (as when no marginalized point constrained it).
    `weak_translation`: then three marginalized points inform it after
    all, with Jacobian rows whose translation entries are of that size
    (those on slot k's other dims and on the other frames of the size of
    the prior's), added to the prior in f32. `kw` goes to the port's."""
    (ba, imu, dI), (bt, it, dIt), _ = win
    strag = np.asarray(ba.pt_valid & (ba.host == k))
    keep = ~strag[:, None] & (np.arange(F)[None, :] != k)
    prior = np.full(8, 10.0, np.float32)
    HM, bM = np.array(imu.HM), np.array(imu.bM)
    if no_translation or weak_translation:
        prior[:3] = 0.0
        tr = JIM.CPARS + 1 + 29 * k + np.arange(3)
        HM[tr, :] = HM[:, tr] = bM[tr] = 0.0
    if weak_translation:
        r = np.random.RandomState(3)
        blk = JIM.CPARS + 1 + 29 * k + np.arange(29)
        others = np.setdiff1d(np.arange(JIM.CPARS + 1, len(HM)), blk)
        J = np.zeros((3, len(HM)))
        J[:, blk] = 0.3 * r.randn(3, 29) * np.sqrt(
            np.abs(np.diagonal(HM)[blk]).clip(1e-3))
        J[:, tr] = weak_translation * r.randn(3, 3)
        J[:, others] = 0.1 * r.randn(3, len(others))
        HM = HM + (J.T @ J).astype(np.float32)
    ba = ba._replace(pt_valid=ba.pt_valid & ~jnp.asarray(strag),
                     res_exist=ba.res_exist & jnp.asarray(keep),
                     prior=ba.prior.at[k].set(jnp.asarray(prior)))
    bt = bt._replace(pt_valid=bt.pt_valid & ~t(strag),
                     res_exist=bt.res_exist & t(keep),
                     prior=t(np.asarray(ba.prior)))
    sv = np.asarray(imu.spline_valid).copy()
    sv[k] = spline_valid_k
    imu = imu._replace(spline_valid=jnp.asarray(sv), HM=jnp.asarray(HM),
                       bM=jnp.asarray(bM))
    it = it._replace(spline_valid=t(sv), HM=t(HM), bM=t(bM))
    return (JE.marginalize_frame_vio(ba, imu, jnp.int32(k), SJ),
            TE.marginalize_frame_vio(bt, it, k, ST, **kw))


@pytest.mark.parametrize("k", [1, 3])
def test_marginalize_frame_vio(win, k):
    """Frame k's 29-dim block Schur-folded out of the prior, with the IMU
    links of (k-1, k) and (k, k+1) folded in first, and every per-frame
    array compacted. Interior slots with a valid spline: at slot 0, or at
    a slot without a valid spline, the fold's block is singular (the next
    test), and the newest slot is never marginalized."""
    (bj, ij), (b2, i2) = _marg_frame(win, k)
    for f in ("frame_valid", "host", "res_exist", "res_state"):
        exact(getattr(bj, f), getattr(b2, f))
    for f in ("bias_valid", "spline_valid", "imu_valid"):
        exact(getattr(ij, f), getattr(i2, f))
    for f in ("state", "T_cw_eval", "prior", "exposure"):
        close(getattr(bj, f), getattr(b2, f))
    for f in ("state", "state_zero", "vel", "timestamps", "acc", "gyro",
              "ts"):
        close(getattr(ij, f), getattr(i2, f))
    close(ij.HM, i2.HM, tol=GN_TOL)
    close(ij.bM, i2.bM, tol=GN_TOL)


def _live_inv(A):
    """The float64 inverse of the rows and columns of A that are not all
    zero, with zeros in the others: a fold with it leaves those dims out."""
    a = A.double()
    idx = torch.nonzero((a != 0).any(1))[:, 0]
    out = torch.zeros_like(a)
    out[idx[:, None], idx] = torch.linalg.inv(a[idx][:, idx])
    return out.to(A.dtype)


def test_marginalize_frame_vio_without_spline(win, monkeypatch):
    """A fault of the JAX package (ROADMAP Queue 3): at a slot whose
    spline is not valid, the fold zeroes the slot's 15 spline dims but
    keeps them in the 29x29 block it inverts, which is then singular, and
    the prior comes out NaN (all of HM, and bM); every later VIO step is
    then a zero step. The port's `jax_form=True` keeps that fold and gives
    the JAX package's prior, NaN included: all of HM, and bM wherever the
    JAX package's is NaN (the port's all-NaN inverse also fills the 29
    entries of the freed last block, which the JAX package's leaves at
    0); the rest of bM at the fold's tolerance. The port's own fold is
    finite and equals the fold computed without the dead dims (the block
    inverted over its live dims only, in float64)."""
    (_, ij), (_, i2) = _marg_frame(win, 2, spline_valid_k=False,
                                   jax_form=True)
    assert np.isnan(np.asarray(ij.HM)).all() and i2.HM.isnan().all()
    nan_j, nan_t = np.isnan(np.asarray(ij.bM)), i2.bM.isnan().numpy()
    assert nan_j.any() and nan_t[nan_j].all()
    both = ~nan_j & ~nan_t
    close(np.asarray(ij.bM)[both], i2.bM.numpy()[both], tol=GN_TOL)

    (_, _), (b3, i3) = _marg_frame(win, 2, spline_valid_k=False)
    assert i3.HM.isfinite().all() and i3.bM.isfinite().all()
    monkeypatch.setattr(TE, "inv", _live_inv)
    (_, _), (b4, i4) = _marg_frame(win, 2, spline_valid_k=False,
                                   jax_form=True)
    close(i4.HM, i3.HM, tol=GN_TOL)
    close(i4.bM, i3.bM, tol=GN_TOL)
    for f in ("state", "state_zero", "spline_valid", "bias_valid"):
        exact(getattr(i4, f), getattr(i3, f))
    exact(b4.frame_valid, b3.frame_valid)


def test_marginalize_frame_vio_without_translation_info(win, monkeypatch):
    """The same fault with a valid spline, as it arises on the flagship
    scene (chip_smoke.py, at its first VIO frame marginalization): the
    prior holds nothing on the dying slot's translation, whose three rows
    of the inverted block are then zero. The JAX package's fold (and the
    port's `jax_form=True`) is NaN; the port's is finite and equals the
    fold without those dims."""
    (_, ij), (_, i2) = _marg_frame(win, 2, no_translation=True,
                                   jax_form=True)
    assert np.isnan(np.asarray(ij.HM)).all() and i2.HM.isnan().all()
    (_, _), (b3, i3) = _marg_frame(win, 2, no_translation=True)
    assert i3.HM.isfinite().all() and i3.bM.isfinite().all()
    monkeypatch.setattr(TE, "inv", _live_inv)
    (_, _), (b4, i4) = _marg_frame(win, 2, no_translation=True,
                                   jax_form=True)
    close(i4.HM, i3.HM, tol=GN_TOL)
    close(i4.bM, i3.bM, tol=GN_TOL)
    exact(b4.frame_valid, b3.frame_valid)


def _eig_fold(Hs, bs, sl, in_marg, jax_form=False):
    """fold_vio_block's reference: the fold in float64 over the
    eigen-directions of the scaled block whose eigenvalue exceeds
    energy.LIVE_CUT times the largest, from numpy's eigendecomposition."""
    H, b = Hs.double().numpy(), bs.double().numpy()
    blk = H[sl:sl + 29, sl:sl + 29]
    w, V = np.linalg.eigh(0.5 * (blk + blk.T))
    live = w > TE.LIVE_CUT * np.abs(w).max()
    blk_inv = (V[:, live] / w[live]) @ V[:, live].T
    keep = (~in_marg).numpy().astype(np.float64)
    Hxm = H[:, sl:sl + 29] * keep[:, None]
    bli = Hxm @ blk_inv
    return (t(((H - bli @ Hxm.T) * keep[:, None] * keep[None, :])
              .astype(np.float32)),
            t(((b - bli @ b[sl:sl + 29]) * keep).astype(np.float32)))


@pytest.mark.parametrize("weak", [1e-3, 1e-4])
def test_marginalize_frame_vio_weak_translation(win, monkeypatch, weak):
    """ROADMAP Queue 3 (the flagship scene's scale drift on the card): the
    dying slot's translation informed only by three marginalized points
    whose Jacobian rows barely move it. No row of the block is zero, but
    its weak directions lie at f32 rounding; an f32 inverse of the whole
    block (the fold before the live-subspace one, which patched only
    exactly-zero rows) is off by 0.4-0.6 of the diagonal scale here. The
    port folds over the live subspace and equals the float64 fold from an
    eigendecomposition, on the diagonal-normalized prior."""
    (_, _), (b3, i3) = _marg_frame(win, 2, weak_translation=weak)
    assert i3.HM.isfinite().all() and i3.bM.isfinite().all()
    monkeypatch.setattr(TE, "fold_vio_block", _eig_fold)
    (_, _), (b4, i4) = _marg_frame(win, 2, weak_translation=weak)
    gram_close(i3.HM, i4.HM, tol=GN_TOL)
    close(i3.bM, i4.bM, tol=GN_TOL)
    exact(b4.frame_valid, b3.frame_valid)
