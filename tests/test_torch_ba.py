"""The port's BA forms, K3 and K4 against the JAX package.

On tests/test_ba.py::build_window and the mixed-host window of
tests/test_ba_p.py: the ops/ba forms; K3's plain twin against
ba_p.fused_iteration in interpret mode (fields, exact states, marg mode,
full GN step); K4's plain twin against ba_p.act_pass in interpret mode;
energy.optimize and the marginalizations end to end."""

import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.models import energy as JE
from sos_slam_tpu.ops import ba as JB
from sos_slam_tpu.ops import ba_p as JBP
from sos_slam_tpu.ops import ba_t as JBT
from sos_slam_tpu_torch.models import energy as TE
from sos_slam_tpu_torch.ops import ba as TB
from sos_slam_tpu_torch.ops import ba_p as TBP
from sos_slam_tpu_torch.utils import convert, synthetic
from tests.test_ba import SETTINGS, W, H, build_window
from tests.test_ba_p import _mixed_host_window
from tests.test_torch_helpers import (GN_TOL, act_inputs, close, exact,
                                      gram_close, port_state, t)


def _windows():
    ba0, dI0, _, _ = build_window(n_frames=3, n_points=100, pose_noise=0.01,
                                  idepth_noise=0.1, seed=2)
    ba1, dI1 = _mixed_host_window()
    return {"plain": (ba0, dI0), "mixed": (ba1, dI1)}


@pytest.fixture(scope="module", params=["plain", "mixed"])
def win(request):
    ba, dI = _windows()[request.param]
    pre = JB.make_precalc(ba)
    bt = port_state(TB.BAState, ba)
    pre_t = TB.make_precalc(bt)
    return ba, dI, pre, bt, t(dI), pre_t


def test_precalc_and_linearize(win):
    ba, dI, pre, bt, dIt, pre_t = win
    for k in pre._fields:
        close(getattr(pre, k), getattr(pre_t, k), tol=1e-4)
    lj = JB.linearize(ba, pre, dI, SETTINGS, W, H)
    lt = TB.linearize(bt, pre_t, dIt, SETTINGS, W, H)
    exact(lj.new_state, lt.new_state)
    exact(lj.active, lt.active)
    for k in ("X", "Jpdd", "resF", "JIdx", "JabF", "JIdx2", "JabJIdx",
              "Jab2", "energy", "energy_raw"):
        close(getattr(lj, k), getattr(lt, k))


def test_schur_forms_match(win):
    """The ops/ba forms K3's plain twin is composed of, one by one, off the
    FEJ point so that res_to_zero shifts."""
    ba, dI, _, _, dIt, _ = win
    ba2 = ba._replace(state=ba.state + 0.003 * ba.frame_valid[:, None],
                      c=ba.c * 1.001, idepth=ba.idepth * 1.01)
    bt2 = port_state(TB.BAState, ba2)
    pre_j, pre_t = JB.make_precalc(ba2), TB.make_precalc(bt2)
    lj = JB.linearize(ba2, pre_j, dI, SETTINGS, W, H)
    lt = TB.linearize(bt2, pre_t, dIt, SETTINGS, W, H)
    rz_j, rz_t = JB.res_to_zero(ba2, pre_j, lj), TB.res_to_zero(bt2, pre_t, lt)
    close(rz_j, rz_t)
    for a, b in zip(JB.accumulate_top(ba2, pre_j, lj, resApprox=rz_j),
                    TB.accumulate_top(bt2, pre_t, lt, resApprox=rz_t)):
        close(a, b)
    sj = JB.accumulate_schur(ba2, pre_j, lj, shift_prior_to_zero=True)
    st = TB.accumulate_schur(bt2, pre_t, lt, shift_prior_to_zero=True)
    exact(sj.has_res, st.has_res)
    for k in ("Hdd", "HdiF", "bd", "vcross"):
        close(getattr(sj, k), getattr(st, k))
    for a, b in zip(JB.schur_Hb(sj), TB.schur_Hb(st)):
        close(a, b)
    x = np.random.RandomState(5).randn(sj.vcross.shape[1]).astype(
        np.float32) * 1e-3
    close(JB.resubstitute(sj, jnp.asarray(x)), TB.resubstitute(st, t(x)))
    exact(JB.state_mask(ba2), TB.state_mask(bt2))
    close(JB.get_stitched_delta(ba2), TB.get_stitched_delta(bt2))


def test_k3_plain_matches_pallas_interpret(win):
    ba, dI, pre, bt, dIt, pre_t = win
    fj = JBP.fused_iteration(ba, pre, dI, SETTINGS, W, H, interpret=True)
    ft = TBP.fused_iteration(bt, pre_t, dIt, SETTINGS, W, H)
    exact(fj.new_state, ft.new_state)
    exact(fj.active, ft.active)
    exact(fj.sc.has_res, ft.sc.has_res)
    for k in ("H_top", "b_top", "H_sc", "b_sc", "energy", "energy_raw"):
        close(getattr(fj, k), getattr(ft, k))
    for k in ("H_top", "H_sc"):
        gram_close(getattr(fj, k), getattr(ft, k))
    for k in ("Hdd", "HdiF", "bd", "vcross"):
        close(getattr(fj.sc, k), getattr(ft.sc, k))
    close(JBT.update_energy_th_t(ba, fj, SETTINGS),
          TBP.update_energy_th_t(bt, ft, SETTINGS), tol=1e-5)


def test_k3_marg_mode_matches(win):
    ba, dI, pre, bt, dIt, pre_t = win
    pmask = np.asarray((jnp.arange(ba.P) % 3 == 0) & ba.pt_valid)
    kw = dict(use_rz=True, shift_prior_to_zero=False,
              prior_fac=SETTINGS.idepth_fix_prior_marg_fac)
    # move the state off its FEJ point so the res_toZero shift is live
    ba2 = ba._replace(state=ba.state + 0.003 * ba.frame_valid[:, None],
                      idepth=ba.idepth * 1.01)
    pre2 = JB.make_precalc(ba2)
    bt2 = port_state(TB.BAState, ba2)
    fj = JBP.fused_iteration(ba2, pre2, dI, SETTINGS, W, H,
                             pmask=jnp.asarray(pmask), interpret=True, **kw)
    ft = TBP.fused_iteration(bt2, TB.make_precalc(bt2), dIt, SETTINGS, W, H,
                             pmask=t(pmask), **kw)
    exact(fj.sc.has_res, ft.sc.has_res)
    for k in ("H_top", "b_top", "H_sc", "b_sc"):
        close(getattr(fj, k), getattr(ft, k))
    for k in ("H_top", "H_sc"):
        gram_close(getattr(fj, k), getattr(ft, k))
    close(fj.sc.Hdd, ft.sc.Hdd)
    close(fj.sc.bd, ft.sc.bd)


# (P, F) that fill no block of the CUDA kernels: the plain twin is what the
# kernels are held to on the card at these edges, so it is held to the
# Pallas kernel here, on the same numpy-seeded window
RAGGED_K3 = [(100, 5), (75, 1), (167, 8), (515, 3), (210, 16)]


@pytest.mark.parametrize("marg", [False, True], ids=["gn", "marg"])
@pytest.mark.parametrize("P,F", RAGGED_K3)
def test_k3_plain_matches_pallas_interpret_ragged(P, F, marg):
    fields, dI = synthetic.make_window(P, F, seed=3)
    ba = JB.BAState(**{k: jnp.asarray(v) for k, v in fields.items()})
    bt = convert.from_numpy(TB.BAState, fields, "cpu")
    kw, kw_t = {}, {}
    if marg:
        pmask = fields["pt_valid"] & (np.arange(P) % 3 == 0)
        kw = dict(use_rz=True, shift_prior_to_zero=False,
                  prior_fac=SETTINGS.idepth_fix_prior_marg_fac)
        kw_t = dict(kw, pmask=t(pmask))
        kw = dict(kw, pmask=jnp.asarray(pmask))
    fj = JBP.fused_iteration(ba, JB.make_precalc(ba), jnp.asarray(dI),
                             SETTINGS, 160, 120, interpret=True, **kw)
    ft = TBP.fused_iteration(bt, TB.make_precalc(bt), t(dI), SETTINGS, 160,
                             120, **kw_t)
    exact(fj.new_state, ft.new_state)
    exact(fj.active, ft.active)
    exact(fj.sc.has_res, ft.sc.has_res)
    for k in ("H_top", "b_top", "H_sc", "b_sc", "energy", "energy_raw"):
        close(getattr(fj, k), getattr(ft, k))
    for k in ("H_top", "H_sc"):
        gram_close(getattr(fj, k), getattr(ft, k))
    for k in ("Hdd", "HdiF", "bd", "vcross"):
        close(getattr(fj.sc, k), getattr(ft.sc, k))


def test_full_gn_step_matches(win):
    ba, dI, pre, bt, dIt, pre_t = win
    fj = JBP.fused_iteration(ba, pre, dI, SETTINGS, W, H, interpret=True)
    Hj, bj = JB.add_priors(ba, fj.H_top, fj.b_top, SETTINGS)
    xj = JB.solve_system(ba, Hj, bj, fj.H_sc, fj.b_sc)
    ft = TBP.fused_iteration(bt, pre_t, dIt, SETTINGS, W, H)
    Ht, btop = TB.add_priors(bt, ft.H_top, ft.b_top, SETTINGS)
    close(Hj, Ht)
    close(bj, btop)
    xt = TB.solve_system(bt, Ht, btop, ft.H_sc, ft.b_sc)
    close(xj, xt, tol=GN_TOL)
    close(JBT.resubstitute_t(fj.sc, xj), TBP.resubstitute_t(ft.sc, xt),
          tol=GN_TOL)
    ba_j, cb_j, e_j = JE.gn_step(ba, dI, SETTINGS, W, H)
    ba_t, cb_t, e_t = TE.gn_step(bt, dIt, SETTINGS, W, H)
    close(ba_j.state, ba_t.state, tol=GN_TOL)
    close(ba_j.idepth, ba_t.idepth, tol=GN_TOL)
    close(e_j, e_t)
    exact(ba_j.res_state, ba_t.res_state)


@pytest.mark.parametrize("clamp", [False, True])
def test_k4_plain_matches_pallas_interpret(clamp):
    ins = act_inputs(3 + int(clamp))
    oj = JBP.act_pass(*(jnp.asarray(x) for x in ins), clamp=clamp,
                      huber_th=9.0, interpret=True)
    ot = TBP.act_pass(*(t(x) for x in ins), clamp=clamp, huber_th=9.0)
    exact(np.asarray(oj[1]) > 0.5, ot[1].numpy() > 0.5)
    live = np.asarray(oj[1]) < 0.5
    close(np.asarray(oj[0])[live], ot[0].numpy()[live])
    for a, b in zip(oj[2:], ot[2:]):
        assert np.isfinite(b.numpy()).all()
        close(a, b)


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("N,F", [(100, 1), (100, 3), (515, 5), (1061, 8),
                                 (210, 16)])
def test_k4_plain_matches_pallas_interpret_ragged(N, F, clamp):
    ins = synthetic.make_act_inputs(N, F, seed=5)
    oj = JBP.act_pass(*(jnp.asarray(x) for x in ins), clamp=clamp,
                      huber_th=9.0, interpret=True)
    ot = TBP.act_pass(*(t(x) for x in ins), clamp=clamp, huber_th=9.0)
    exact(np.asarray(oj[1]) > 0.5, ot[1].numpy() > 0.5)
    live = np.asarray(oj[1]) < 0.5
    close(np.asarray(oj[0])[live], ot[0].numpy()[live])
    for a, b in zip(oj[2:], ot[2:]):
        assert np.isfinite(b.numpy()).all()
        close(a, b)


def test_optimize_end_to_end(win):
    ba, dI, pre, bt, dIt, pre_t = win
    rj, sj = JE.optimize(ba, dI, SETTINGS, W, H, max_its=4)
    rt, st = TE.optimize(bt, dIt, SETTINGS, W, H, max_its=4)
    assert int(sj["n_its"]) == int(st["n_its"])
    close(sj["rmse"], st["rmse"], tol=GN_TOL)
    assert abs(int(sj["n_active"]) - int(st["n_active"])) <= 2
    close(rj.state, rt.state, tol=GN_TOL)
    close(rj.T_cw_eval, rt.T_cw_eval, tol=GN_TOL)
    close(rj.c, rt.c, tol=GN_TOL)


def test_marginalize_points_and_frame(win):
    ba, dI, pre, bt, dIt, pre_t = win
    marg = np.asarray((jnp.arange(ba.P) % 4 == 1) & ba.pt_valid)
    mj = JE.marginalize_points(ba, dI, jnp.asarray(marg), SETTINGS, W, H)
    mt = TE.marginalize_points(bt, dIt, t(marg), SETTINGS, W, H)
    exact(mj.pt_valid, mt.pt_valid)
    close(mj.HM, mt.HM)
    close(mj.bM, mt.bM)
    # frame 1 of the window: drop what the frame Schur requires first
    k = 1
    strag = np.asarray(mj.pt_valid & (mj.host == k))
    keep = ~strag[:, None] & (np.arange(ba.F)[None, :] != k)
    mj = mj._replace(pt_valid=mj.pt_valid & ~jnp.asarray(strag),
                     res_exist=mj.res_exist & jnp.asarray(keep))
    mt = mt._replace(pt_valid=mt.pt_valid & ~t(strag),
                     res_exist=mt.res_exist & t(keep))
    fj = JE.marginalize_frame(mj, jnp.int32(k))
    ft = TE.marginalize_frame(mt, k)
    for f in ("frame_valid", "host", "res_exist", "res_state"):
        exact(getattr(fj, f), getattr(ft, f))
    for f in ("HM", "bM", "state", "T_cw_eval", "prior", "exposure"):
        close(getattr(fj, f), getattr(ft, f), tol=GN_TOL)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_linearize_energy_col_matches(win, k):
    """The dying frame's energy column (sos_slam_tpu/ops/ba.py:441), also
    read through a row map (the chain's deferred image compaction), and
    the k-column of the full linearization."""
    ba, dI, pre, bt, dIt, pre_t = win
    ej, sj = JB.linearize_energy_col(ba, pre, dI, jnp.int32(k), SETTINGS,
                                     W, H)
    et, st = TB.linearize_energy_col(bt, pre_t, dIt, k, SETTINGS, W, H)
    exact(sj, st)
    close(ej, et)
    lt = TB.linearize(bt, pre_t, dIt, SETTINGS, W, H)
    exact(lt.new_state[:, k], st)
    close(lt.energy[:, k], et)
    # slot k's image held in another row of a shuffled stack
    perm = np.roll(np.arange(dIt.shape[0]), 1)
    et2, st2 = TB.linearize_energy_col(bt, pre_t, dIt[perm], k, SETTINGS,
                                       W, H, row=int(np.argmax(perm == k)))
    exact(st, st2)
    exact(et, et2)
    e_col, n_col = TB.col_energy(bt, dIt, k, SETTINGS, W, H)
    col = np.asarray(ba.res_exist[:, k] & ba.pt_valid) & (np.asarray(sj) == 0)
    exact(n_col, col.sum())
    close(e_col, np.sum(np.where(col, np.asarray(ej), 0.0)))
