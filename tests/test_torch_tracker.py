"""The port's coarse tracker against sos_slam_tpu.ops.tracker.

The port's counterpart of __graft_entry__.entry() — one multi-level
track_newest_coarse on the _tiny_scene — gives the JAX pose; the batched
track_hypotheses matches the JAX vmap lane by lane."""

import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as G
from sos_slam_tpu.ops import tracker as JT
from sos_slam_tpu_torch.ops import tracker as TT
from tests.test_torch_helpers import close, exact, t


@pytest.fixture(scope="module")
def scene():
    calib, pyr_new, tmpls, intr, n_levels = G._tiny_scene()
    pyr_t = tuple(t(p) for p in pyr_new)
    tm_t = tuple(TT.LevelTemplate(*(t(a) for a in tl)) for tl in tmpls)
    return calib, pyr_new, tmpls, pyr_t, tm_t, intr, n_levels


def test_entry_track_matches_jax(scene):
    _, pyr_new, tmpls, pyr_t, tm_t, intr, n_levels = scene
    fn, args = G.entry()
    T_j = np.asarray(fn(*args))
    out = TT.track_newest_coarse(
        pyr_t, tm_t, t(np.eye(4, dtype=np.float32))[None], t(np.zeros(2)),
        t(np.zeros(2)), t(np.ones(2)), t(np.full(6, np.nan)), intr, n_levels)
    close(T_j, out["T"][0], tol=1e-4)
    full = JT.track_newest_coarse(
        pyr_new, tmpls, jnp.eye(4), jnp.zeros(2), jnp.zeros(2), jnp.ones(2),
        jnp.full((6,), jnp.nan), intr, n_levels)
    close(full["residuals"], out["residuals"][0], tol=1e-3)
    close(full["flow"], out["flow"][0], tol=1e-3)
    exact(full["good"], out["good"][0])


def test_hypotheses_batch_matches_vmap(scene):
    _, pyr_new, tmpls, pyr_t, tm_t, intr, n_levels = scene
    from sos_slam_tpu.utils import lie
    xis = np.array([[0.0] * 6, [0.01, 0, 0, 0, 0.002, 0],
                    [0, 0.02, 0.01, 0.003, 0, 0.001],
                    [0.03, -0.01, 0.0, 0.0, 0.0, 0.004]], np.float32)
    T0 = np.asarray(lie.se3_exp(jnp.asarray(xis)))
    for min_level in (0, n_levels - 1):
        oj = JT.track_hypotheses(pyr_new, tmpls, jnp.asarray(T0),
                                 jnp.zeros(2), jnp.zeros(2), jnp.ones(2),
                                 intr, n_levels, min_level=min_level)
        ot = TT.track_hypotheses(pyr_t, tm_t, t(T0), t(np.zeros(2)),
                                 t(np.zeros(2)), t(np.ones(2)), intr,
                                 n_levels, min_level=min_level)
        close(oj["T"], ot["T"], tol=1e-4)
        close(oj["aff"], ot["aff"], tol=1e-3)
        exact(oj["good"], ot["good"])
        close(np.nan_to_num(np.asarray(oj["residuals"]), nan=-1),
              np.nan_to_num(ot["residuals"].numpy(), nan=-1), tol=1e-3)


def test_res_and_hb_and_solve(scene):
    _, pyr_new, tmpls, pyr_t, tm_t, intr, n_levels = scene
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.01, -0.02, 0.005]
    ab = np.array([1.02, 3.0], np.float32)
    rj = JT.res_and_hb(pyr_new[0], tmpls[0], jnp.asarray(T), jnp.asarray(ab),
                       jnp.float32(0.5), intr[0], jnp.float32(20.0), 9.0,
                       compute_flow=True)
    rt = TT.res_and_hb(pyr_t[0], tm_t[0], t(T)[None], t(ab)[None],
                       t(np.float32(0.5)), intr[0], t(np.float32([20.0])),
                       9.0, compute_flow=True)
    for k in ("E", "H", "b", "flow_t", "flow_rt"):
        close(rj[k], rt[k][0])
    for k in ("num_in", "num_sat"):
        exact(rj[k], rt[k][0])
    sj, ij = JT._solve_damped(rj["H"], rj["b"], jnp.float32(0.01), False,
                              True)
    st, it = TT._solve_damped(rt["H"], rt["b"], t(np.float32([0.01])),
                              False, True)
    close(sj, st[0], tol=5e-3)


# ---------------------------------------------------------------------------
# K5 (csrc/tracker.cu): on the CPU its wrappers run their plain twins
# ---------------------------------------------------------------------------
def _k5_lanes(K=3):
    import torch
    from sos_slam_tpu_torch.utils import lie
    xi = torch.zeros(K, 6)
    xi[:, 0] = 0.01 * torch.arange(K)
    xi[:, 4] = 0.002
    aff = torch.tensor([[0.01, 2.0]]).expand(K, 2).contiguous()
    return lie.se3_exp(xi), aff, torch.full((K,), 20.0)


def test_k5_cpu_wrappers_take_the_plain_twins(scene):
    """On CPU tensors `res_and_hb`, `track_res`, `track_step` and
    `tracker_trip` run the plain twins (the record is the plain dict's
    bits), make no scratch and count no K5 launch."""
    import torch
    _, _, _, pyr_t, tm_t, intr, _ = scene
    T, aff, cut = _k5_lanes()
    ref_aff, exposures = t(np.float32([0.02, 1.5])), t(np.float32([1, 1.1]))
    lv = TT.level(pyr_t[0], tm_t[0], ref_aff, exposures, intr[0], 9.0, 3)
    assert lv.partials is None and lv.tickets is None
    before = TT.tracker_trip.launches
    rec = TT.track_res(lv, T, aff, cut, flow=True)
    ab = TT.aff_from_to(exposures[0], exposures[1], ref_aff[:, None], aff.T).T
    want = TT.res_and_hb_plain(pyr_t[0], tm_t[0], T, ab, ref_aff[1], intr[0],
                               cut, 9.0, compute_flow=True)
    got = TT.res_and_hb(pyr_t[0], tm_t[0], T, ab, ref_aff[1], intr[0], cut,
                        9.0, compute_flow=True)
    for k in want:
        exact(got[k], want[k])
    for col, k in ((TT.R_E, "E"), (TT.R_IN, "num_in"), (TT.R_SAT, "num_sat"),
                   (TT.R_FT, "flow_t"), (TT.R_FRT, "flow_rt")):
        exact(rec[:, col], want[k].to(torch.float32))
    exact(rec[:, TT.R_H:TT.R_H + 64], want["H"].reshape(3, 64))
    exact(rec[:, TT.R_B:TT.R_B + 8], want["b"])
    lm = TT.LM(torch.empty(3, TT.ST), torch.empty(3, TT.TRI),
               torch.empty(1, dtype=torch.bool))
    TT.track_step(TT.OPEN, rec, lm, 10, False, False, T, aff)
    exact(lm.view("T"), T)
    exact(lm.view("H"), want["H"])
    assert bool(lm.go)
    step, inc = TT._solve_damped(want["H"], want["b"],
                                 torch.full((3,), 0.01), False, False)
    exact(lm.trial()[0], TT.lie.se3_exp(step[:, :6]) @ T)
    exact(lm.tri[:, TT.X_INC], torch.linalg.norm(inc, dim=-1))
    TT.tracker_trip(lv, lm, cut, 10, False, False)
    exact(lm.view("it"), torch.ones(3))
    assert TT.tracker_trip.launches == before


def test_k5_takes_no_other_device():
    """A tensor neither on the CPU nor on a card reaches the kernel's
    wrapper, which refuses it: no fallback to the plain twins."""
    import torch
    meta = torch.device("meta")
    tm = TT.LevelTemplate(*(torch.empty(64, device=meta) for _ in range(4)),
                          torch.empty(64, dtype=torch.bool, device=meta))
    T = torch.empty(2, 4, 4, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        TT.res_and_hb(torch.empty(8, 8, 3, device=meta), tm, T,
                      torch.empty(2, 2, device=meta),
                      torch.empty((), device=meta), (1.0, 1.0, 4.0, 4.0),
                      torch.empty(2, device=meta), 9.0)
    lm = TT.LM(torch.empty(2, TT.ST, device=meta),
               torch.empty(2, TT.TRI, device=meta),
               torch.empty(1, dtype=torch.bool, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        TT.track_step(TT.TRIP, torch.empty(2, TT.REC, device=meta), lm, 10,
                      False, False)


def test_k5_is_a_launch_counter():
    """K5's counter sits with K1-K4 in `control.counters()` (the conditional
    nodes' credit and the graphs' per-replay counts take it)."""
    from sos_slam_tpu_torch.ops import control
    names = [n for n, _ in control.counters()]
    assert names == ["K1", "K2", "K3", "K4", "K5"]
    assert dict(control.counters())["K5"] is TT.tracker_trip
    assert isinstance(TT.tracker_trip.launches, int)
