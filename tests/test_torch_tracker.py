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
