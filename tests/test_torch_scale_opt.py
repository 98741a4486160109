"""The port's stereo 1-DoF scale solve (ops/scale_opt.py) against the JAX
package.

Units: the stereo pair of tests/test_scale_opt.py::make_stereo (the left
template warped into the right pyramid at a 0.11 m baseline) carried
across as numpy. `res_and_hb_scale` at every level, several scales and
cutoffs (floats at 2e-4, counts exact); `optimize_scale` from one start
and the seven-guess batch, each guess against the JAX package's vmap lane
(whole LM loops: 5e-3, the tolerance of a whole GN solve). The
stereo-only FullSystem end to end is tests/test_torch_stereo.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_slam_tpu.ops import scale_opt as JSO
from sos_slam_tpu_torch.ops import scale_opt as TSO
from sos_slam_tpu_torch.ops import tracker as TK
from tests.test_scale_opt import make_stereo
from tests.test_torch_helpers import GN_TOL, close, exact, port_state, t


@pytest.fixture(scope="module", params=[1.0, 2.0])
def pair(request):
    """(JAX inputs, port inputs) of the stereo pair at a map scale."""
    pyr_r, tmpls, R01, t01, intr, nl = make_stereo(map_scale=request.param)
    port = (tuple(t(p) for p in pyr_r),
            tuple(port_state(TK.LevelTemplate, tm) for tm in tmpls),
            t(R01), t(t01), intr, nl)
    return (pyr_r, tmpls, R01, t01, intr, nl), port


def test_res_and_hb_scale(pair):
    (pyr_r, tmpls, R01, t01, intr, nl), (pr, tm, R, tt, _, _) = pair
    scales = np.array([0.5, 0.9, 1.0, 1.7, 2.0, 4.0], np.float32)
    for cutoff in (20.0, 80.0):
        for lvl in range(nl):
            ot = TSO.res_and_hb_scale(pr[lvl], tm[lvl], torch.as_tensor(
                scales), R, tt, intr[lvl], intr[lvl], torch.full(
                    (len(scales),), cutoff), 9.0)
            for g, s in enumerate(scales):
                oj = JSO.res_and_hb_scale(
                    pyr_r[lvl], tmpls[lvl], jnp.float32(s), R01, t01,
                    intr[lvl], intr[lvl], jnp.float32(cutoff), 9.0)
                for k in ("num_in", "num_sat"):
                    exact(oj[k], ot[k][g])
                for k in ("E", "H", "b"):
                    close(oj[k], ot[k][g])


def test_optimize_scale(pair):
    (pyr_r, tmpls, R01, t01, intr, nl), (pr, tm, R, tt, _, _) = pair
    sj, ej = JSO.optimize_scale(pyr_r, tmpls, jnp.float32(0.7), R01, t01,
                                intr, intr, nl)
    st, et = TSO.optimize_scale(pr, tm, torch.tensor([0.7]), R, tt, intr,
                                intr, nl)
    close(sj, st[0], tol=GN_TOL)
    close(ej, et[0], tol=GN_TOL)


def test_multi_guess_lanes(pair):
    """The seven guesses in one batch: every lane follows the JAX
    package's vmap lane (both while loops and the per-level repeat run
    until every lane is done there), and the pick agrees."""
    (pyr_r, tmpls, R01, t01, intr, nl), (pr, tm, R, tt, _, _) = pair
    guesses = jnp.asarray(JSO.SCALE_GUESSES)
    sj, ej = jax.vmap(lambda s0: JSO.optimize_scale(
        pyr_r, tmpls, s0, R01, t01, intr, intr, nl))(guesses)
    st, et = TSO.optimize_scale(pr, tm, torch.tensor(TSO.SCALE_GUESSES), R,
                                tt, intr, intr, nl)
    close(sj, st, tol=GN_TOL)
    close(ej, et, tol=GN_TOL)
    bj, bej = JSO.optimize_scale_multi_guess(pyr_r, tmpls, R01, t01, intr,
                                             intr, nl)
    bt, bet = TSO.optimize_scale_multi_guess(pr, tm, R, tt, intr, intr, nl)
    close(bj, bt, tol=GN_TOL)
    close(bej, bet, tol=GN_TOL)
