"""The port's immature-point trace and activation against the JAX package:
trace_points with the status machine exactly equal, activate_points (its
passes reduced by K4's plain twin) with the same accepted set and
depths."""

import jax.numpy as jnp
import numpy as np
import pytest

from sos_slam_tpu.ops import trace as JT
from sos_slam_tpu.utils import lie
from sos_slam_tpu_torch.ops import trace as TTR
from tests.test_torch_helpers import close, exact, port_state, t
from tests.test_trace import SETTINGS, W, H, make_points, setup_scene


def _trace_both(imm_j, dI_new, KRKi, Kt, aff):
    a = JT.trace_points(imm_j, dI_new, KRKi, Kt, aff, W, H, SETTINGS)
    b = TTR.trace_points(port_state(TTR.ImmatureState, imm_j), t(dI_new),
                         t(KRKi), t(Kt), t(aff), W, H, SETTINGS)
    return a, b


def _check(a, b):
    exact(a.status, b.status)
    fin = np.isfinite(np.asarray(a.idepth_max))
    exact(fin, np.isfinite(b.idepth_max.numpy()))
    close(np.asarray(a.idepth_min), b.idepth_min.numpy(), tol=1e-3)
    close(np.asarray(a.idepth_max)[fin], b.idepth_max.numpy()[fin], tol=1e-3)
    q = np.asarray(a.quality)
    qf = np.isfinite(q)
    exact(qf, np.isfinite(b.quality.numpy()))
    close(q[qf], b.quality.numpy()[qf], tol=1e-2)


@pytest.fixture(scope="module")
def traced():
    calib, dI_ref, dI_new, idepth_ref, KRKi, Kt = setup_scene()
    imm = make_points(calib, dI_ref)
    aff = jnp.array([[1.0, 0.0]])
    a, b = _trace_both(imm, dI_new, KRKi[None], Kt[None], aff)
    return calib, dI_ref, dI_new, imm, a, b


def test_init_immature_matches(traced):
    calib, dI_ref, _, imm, _, _ = traced
    r = np.random.RandomState(0)
    Np = 64
    u = (r.rand(Np) * (W - 24) + 12).astype(np.float32)
    v = (r.rand(Np) * (H - 24) + 12).astype(np.float32)
    my = (np.arange(Np) % 3).astype(np.int32)
    a = JT.init_immature(jnp.asarray(u), jnp.asarray(v),
                         jnp.zeros(Np, jnp.int32), jnp.asarray(my), dI_ref,
                         SETTINGS, Np)
    b = TTR.init_immature(t(u), t(v), t(np.zeros(Np, np.int32)), t(my),
                          t(dI_ref), SETTINGS, Np)
    for k in ("valid", "host", "status", "my_type"):
        exact(getattr(a, k), getattr(b, k))
    for k in ("color", "weights", "gradH", "energy_th", "quality"):
        close(getattr(a, k), getattr(b, k))


def test_first_trace_status_exact(traced):
    *_, a, b = traced
    assert int(np.sum(np.asarray(a.status) == JT.IPS_GOOD)) > 100
    _check(a, b)


def test_second_trace_status_exact(traced):
    calib, dI_ref, dI_new, imm, a, b = traced
    _, _, dI_new2, _, KRKi2, Kt2 = setup_scene(
        twist=(0.0, 0.05, 0.01, 0.0, 0.0, 0.0))
    a2, b2 = _trace_both(a, dI_new2, KRKi2[None], Kt2[None],
                         jnp.array([[1.0, 0.0]]))
    _check(a2, b2)


@pytest.mark.parametrize("clamp_oob", [False, True])
def test_activate_points_matches(traced, clamp_oob):
    calib, dI_ref, dI_new, imm, a, _ = traced
    F = 2
    dI = jnp.stack([dI_ref, dI_new])
    T_new = lie.se3_exp(jnp.array([0.06, 0, 0, 0, 0, 0], jnp.float32))
    rel = jnp.zeros((F, F, 4, 4))
    rel = rel.at[0, 1].set(lie.se3_inv(T_new)).at[0, 0].set(jnp.eye(4))
    rel = rel.at[1, 1].set(jnp.eye(4)).at[1, 0].set(T_new)
    affLL = jnp.broadcast_to(jnp.array([1.0, 0.0]), (F, F, 2))
    cand = a.valid & (a.status == JT.IPS_GOOD)
    if clamp_oob:   # exercise the OOB and dead-row handling
        cand = cand | (a.valid & (a.status == JT.IPS_OOB))
    args_j = (a, cand, dI, rel[..., :3, :3], rel[..., :3, 3], affLL,
              jnp.array([True, True]), calib.intrinsics(0), W, H, SETTINGS)
    idj, okj, rij = JT.activate_points(*args_j)
    idt, okt, rit = TTR.activate_points(
        port_state(TTR.ImmatureState, a), t(cand), t(dI),
        t(rel[..., :3, :3]), t(rel[..., :3, 3]), t(affLL),
        t(np.array([True, True])), calib.intrinsics(0), W, H, SETTINGS)
    exact(okj, okt)
    exact(rij, rit)
    ok = np.asarray(okj)
    assert ok.sum() > 80
    close(np.asarray(idj)[ok], idt.numpy()[ok])
