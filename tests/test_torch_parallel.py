"""The port's point-sharded steps (sos_slam_tpu_torch.parallel) against the
JAX package's sharded steps on a mesh of the same size, and against the
port's own unsharded steps.

The ranks are spawned once for the module, at n = 1 and n = 4 (gloo on
CPU tensors, the kernels' plain twins), on __graft_entry__'s
_tiny_window / _tiny_scene inputs carried across through utils/convert;
and `dryrun_multichip(4, device="cpu")` runs on the port's own dry-run
inputs. Tolerances: 5e-3 on the GN step's states (a full GN step),
2e-4 relative on the energy and energy_th, exact on res_state; the
sharded against the unsharded port step: bit for bit at n = 1, atol and
rtol 1e-4 at n = 4 (tests/test_parallel.py's), with a last shard that
holds no valid point."""

import multiprocessing
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from sos_slam_tpu.parallel import sharded as JS
from sos_slam_tpu.ops import trace as JTR
from sos_slam_tpu_torch.models import energy as TE
from sos_slam_tpu_torch.models import imu as TIM
from sos_slam_tpu_torch.ops import ba as TB
from sos_slam_tpu_torch.ops import trace as TTR
from sos_slam_tpu_torch.ops import tracker as TTK
from sos_slam_tpu_torch.parallel import dryrun as DR
from sos_slam_tpu_torch.parallel import sharded as TS
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import GN_TOL, close, exact, port_state, t

N_IMM = 64      # immature points: 16 a rank at n = 4, as the dry run's
NS = (1, 4)


def _priors(ba, imu, seed=3):
    """The window with a nonzero marginalization prior (HM, bM): a seeded
    SPD matrix, and the same for the VIO prior of `imu`."""
    r = np.random.RandomState(seed)

    def spd(D, s):
        A = r.randn(D, D).astype(np.float32)
        return torch.as_tensor(s * (A @ A.T) / D), \
            torch.as_tensor(0.1 * s * r.randn(D).astype(np.float32))

    HM, bM = spd(ba.HM.shape[0], 1e3)
    out = ba._replace(HM=HM, bM=bM)
    if imu is None:
        return out
    HMi, bMi = spd(imu.HM.shape[0], 1e2)
    return out, imu._replace(HM=HMi, bM=bMi)


def _jax_pool(n):
    key = jax.random.PRNGKey(7)
    return JTR.ImmatureState(
        valid=jnp.ones(n, bool), host=jnp.zeros(n, jnp.int32),
        u=jax.random.uniform(key, (n,)) * (G._W - 20) + 10,
        v=jax.random.uniform(jax.random.fold_in(key, 1), (n,))
        * (G._H - 20) + 10,
        color=jnp.ones((n, 8)) * 0.5, weights=jnp.ones((n, 8)),
        gradH=jnp.tile(jnp.eye(2), (n, 1, 1)),
        energy_th=jnp.full((n,), 1e4), idepth_min=jnp.zeros(n),
        idepth_max=jnp.full((n,), jnp.inf), status=jnp.zeros(n, jnp.int8),
        quality=jnp.full((n,), 10000.0), my_type=jnp.ones(n, jnp.int32))


@pytest.fixture(scope="module")
def run():
    """dryrun_multichip(4, device="cpu"), the port's ranks at n = 1 and
    n = 4 on the JAX inputs, the JAX sharded references and the port's
    unsharded steps. The dry run runs while the JAX inputs are built, the
    ranks while the JAX references compile."""
    from sos_slam_tpu.utils import lie
    box = {}

    def dry():
        try:
            box["res"] = DR.dryrun_multichip(4, "cpu")
        except BaseException as e:      # re-raised in the main thread
            box["err"] = e

    th = threading.Thread(target=dry)
    th.start()
    ba_j, dI_j, settings_j, _ = G._tiny_window(n_frames=3, n_points=96)
    bav_j, dIv_j, settingsv_j, imu_j = G._tiny_window(
        n_frames=5, n_points=96, with_imu=True)
    imm_j = _jax_pool(N_IMM)
    _, pyr_j, tmpls_j, intr, n_levels = G._tiny_scene()
    Ts_j = jnp.stack([
        lie.se3_exp(jnp.array([0.01 * i, 0.0, 0.005 * i, 0.0, 0.0, 0.0]))
        for i in range(4)])

    ba, dI = port_state(TB.BAState, ba_j), t(dI_j)
    bav, dIv = port_state(TB.BAState, bav_j), t(dIv_j)
    imu = port_state(TIM.ImuState, imu_j)
    imm = port_state(TTR.ImmatureState, imm_j)
    pyr = tuple(t(p) for p in pyr_j)
    tmpls = tuple(TTK.LevelTemplate(*(t(a) for a in tl)) for tl in tmpls_j)
    settings = default_settings(weight_imu_dso=0.0)
    settingsv = default_settings(weight_imu_dso=6.0)
    ba_p = _priors(ba, None)
    bav_p, imu_p = _priors(bav, imu)
    eye = torch.eye(4)
    jobs = [
        ("j_gn", "gn", DR.window_inputs(ba, dI, G._W, G._H), settings),
        ("j_gn_prior", "gn", DR.window_inputs(ba_p, dI, G._W, G._H),
         settings),
        ("j_vio", "vio", DR.window_inputs(bav, dIv, G._W, G._H, imu),
         settingsv),
        ("j_vio_prior", "vio", DR.window_inputs(bav_p, dIv, G._W, G._H,
                                                imu_p), settingsv),
        ("j_trace", "trace", DR.trace_inputs(ba, imm, dI[0], eye,
                                             torch.zeros(2), 1.0, G._W,
                                             G._H), settings),
        ("j_track", "track", DR.track_inputs(pyr, tmpls, t(Ts_j), intr),
         settings),
        ("j_layout", "layout", DR.window_inputs(ba, dI, G._W, G._H),
         settings),
    ]
    try:
        ranks = {n: DR.spawn_ranks(n, jobs, "cpu") for n in NS}
        ref = {}
        for n in NS:
            mesh = JS.make_mesh(n)
            ref[n] = dict(
                gn=JS.sharded_gn_step(mesh, ba_j, dI_j, settings_j, G._W,
                                      G._H),
                vio=JS.sharded_vio_gn_step(mesh, bav_j, imu_j, dIv_j,
                                           settingsv_j, G._W, G._H),
                trace=JS.sharded_trace(
                    mesh, ba_j, imm_j, dI_j[0], jnp.eye(4), jnp.zeros(2),
                    jnp.float32(1.0), w=G._W, h=G._H, settings=settings_j),
                track=JS.sharded_track(
                    mesh, pyr_j, tmpls_j, Ts_j, jnp.zeros(2), jnp.zeros(2),
                    jnp.ones(2), intr, n_levels))
        # the ranks run one thread each: so does the unsharded step that
        # n = 1 is held bit for bit to (the VIO KKT solve's LAPACK
        # rounds differently on two threads)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        unsharded = dict(
            j_gn=TE.gn_step(ba, dI, settings, G._W, G._H),
            j_gn_prior=TE.gn_step(ba_p, dI, settings, G._W, G._H),
            j_vio=TE.gn_step_vio(bav, imu, dIv, settingsv, G._W, G._H),
            j_vio_prior=TE.gn_step_vio(bav_p, imu_p, dIv, settingsv, G._W,
                                       G._H))
        torch.set_num_threads(threads)
        res = {n: r.join() for n, r in ranks.items()}
    finally:
        th.join(DR.JOIN_S)
    if "err" in box:
        raise box["err"]
    return dict(res=res, dry=box["res"], ref=ref, unsharded=unsharded,
                ba=ba)


@pytest.mark.parametrize("n", NS)
def test_gn_step_matches_jax_sharded(run, n):
    ba_j, e_j = run["ref"][n]["gn"]
    out = run["res"][n]["j_gn"][0]
    close(ba_j.state, out["ba.state"], tol=GN_TOL)
    close(ba_j.idepth, out["ba.idepth"], tol=GN_TOL)
    close(ba_j.energy_th, out["ba.energy_th"])
    close(e_j, out["energy"])
    exact(ba_j.res_state, out["ba.res_state"])


@pytest.mark.parametrize("n", NS)
def test_vio_step_matches_jax_sharded(run, n):
    ba_j, imu_j, e_j = run["ref"][n]["vio"]
    out = run["res"][n]["j_vio"][0]
    close(ba_j.state, out["ba.state"], tol=GN_TOL)
    close(imu_j.state, out["imu.state"], tol=GN_TOL)
    close(imu_j.scale, out["imu.scale"], tol=GN_TOL)
    close(ba_j.energy_th, out["ba.energy_th"])
    close(e_j, out["energy"])
    exact(ba_j.res_state, out["ba.res_state"])


_STEP_FIELDS = ("ba.state", "ba.c", "ba.idepth", "ba.idepth_zero",
                "ba.energy_th", "energy")


@pytest.mark.parametrize("job", ["j_gn", "j_gn_prior", "j_vio",
                                 "j_vio_prior"])
@pytest.mark.parametrize("n", NS)
def test_sharded_step_matches_unsharded(run, n, job):
    """n = 1 bit for bit the port's unsharded step; n = 4 within 1e-4
    (the last shard has no valid point). The _prior jobs carry a nonzero
    marginalization prior (HM, bM; the VIO prior of the IMU state) beside
    the frame and point priors: were any added on every rank, n = 4 would
    count it four times."""
    un = run["unsharded"][job]
    out = run["res"][n][job][0]
    ba2 = un[0]
    got = {f: getattr(ba2, f[3:]) for f in _STEP_FIELDS[:-1]}
    got["energy"] = un[-1]
    if job.startswith("j_vio"):
        got["imu.state"], got["imu.scale"] = un[1].state, un[1].scale
    for k, v in got.items():
        if n == 1:
            assert v.numpy().tobytes() == out[k].tobytes(), k
        else:
            np.testing.assert_allclose(out[k], v.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    exact(ba2.res_state, out["ba.res_state"])
    if n == 4:
        assert not out["ba.pt_valid"][96:].any()


@pytest.mark.parametrize("n", NS)
def test_trace_matches_jax_sharded(run, n):
    imm_j = run["ref"][n]["trace"]
    out = run["res"][n]["j_trace"][0]
    for f in ("u", "v", "idepth_min", "idepth_max", "quality", "energy_th",
              "gradH"):
        a = np.asarray(getattr(imm_j, f))
        b = out[f"imm.{f}"]
        exact(np.isfinite(a), np.isfinite(b))
        close(np.where(np.isfinite(a), a, 0), np.where(np.isfinite(b), b, 0))
    exact(imm_j.status, out["imm.status"])
    exact(imm_j.valid, out["imm.valid"])


@pytest.mark.parametrize("n", NS)
def test_track_matches_jax_sharded(run, n):
    ref = run["ref"][n]["track"]
    out = run["res"][n]["j_track"][0]
    close(ref["T"], out["T"], tol=1e-4)
    exact(ref["good"], out["good"])
    assert out["good"].any()


def test_shard_layout(run):
    """At n = 4: rank r holds rows [32 r, 32 r + 32) of every point field
    and every frame field whole; the last rank's rows hold no valid point;
    a pool of 127 rows does not divide and raises."""
    ba = run["ba"]
    outs = run["res"][4]["j_layout"]
    for r, out in enumerate(outs):
        for f in TS._POINT_FIELDS:
            exact(getattr(ba, f).numpy()[32 * r:32 * r + 32],
                  out[f"shard.{f}"])
        for f in set(TB.BAState._fields) - set(TS._POINT_FIELDS):
            exact(getattr(ba, f).numpy(), out[f"shard.{f}"])
        assert bool(out["odd_raised"])
    assert not outs[3]["shard.pt_valid"].any()
    assert not bool(run["res"][1]["j_layout"][0]["odd_raised"])


@pytest.mark.parametrize("n", NS)
def test_every_rank_returns_the_same(run, n):
    """The gathered outputs hold the same bits on every rank (the solve is
    replicated, and each step checks that x agrees on every rank), and
    the steps went through the collectives."""
    res = run["res"][n]
    DR.same_on_every_rank(res, [k for k in res if k != "j_layout"])
    assert min(int(out["comm_calls"]) for out in res["j_gn"]) > 0


def test_dryrun_multichip_completed(run):
    """dryrun_multichip(4, device="cpu") ran its five jobs on 4 ranks: the
    BA and VIO energies are finite, a hypothesis converged, the scaling
    windows were timed, and no rank process is left."""
    res = run["dry"]
    assert np.isfinite(res["gn"][0]["energy"])
    assert np.isfinite(res["vio"][0]["imu.state"]).all()
    assert res["track"][0]["good"].any()
    sc = res["scale"][0]
    assert all(sc[f"ms_{nd}_{w}"] > 0 for nd in (1, 4) for w in range(3))
    assert not multiprocessing.active_children()


def test_make_mesh_refuses_without_ranks():
    with pytest.raises(RuntimeError, match="no process group"):
        TS.make_mesh(4, device="cpu")


def test_entry_matches_jax():
    fn_j, args_j = G.entry()
    fn_t, args_t = DR.entry(device="cpu")
    close(np.asarray(jax.jit(fn_j)(*args_j)), fn_t(*args_t), tol=1e-4)


@pytest.mark.parametrize("with_imu", [False, True])
def test_tiny_window_matches_jax(with_imu):
    kw = dict(n_frames=5 if with_imu else 3, n_points=96, with_imu=with_imu)
    ba_j, dI_j, _, imu_j = G._tiny_window(**kw)
    ba_t, dI_t, _, imu_t = DR.tiny_window(device="cpu", **kw)
    for f in TB.BAState._fields:
        a, b = np.asarray(getattr(ba_j, f)), getattr(ba_t, f).numpy()
        if a.dtype.kind in "biu":
            exact(a, b)
        else:
            close(a, b, tol=1e-6)
    close(dI_j, dI_t, tol=1e-6)
    if with_imu:
        for f in ("state", "vel", "acc", "gyro", "ts", "timestamps",
                  "scale"):
            close(getattr(imu_j, f), getattr(imu_t, f), tol=1e-6)
        exact(imu_j.imu_valid, imu_t.imu_valid)
        exact(imu_j.bias_valid, imu_t.bias_valid)
        exact(imu_j.spline_valid, imu_t.spline_valid)
