"""The VIO keyframe chain with its decisions on the device
(models/chain_graph.py `kf_chain_vio_body`), the visual-inertial BA's
bounded form, the device-slot VIO frame marginalization and the stereo
scale solve's bounded forms on the CPU, against the eager forms they
replace and against the JAX package's `_kf_chain_vio_jit` and
`optimize_scale`.

The stereo + VIO scene of tests/test_torch_stereo_vio.py (256x192, 20
frames, F = 8, P = 512; the port's own renderer) runs once through the
eager fused path pipelined at depth 3, recording each VIO keyframe
chain's inputs and outputs; the same chains then go through the
ChainGraph's bodies, which on a card are captured as CUDA graphs and here
run as they are. Tolerances against the JAX package
(tests/test_torch_helpers.py): flags, flagged slots, masks, counts, slots
and the BA's step count exact; after the chain's BA (a full GN step and
more) float fields at 5e-3; 2e-4 where no GN step lies between (the new
traces' pixels, the image stack, the activation distance). The port
repairs the JAX package's VIO frame fold (ROADMAP Queue 3: a float64
fold over the block's live subspace, where the JAX package's f32 inverse
leaves the prior NaN): the comparison with `_kf_chain_vio_jit` leaves out
the fields that fold writes (the IMU prior HM and bM)."""

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models import chain_graph as CG
from sos_slam_tpu_torch.models import energy as E
from sos_slam_tpu_torch.models import fused_graph as FU
from sos_slam_tpu_torch.models.full_system import FullSystem, StereoCalib
from sos_slam_tpu_torch.ops import scale_opt as SO
from sos_slam_tpu_torch.ops.image import build_pyramid
from sos_slam_tpu_torch.utils import rng
from sos_slam_tpu_torch.utils import synthetic as TSY
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import GN_TOL, close, exact, no_host_reads

torch.set_num_threads(2)

W, H = 256, 192
N_FRAMES, FRAME_DT = 20, 0.1
SETTINGS_KW = dict(max_window_frames=8, max_points=512, max_immature=1024,
                   max_track_pts=4096, desired_point_density=400.0,
                   desired_immature_density=400.0, weight_imu_dso=6.0,
                   min_g_imu=10)


def _settings(mod=None, stereo=True):
    mod = default_settings if mod is None else mod.default_settings
    return mod(scale_opt_thres=12.0 if stereo else -1.0, **SETTINGS_KW)


def _scene():
    T_lr, T_rl = TSY.stereo_T_lr()
    calib = TSY.default_calib(W, H)
    poses = np.stack([TSY.cubic_pose(i * FRAME_DT)
                      for i in range(N_FRAMES)])
    left = [TSY.render_plane(calib, torch.as_tensor(p, dtype=torch.float32),
                             2.0)[0] for p in poses]
    right = [TSY.render_plane(calib, torch.as_tensor(
        (p @ T_rl).astype(np.float32)), 2.0)[0] for p in poses]
    imu = [TSY.imu_between(TSY.cubic_pose, TSY.cubic_acc,
                           (i - 1) * FRAME_DT, i * FRAME_DT,
                           TSY.CUBIC_BIAS_G) for i in range(N_FRAMES)]
    return calib, T_lr, left, right, imu


def _system(calib, T_lr, stereo=True):
    return FullSystem(calib, _settings(stereo=stereo),
                      stereo=StereoCalib(T_lr=T_lr, calib_right=calib)
                      if stereo else None, device="cpu")


def _drive(scene, graph=False, record=None):
    """The scene through the fused path pipelined at depth 3: the eager
    chain, or the fused frame graph's body (`graph`, models/
    fused_graph.py: the VIO chain's body under `control.cond(need_kf)`
    inside the frame). `record`: a list that gets
    each eager VIO chain's arguments and result."""
    calib, T_lr, left, right, imu = scene
    fs = _system(calib, T_lr)
    fs.pipeline, fs.pipeline_depth = True, 3
    if graph:
        fs.fused_graph = FU.FusedFrameGraph(fs)
    if record is not None:
        chain = fs._kf_chain_vio

        def recorded(*a, **kw):
            out = chain(*a, **kw)
            record.append((a, kw, out))
            return out
        fs._kf_chain_vio = recorded
    for i in range(N_FRAMES):
        fs.add_active_frame(left[i], timestamp=i * FRAME_DT, frame_id=i,
                            image_right=right[i], imu_samples=imu[i])
        assert not (fs.is_lost or fs.init_failed)
    fs.finish_pending()
    if record is not None:
        del fs._kf_chain_vio
    return fs


@pytest.fixture(scope="module")
def runs():
    scene = _scene()
    calls = []
    eager = _drive(scene, record=calls)
    return dict(scene=scene, eager=eager, calls=calls,
                graph=_drive(scene, graph=True))


def _call(calls):
    """The last recorded VIO chain (the one with the fullest window)."""
    assert calls, "no fused VIO keyframe chain ran"
    return calls[-1][0], calls[-1][2]


def _same_bits(a, b):
    """Bit for bit, NaN where the other is NaN (the vision prior of a VIO
    window is NaN in every form: the VIO fold does not use it)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        assert bool(torch.equal(torch.isnan(a), torch.isnan(b)))
        a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
    exact(a, b)


def _same_states(x, y):
    for a, b in zip(x, y):
        _same_bits(a, b)


# ---------------------------------------------------------------------------
# (a) the visual-inertial BA's bounded form against the early-exit loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["max_its1", "max_its6", "early_break"])
def test_bounded_optimize_vio_equals_early_exit(runs, case):
    fs = runs["eager"]
    settings = fs.settings
    ba, imu = fs.ba, fs.imu
    max_its = 1 if case == "max_its1" else 6
    if case == "early_break":
        # steps small enough to break after the first: the loop leaves
        # before its bound
        settings = default_settings(scale_opt_thres=12.0,
                                    th_opt_iterations=1e9, **SETTINGS_KW)
    else:
        g = torch.Generator().manual_seed(3)
        ba = ba._replace(idepth=ba.idepth * (1.0 + 0.05 * torch.randn(
            ba.idepth.shape, generator=g)))

    def opt(bounded):
        return E.optimize_vio(ba, imu, fs.dI, settings, W, H,
                              max_its=max_its,
                              min_its=settings.min_opt_iterations,
                              bounded=bounded)
    ba_e, imu_e, st_e = opt(False)
    ba_b, imu_b, st_b = opt(True)
    _same_states(ba_e, ba_b)
    _same_states(imu_e, imu_b)
    for k in ("energy", "rmse", "n_active", "is_lost", "HdiF"):
        _same_bits(st_e[k], st_b[k])
    assert int(st_b["n_its"]) == st_e["n_its"]
    want = dict(max_its1=(1, 1), max_its6=(2, 6), early_break=(1, 1))[case]
    assert want[0] <= st_e["n_its"] <= want[1], st_e["n_its"]
    if case == "early_break":
        assert st_e["n_its"] < max_its


# ---------------------------------------------------------------------------
# (b) the VIO frame marginalization with a device slot
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spline", [True, False])
@pytest.mark.parametrize("where", ["first", "middle", "newest"])
def test_marginalize_frame_vio_device_slot(runs, where, spline):
    fs = runs["eager"]
    n = int(torch.sum(fs.ba.frame_valid))
    k = dict(first=0, middle=n // 2, newest=n - 1)[where]
    sv = fs.imu.spline_valid.clone()
    sv[k] = spline
    imu = fs.imu._replace(spline_valid=sv)
    for jax_form in (False, True):
        ba_i, imu_i = E.marginalize_frame_vio(fs.ba, imu, k, fs.settings,
                                              jax_form=jax_form)
        with no_host_reads():
            ba_d, imu_d = E.marginalize_frame_vio(
                fs.ba, imu, torch.full((), k, dtype=torch.int64),
                fs.settings, jax_form=jax_form)
        _same_states(ba_i, ba_d)
        _same_states(imu_i, imu_d)
        assert int(torch.sum(ba_d.frame_valid)) == n - 1
        if not jax_form:
            assert bool(torch.isfinite(imu_d.HM).all())


def _marg_frames_host(fs, ba, imm, imu, dI, host_out, ks):
    """The VIO frame marginalizations with the flagged slots read on the
    host: each slot in turn, the slot -> row map and the per-host counts
    as lists, then one compaction."""
    F = ba.F
    dimap = list(range(F))
    for k in ks:
        ba, imm, imu = fs._marg_frame(ba, imm, imu, k)
        dimap = dimap[:k] + dimap[k + 1:] + [dimap[k]]
        host_out = torch.cat([host_out[:k], host_out[k + 1:],
                              torch.zeros_like(host_out[:1])])
    live = torch.arange(F) < torch.sum(ba.frame_valid)
    dI = torch.where(live[:, None, None, None], dI[torch.tensor(dimap)],
                     torch.zeros_like(dI))
    return ba, imm, imu, dI, host_out


def test_marg_frames_vio_equals_host_loop(runs):
    """`marg_frames(imu=)` (each of the MAX_MARG_FRAMES slots folded on
    its clamped device slot, selected field by field; reads nothing back)
    against the flagged slots marginalized one by one on the host, bit
    for bit on the window, the pool, the IMU state, the image stack and
    the per-host counts."""
    fs = runs["eager"]
    n = int(torch.sum(fs.ba.frame_valid))
    ks = [n - 2, 1]
    marg_ks = torch.tensor(ks + [-1] * (CG.MAX_MARG_FRAMES - len(ks)))
    host_out = torch.arange(fs.F, dtype=torch.int64) * 3
    with no_host_reads():
        ba, imm, imu, dI, ho, _ = CG.marg_frames(fs, fs.ba, fs.imm, fs.dI,
                                                 host_out, marg_ks,
                                                 imu=fs.imu)
    ref = _marg_frames_host(fs, fs.ba, fs.imm, fs.imu, fs.dI, host_out, ks)
    assert int(torch.sum(ba.frame_valid)) == n - 2
    for x, y in zip((ba, imm, imu), ref[:3]):
        _same_states(x, y)
    _same_bits(dI, ref[3])
    exact(ho, ref[4])


# ---------------------------------------------------------------------------
# (c) the stereo scale solve's bounded forms
# ---------------------------------------------------------------------------
def _scale_inputs(runs):
    """The last recorded chain's template, right image and scale state."""
    fs = runs["eager"]
    a, out = _call(runs["calls"])
    right, scale_state = a[13], a[11]
    return fs, out["state"]["templates"], right, scale_state


@pytest.mark.parametrize("branch", ["trapped", "multi_guess"])
def test_bounded_scale_solve_equals_early_exit(runs, branch):
    """The scale LM's bounded form against the eager form, bit for bit, in
    both of `ops/control.py`'s plain twins: the one a card runs outside a
    capture (every loop to its bound, every repeat; under the host-read
    guard) and the CPU's (the loops leave, the repeat is skipped, where
    the conditional nodes would); then `_scale_solve` with the branch
    chosen by `control.cond(trapped)` against the eager one branch, on
    the trapped and the untrapped scale state."""
    fs, tmpl, right, (s_cur, trapped, fails) = _scale_inputs(runs)
    pyr_r = tuple(build_pyramid(right, fs.n_levels)[0])
    R01, t01, intr1 = fs._lr
    args = (R01, t01, fs._intr, intr1, fs.n_levels)
    SO.TRIPS.clear()
    if branch == "trapped":
        def solve(bounded):
            return SO.scale_lm(pyr_r, tmpl, s_cur.reshape(1), *args,
                               bounded=bounded)
    else:
        def solve(bounded):
            return SO.multi_guess(pyr_r, tmpl, *args, bounded=bounded)
    eager = solve(False)
    assert SO.TRIPS, "the eager form counts its trips"
    with no_host_reads():
        full = solve(True)
    node_like = solve(True)
    for x, y, z in zip(eager, full, node_like):
        _same_bits(x, y)
        _same_bits(x, z)

    for trapped_v in (True, False):
        kf = CG.keyframe_inputs(fs, right, (
            s_cur, torch.full((), trapped_v), fails))
        got_e = fs._scale_solve(tmpl, kf, False)
        with no_host_reads():
            got_b = fs._scale_solve(tmpl, kf, True)
        for x, y in zip(got_e, got_b):
            _same_bits(x, y)


def test_scale_solve_matches_jax(runs):
    """The bounded trapped and multi-guess solves against the JAX
    package's optimize_scale / optimize_scale_multi_guess on the same
    template and right pyramid, at a full solve's tolerance."""
    import jax.numpy as jnp
    from sos_slam_tpu.ops import scale_opt as JSO
    from sos_slam_tpu.ops import tracker as JTK
    fs, tmpl, right, (s_cur, _, _) = _scale_inputs(runs)
    nl = fs.n_levels
    pyr_r = tuple(build_pyramid(right, nl)[0])
    R01, t01, intr1 = fs._lr
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    tj = tuple(JTK.LevelTemplate(**{k: j(v) for k, v in tp._asdict().items()})
               for tp in tmpl)
    pj = tuple(j(p) for p in pyr_r)
    intr = tuple(fs._intr)
    sj, ej = JSO.optimize_scale(pj, tj, jnp.float32(float(s_cur)), j(R01),
                                j(t01), intr, tuple(intr1), nl)
    st, et = SO.scale_lm(pyr_r, tmpl, s_cur.reshape(1), R01, t01, intr,
                         intr1, nl, bounded=True)
    close(sj, st[0], GN_TOL)
    close(ej, et[0], GN_TOL)
    bj, bej = JSO.optimize_scale_multi_guess(pj, tj, j(R01), j(t01), intr,
                                             tuple(intr1), nl)
    bt, bet = SO.multi_guess(pyr_r, tmpl, R01, t01, intr, intr1, nl,
                             bounded=True)
    close(bj, bt, GN_TOL)
    close(bej, bet, GN_TOL)


# ---------------------------------------------------------------------------
# (d) the chain against the JAX package's _kf_chain_vio_jit
# ---------------------------------------------------------------------------
def _jax_state(mod_cls, port_state):
    import jax.numpy as jnp
    return mod_cls(**{k: jnp.asarray(v.numpy())
                      for k, v in port_state._asdict().items()})


def test_chain_matches_jax(runs):
    import jax.numpy as jnp
    from sos_slam_tpu.models import full_system as JFS
    from sos_slam_tpu.models import imu as JIM
    from sos_slam_tpu.ops import ba as JB
    from sos_slam_tpu.ops import trace as JTR
    from sos_slam_tpu.ops import tracker as JTK
    from sos_slam_tpu.utils import config as JC
    settings = _settings(JC)
    fs = runs["eager"]
    a, ref = _call(runs["calls"])
    (st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out, n_kf,
     shell_id, max_its, scale_state, pot, right, staged, timestamp) = a
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    out_step = dict(aff=j(aff_new)[None],
                    residuals=jnp.zeros((1, 6), jnp.float32))
    eye = jnp.eye(4, dtype=jnp.float32)
    s_cur, trapped, fails = scale_state
    R01, t01, intr1 = fs._lr
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[:3, :3], T_lr[:3, 3] = R01.numpy(), t01.numpy()
    state, back, _ = JFS._kf_chain_vio_jit(
        jnp.asarray(True), _jax_state(JB.BAState, st["ba"]),
        _jax_state(JIM.ImuState, st["imu"]),
        _jax_state(JTR.ImmatureState, imm), j(st["dI"]),
        tuple(j(p) for p in pyr), out_step, j(T_cw_new), j(exposure),
        j(fs._prior_row(first=False)), j(st["min_act"]),
        jnp.asarray(host_out.numpy(), jnp.int32), np.int32(n_kf),
        jnp.asarray(st["key"]), np.int32(shell_id),
        tuple(jnp.asarray(x.numpy(), x.numpy().dtype if i > 1
                          else jnp.int32) for i, x in enumerate(stats)),
        j(st["HdiF"]),
        tuple(_jax_state(JTK.LevelTemplate, tp) for tp in st["templates"]),
        tuple(j(x) for x in st["pc_l0"]),
        j(staged["acc"]), j(staged["gyro"]), j(staged["ts"]),
        j(staged["valid"]), j(timestamp), jnp.float32(-1e9),
        eye, jnp.zeros(2), jnp.float32(1), eye, jnp.asarray(False),
        jnp.float32(1.0), j(right), jnp.asarray(True), jnp.asarray(T_lr),
        (j(s_cur), j(trapped), jnp.int32(int(fails))),
        max_its, settings.min_opt_iterations, fs.tmpl_sizes, pot,
        min(settings.max_immature, imm.u.shape[0]), settings, W, H,
        stereo=(tuple(fs._intr), tuple(intr1)))
    ba3, imu5, imm3, dI3, min_act, HdiF, templates, _ = state
    (stats5, T_cw_all, affs, marg, died, n_have, marg_ks, _, _, host_o,
     slot, scale_o, bg) = back
    got = ref["state"]
    # exact: the flags, slots, counts, masks and the BA's step count
    exact(np.asarray(marg_ks), ref["marg_ks"])
    exact(np.asarray(slot), ref["slot"])
    exact(np.asarray(n_have), ref["n_have"])
    exact(np.asarray(host_o), ref["host_out"])
    exact(np.asarray(stats5[2]), ref["ba_stats"]["n_its"])
    exact(np.asarray(stats5[3]), ref["ba_stats"]["n_active"])
    for k in ("frame_valid", "pt_valid", "host", "res_exist", "res_state"):
        exact(np.asarray(getattr(ba3, k)), getattr(got["ba"], k))
    for k in ("valid", "host", "status", "my_type"):
        exact(np.asarray(getattr(imm3, k)), getattr(got["imm"], k))
    for k in ("bias_valid", "spline_valid", "imu_valid", "scale_trapped",
              "queue_i"):
        exact(np.asarray(getattr(imu5, k)), getattr(got["imu"], k))
    exact(np.asarray(scale_o[1]), ref["scale_out"][1])
    exact(np.asarray(scale_o[2]), ref["scale_out"][2])
    # 2e-4 where no GN step lies between: the new traces' pixels, the
    # image stack, the activation distance, the IMU samples taken in
    for k in ("u", "v"):
        close(np.asarray(getattr(imm3, k)), getattr(got["imm"], k))
    close(np.asarray(dI3), got["dI"])
    close(np.asarray(min_act), got["min_act"])
    for k in ("acc", "gyro", "ts", "timestamps"):
        close(np.asarray(getattr(imu5, k)), getattr(got["imu"], k))
    # 5e-3 after the chain's BA (a full GN step and more)
    close(np.asarray(T_cw_all), ref["T_cw_all_t"], GN_TOL)
    close(np.asarray(affs), ref["affs_t"], GN_TOL)
    live = np.asarray(ba3.pt_valid)
    close(np.asarray(ba3.idepth)[live], got["ba"].idepth.numpy()[live],
          GN_TOL)
    close(np.asarray(ba3.state), got["ba"].state, GN_TOL)
    close(np.asarray(stats5[1]), ref["ba_stats"]["rmse"], GN_TOL)
    close(np.asarray(scale_o[0]), ref["scale_out"][0], GN_TOL)
    close(np.asarray(imu5.scale), got["imu"].scale, GN_TOL)
    close(np.asarray(bg), ref["bg"], GN_TOL)
    for tj, tp in zip(templates, got["templates"]):
        exact(np.asarray(tj.valid), tp.valid)
        close(np.asarray(tj.idepth), tp.idepth, GN_TOL)


# ---------------------------------------------------------------------------
# (e) no host read inside the bodies that the graphs capture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stereo", [True, False])
def test_vio_chain_body_reads_nothing_back(runs, stereo):
    """The VIO chain's body on the static buffers under the host-read
    guard: stereo + VIO (both scale-solve branches), and VIO-mono (the
    same recorded call on a system without the stereo solve, so that the
    trapping queue runs)."""
    calib, T_lr = runs["scene"][:2]
    fs = runs["eager"] if stereo else _system(calib, T_lr, stereo=False)
    fs._prior_row(first=False)       # made once, outside the body
    a, ref = _call(runs["calls"])
    (st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out, n_kf,
     shell_id, _, scale_state, pot, right, staged, timestamp) = a
    kf = CG.keyframe_inputs(fs, right, scale_state, staged, timestamp)
    if not stereo:
        # the constants a system makes at its first (eager) VIO keyframe,
        # before any capture
        CG.kf_chain_vio_body(fs, st, imm, pyr, T_cw_new, aff_new, exposure,
                             stats, host_out, n_kf, torch.as_tensor(
                                 CG.selection_keys(st["key"])), pot, 1,
                             False, kf)
    g = CG.ChainGraph(fs)
    g.prepare(st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out,
              n_kf, rng.fold_in(st["key"], shell_id), kf)
    with no_host_reads():
        g._chain(pot)
    out = g.out[pot]
    exact(out["marg_ks"], ref["marg_ks"])
    exact(out["slot"], ref["slot"])
    if stereo:
        for x, y in zip(out["scale_out"][:4], ref["scale_out"][:4]):
            _same_bits(x, y)
    else:
        exact(out["scale_out"][3], torch.tensor(-1.0))


# ---------------------------------------------------------------------------
# (f) the scene through the device chain
# ---------------------------------------------------------------------------
def test_device_vio_chain_equals_eager_path(runs):
    """The VIO chain's body inside the fused frame's in the fused path
    pipelined at depth 3, bit for bit the eager chain at the same
    depth."""
    eager, fs = runs["eager"], runs["graph"]
    assert eager.kf_shell_ids == fs.kf_shell_ids
    exact(eager.trajectory(scaled=True), fs.trajectory(scaled=True))
    for x, y in ((eager.ba, fs.ba), (eager.imm, fs.imm),
                 (eager.imu, fs.imu)):
        _same_states(x, y)
    exact(eager.host_out, fs.host_out)
    assert eager.current_scale == fs.current_scale
    assert eager.scale_trapped and fs.scale_trapped
    assert eager.kf_n_its == fs.kf_n_its
    exact(eager._last_bg, fs._last_bg)
    g = fs.fused_graph
    # every fused VIO chain goes through the fused body: none is classic
    # or at a rung prewarm() left out
    assert g.eager == {}, g.eager
    assert sum(g.chains.values()) == len(runs["calls"]) >= 2
