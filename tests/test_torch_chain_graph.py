"""The vision keyframe chain with its decisions on the device
(models/chain_graph.py) and the BA's bounded form (models/energy.py) on
the CPU, against the eager forms they replace and against the JAX
package's `_flag_frames_jit` and `_kf_chain_jit`.

The mono scene of tests/test_torch_frame_graph.py (256x192, 20 frames)
runs once through the eager fused path, recording each keyframe chain's
inputs and outputs; the same chains then go through the ChainGraph's
bodies, which on a card are captured as CUDA graphs and here run as they
are. Tolerances against the JAX package (tests/test_torch_helpers.py):
the flags and flagged slots exact; after the chain's whole BA (up to six
GN steps), float fields at 5e-3 (a full GN step, tests/test_ba_p.py:
143-144) and 2e-4 where no GN step lies between (the energies' window
bookkeeping, the selection's pixel positions); masks, counts, slots and
the selection count exact."""

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models import chain_graph as CG
from sos_slam_tpu_torch.models import energy as E
from sos_slam_tpu_torch.models import fused_graph as FU
from sos_slam_tpu_torch.models.full_system import FullSystem
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.utils import rng, synthetic
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import GN_TOL, close, exact, no_host_reads

torch.set_num_threads(2)

W, H = 256, 192
N_FRAMES = 20
TWIST = (0.05, 0.02, 0.03, 0.003, 0.006, 0.002)
SETTINGS_KW = dict(max_window_frames=8, max_points=512, max_immature=1024,
                   max_track_pts=4096, desired_point_density=400.0,
                   desired_immature_density=400.0)


def _drive(graph=False, record=None):
    """The mono scene through the fused path, pipelined at depth 3: the
    eager chain, or the fused frame graph's body (`graph`,
    models/fused_graph.py: the chain's body under `control.cond(need_kf)`
    inside the frame). `record`: a list that gets each eager chain's
    arguments and result."""
    calib = synthetic.default_calib(W, H)
    imgs, _, _ = synthetic.make_sequence(calib, N_FRAMES, TWIST,
                                         plane_z=2.0, device="cpu")
    fs = FullSystem(calib, default_settings(**SETTINGS_KW), device="cpu")
    fs.pipeline, fs.pipeline_depth = True, 3
    if graph:
        fs.fused_graph = FU.FusedFrameGraph(fs)
    if record is not None:
        chain = fs._kf_chain

        def recorded(*a, **kw):
            out = chain(*a, **kw)
            record.append((a, kw, out))
            return out
        fs._kf_chain = recorded
    for i in range(N_FRAMES):
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
    fs.finish_pending()
    if record is not None:
        del fs._kf_chain
    return fs


@pytest.fixture(scope="module")
def runs():
    calls = []
    eager = _drive(record=calls)
    return dict(eager=eager, calls=calls, graph=_drive(graph=True))


def _graph_call(calls):
    """The last recorded chain the graphs take (the BA budget of the
    settings) that marginalizes a frame."""
    fs_budget = default_settings(**SETTINGS_KW).max_opt_iterations
    for a, kw, out in reversed(calls):
        if a[10] == fs_budget and int((out["marg_ks"] >= 0).sum()):
            return a, out
    raise AssertionError("no recorded chain marginalizes a frame")


# ---------------------------------------------------------------------------
# (a) the device flags against _flag_frames_jit
# ---------------------------------------------------------------------------
def _flag_case(r, n, bad_share, far):
    """Seeded window stats of n live slots out of 8: a share of the slots
    with too few points left, and `far` translations (0: a tight window,
    which the distance drop acts on)."""
    F = 8
    pt_in = r.randint(50, 300, F)
    imm_in = r.randint(0, 100, F)
    host_out = r.randint(0, 40, F)
    bad = r.rand(F) < bad_share
    host_out = np.where(bad, 20 * (pt_in + imm_in), host_out)
    aff = (0.05 * r.randn(F, 2)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    T[:, :3, 3] = (np.cumsum(r.rand(F, 3), 0) * (1.0 + far)).astype(
        np.float32)
    exp = r.uniform(0.8, 1.2, F).astype(np.float32)
    valid = np.arange(F) < n
    n_kf = int(r.choice([n, 12]))
    return pt_in, imm_in, aff, T, exp, valid, host_out, n_kf


def test_flag_frames_matches_jax():
    import jax.numpy as jnp
    from sos_slam_tpu.models import full_system as JFS
    from sos_slam_tpu.utils import config as JC
    settings = JC.default_settings(**SETTINGS_KW)
    s = default_settings(**SETTINGS_KW)
    r = np.random.RandomState(7)
    seen = dict(gated=0, dropped=0, flagged=0)
    for case in range(24):
        n = 3 + case % 6
        args = _flag_case(r, n, bad_share=(0.0, 0.4, 0.9)[case % 3],
                          far=case % 2)
        pt_in, imm_in, aff, T, exp, valid, host_out, n_kf = args
        fj, kj = JFS._flag_frames_jit(
            jnp.asarray(pt_in, jnp.int32), jnp.asarray(imm_in, jnp.int32),
            jnp.asarray(aff), jnp.asarray(T), jnp.asarray(exp),
            jnp.asarray(valid), jnp.asarray(host_out, jnp.int32), n_kf,
            settings)
        t = torch.as_tensor
        ft, kt = CG.flag_frames(
            (t(pt_in), t(imm_in), t(aff), t(T)), t(exp), t(valid),
            t(host_out), n_kf, s)
        exact(np.asarray(fj), ft)
        exact(np.asarray(kj), kt)
        bad = (pt_in + imm_in) < s.min_points_remaining * (
            pt_in + imm_in + host_out)
        n_bad = int((bad & valid).sum())
        n_flag = int(ft.sum())
        seen["flagged"] += n_flag > 0
        # the count gate: a bad slot left unflagged at the window's floor
        seen["gated"] += n_bad > 0 and n - min(n_flag, n_bad) \
            <= s.min_frames and n_flag < n_bad
        seen["dropped"] += bool((ft & ~torch.as_tensor(bad)).any())
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("max_frames, raises",
                         [(7, False), (8, False), (9, True)])
def test_flag_count_beyond_marg_ks_raises(max_frames, raises):
    """The flags keep MAX_MARG_FRAMES slots, and the settings allow up to
    (max_frames - min_frames) + 1 flagged frames a keyframe: a FullSystem
    whose settings could flag more refuses to start, as the JAX package's
    does (sos_slam_tpu/models/full_system.py's MAX_MARG_FRAMES guard)."""
    s = default_settings(min_frames=5, max_frames=max_frames,
                         **dict(SETTINGS_KW, max_window_frames=10))
    calib = synthetic.default_calib(W, H)
    if raises:
        with pytest.raises(ValueError, match="MAX_MARG_FRAMES"):
            FullSystem(calib, s, device="cpu")
    else:
        FullSystem(calib, s, device="cpu")


@pytest.mark.parametrize("n", [0, 3, 8])
def test_newest_slot(n):
    """The newest slot on the device: the last live slot, and for an empty
    window the last slot, as the JAX package's index -1."""
    fv = torch.arange(8) < n
    got = B.newest_slot(fv)
    assert got.dim() == 0 and int(got) == (n - 1) % 8


# ---------------------------------------------------------------------------
# (b) the bounded BA against the early-exit loop
# ---------------------------------------------------------------------------
def _optimized(ba, dI, settings, max_its, bounded):
    return E.optimize(ba, dI, settings, W, H, max_its=max_its,
                      min_its=settings.min_opt_iterations, bounded=bounded)


@pytest.mark.parametrize("case", ["max_its1", "max_its6", "first_break"])
def test_bounded_optimize_equals_early_exit(runs, case):
    fs = runs["eager"]
    settings = fs.settings
    ba = fs.ba
    max_its = 1 if case == "max_its1" else 6
    if case == "first_break":
        # every step small enough to break at once
        settings = default_settings(th_opt_iterations=1e9, **SETTINGS_KW)
    else:
        # a disturbed window needs several steps
        g = torch.Generator().manual_seed(3)
        ba = ba._replace(idepth=ba.idepth * (1.0 + 0.05 * torch.randn(
            ba.idepth.shape, generator=g)))
    ba_e, st_e = _optimized(ba, fs.dI, settings, max_its, bounded=False)
    ba_b, st_b = _optimized(ba, fs.dI, settings, max_its, bounded=True)
    for k in B.BAState._fields:
        exact(getattr(ba_e, k), getattr(ba_b, k))
    for k in ("energy", "rmse", "n_active", "is_lost", "HdiF"):
        exact(st_e[k], st_b[k])
    assert int(st_b["n_its"]) == st_e["n_its"]
    want = dict(max_its1=(1, 1), max_its6=(2, 6), first_break=(1, 1))[case]
    assert want[0] <= st_e["n_its"] <= want[1], st_e["n_its"]


# ---------------------------------------------------------------------------
# (c) the chain's bodies against the eager chain
# ---------------------------------------------------------------------------
def _step(fs, a):
    """ChainGraph.step on a recorded chain's arguments."""
    (st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out, n_kf,
     shell_id, _, _, pot, _) = a
    g = CG.ChainGraph(fs)
    return g, g.step(st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                     host_out, n_kf, rng.fold_in(st["key"], shell_id), pot)


def _same_chain(got, ref):
    for k in ("T_cw_all_t", "affs_t", "slot", "marg_ks", "n_have",
              "host_out"):
        exact(got[k], ref[k])
    for k in ("energy", "rmse", "n_active", "is_lost"):
        exact(got["ba_stats"][k], ref["ba_stats"][k])
    assert int(got["ba_stats"]["n_its"]) == int(ref["ba_stats"]["n_its"])
    for k in ("ba", "imm"):
        for x, y in zip(got["state"][k], ref["state"][k]):
            exact(x, y)
    for k in ("dI", "min_act", "HdiF"):
        exact(got["state"][k], ref["state"][k])
    for tg, tr in zip(got["state"]["templates"], ref["state"]["templates"]):
        for x, y in zip(tg, tr):
            exact(x, y)


def test_chain_body_equals_eager_chain(runs):
    fs = runs["eager"]
    a, ref = _graph_call(runs["calls"])
    g, got = _step(fs, a)
    _same_chain(got, ref)
    assert g.replays == {a[12]: 1}


def _marg_frames_host(fs, ba, imm, dI, host_out, ks, export):
    """The frame marginalizations with the flagged slots read on the host:
    each slot in turn with its energy column first (`export`), the slot ->
    row map and the per-host counts as lists, then one compaction."""
    F = ba.F
    dimap, ecols = list(range(F)), []
    for k in ks:
        if export:
            ecols.append(B.col_energy(ba, dI, k, fs.settings, W, H,
                                      row=dimap[k]))
        ba, imm, _ = fs._marg_frame(ba, imm, None, k)
        dimap = dimap[:k] + dimap[k + 1:] + [dimap[k]]
        host_out = torch.cat([host_out[:k], host_out[k + 1:],
                              torch.zeros_like(host_out[:1])])
    live = torch.arange(F) < torch.sum(ba.frame_valid)
    dI = torch.where(live[:, None, None, None], dI[torch.tensor(dimap)],
                     torch.zeros_like(dI))
    return ba, imm, dI, host_out, ecols


@pytest.mark.parametrize("export", [False, True])
def test_marg_frames_equals_host_loop(runs, monkeypatch, export):
    """`marg_frames` (masked by the device slots, read nothing back
    without an export consumer) against the slots marginalized one by one
    on the host, bit for bit on the window, the pool, the image stack and
    the per-host counts; with an export consumer also the dying slots'
    energy columns."""
    fs = runs["eager"]
    monkeypatch.setattr(fs, "_exporting", lambda: export)
    n = int(torch.sum(fs.ba.frame_valid))
    ks = [n - 2, 1]
    marg_ks = torch.tensor(ks + [-1] * (CG.MAX_MARG_FRAMES - len(ks)))
    host_out = torch.arange(fs.F, dtype=torch.int64) * 3
    ba, imm, imu, dI, ho, ecols = CG.marg_frames(fs, fs.ba, fs.imm, fs.dI,
                                                 host_out, marg_ks)
    rba, rimm, rdI, rho, recols = _marg_frames_host(
        fs, fs.ba, fs.imm, fs.dI, host_out, ks, export)
    assert imu is None and int(torch.sum(ba.frame_valid)) == n - 2
    for x, y in zip((*ba, *imm, dI, ho), (*rba, *rimm, rdI, rho)):
        exact(x, y)
    assert len(ecols) == (CG.MAX_MARG_FRAMES if export else 0)
    for (e, c), (re_, rc) in zip(ecols, recols):
        exact(e, re_)
        exact(c, rc)


# ---------------------------------------------------------------------------
# (d) the chain against the JAX package's _kf_chain_jit
# ---------------------------------------------------------------------------
def _jax_state(mod_cls, port_state):
    import jax.numpy as jnp
    return mod_cls(**{k: jnp.asarray(v.numpy())
                      for k, v in port_state._asdict().items()})


def test_chain_matches_jax(runs):
    import jax.numpy as jnp
    from sos_slam_tpu.models import full_system as JFS
    from sos_slam_tpu.ops import ba as JB
    from sos_slam_tpu.ops import trace as JTR
    from sos_slam_tpu.ops import tracker as JTK
    from sos_slam_tpu.utils import config as JC
    settings = JC.default_settings(**SETTINGS_KW)
    fs = runs["eager"]
    a, ref = _graph_call(runs["calls"])
    (st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out, n_kf,
     shell_id, max_its, _, pot, _) = a
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    out_step = dict(aff=j(aff_new)[None],
                    residuals=jnp.zeros((1, 6), jnp.float32))
    eye = jnp.eye(4, dtype=jnp.float32)
    state, back, _ = JFS._kf_chain_jit(
        jnp.asarray(True), _jax_state(JB.BAState, st["ba"]),
        _jax_state(JTR.ImmatureState, imm), j(st["dI"]),
        tuple(j(p) for p in pyr), out_step, j(T_cw_new), j(exposure),
        j(fs._prior_row(first=False)), j(st["min_act"]),
        jnp.asarray(host_out.numpy(), jnp.int32), np.int32(n_kf),
        jnp.asarray(st["key"]), np.int32(shell_id),
        tuple(jnp.asarray(x.numpy(), x.numpy().dtype if i > 1
                          else jnp.int32) for i, x in enumerate(stats)),
        j(st["HdiF"]),
        tuple(_jax_state(JTK.LevelTemplate, tp) for tp in st["templates"]),
        tuple(j(x) for x in st["pc_l0"]), eye, jnp.zeros(2), jnp.float32(1),
        eye, jnp.asarray(False), jnp.float32(1.0),
        jnp.zeros((1, 1), jnp.float32), jnp.asarray(False), eye,
        (np.float32(1.0), np.bool_(False), np.int32(0)),
        max_its, settings.min_opt_iterations, fs.tmpl_sizes, pot,
        min(settings.max_immature, imm.u.shape[0]), settings, W, H)
    ba3, imm3, dI3, min_act, HdiF, templates, _ = state
    (stats5, T_cw_all, affs, marg, died, n_have, marg_ks, _, _, host_o,
     slot, _) = back
    # exact: the flags, slots, counts and masks
    exact(np.asarray(marg_ks), ref["marg_ks"])
    exact(np.asarray(slot), ref["slot"])
    exact(np.asarray(n_have), ref["n_have"])
    exact(np.asarray(host_o), ref["host_out"])
    exact(np.asarray(stats5[2]), ref["ba_stats"]["n_its"])
    exact(np.asarray(stats5[3]), ref["ba_stats"]["n_active"])
    got = ref["state"]
    for k in ("frame_valid", "pt_valid", "host", "res_exist", "res_state"):
        exact(np.asarray(getattr(ba3, k)), getattr(got["ba"], k))
    for k in ("valid", "host", "status", "my_type"):
        exact(np.asarray(getattr(imm3, k)), getattr(got["imm"], k))
    # 2e-4 where no GN step lies between: the new traces' pixels, the
    # image stack, the activation distance
    for k in ("u", "v"):
        close(np.asarray(getattr(imm3, k)), getattr(got["imm"], k))
    close(np.asarray(dI3), got["dI"])
    close(np.asarray(min_act), got["min_act"])
    # 5e-3 after the chain's BA (a full GN step and more)
    close(np.asarray(T_cw_all), ref["T_cw_all_t"], GN_TOL)
    close(np.asarray(affs), ref["affs_t"], GN_TOL)
    live = np.asarray(ba3.pt_valid)
    close(np.asarray(ba3.idepth)[live], got["ba"].idepth.numpy()[live],
          GN_TOL)
    close(np.asarray(ba3.state), got["ba"].state, GN_TOL)
    close(np.asarray(stats5[1]), ref["ba_stats"]["rmse"], GN_TOL)
    for tj, tp in zip(templates, got["templates"]):
        exact(np.asarray(tj.valid), tp.valid)
        close(np.asarray(tj.idepth), tp.idepth, GN_TOL)


# ---------------------------------------------------------------------------
# (e) no host read inside the bodies that the graphs capture
# ---------------------------------------------------------------------------
def test_chain_bodies_read_nothing_back(runs):
    fs = runs["eager"]
    a, ref = _graph_call(runs["calls"])
    (st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out, n_kf,
     shell_id, _, _, pot, _) = a
    g = CG.ChainGraph(fs)
    g.prepare(st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out,
              n_kf, rng.fold_in(st["key"], shell_id))
    with no_host_reads():
        g._chain(pot)
    exact(g.out[pot]["marg_ks"], ref["marg_ks"])


# ---------------------------------------------------------------------------
# (f) the scene through the device chain
# ---------------------------------------------------------------------------
def test_device_chain_equals_eager_path(runs):
    """The chain's body inside the fused frame's on the fused path
    pipelined at depth 3, bit for bit the eager chain at the same
    depth."""
    eager, fs = runs["eager"], runs["graph"]
    assert eager.kf_shell_ids == fs.kf_shell_ids
    exact(eager.trajectory(), fs.trajectory())
    for a, b in zip((*eager.ba, *eager.imm), (*fs.ba, *fs.imm)):
        exact(a, b)
    exact(eager.host_out, fs.host_out)
    exact(eager.current_min_act_dist, fs.current_min_act_dist)
    assert eager.kf_n_its == fs.kf_n_its
    g = fs.fused_graph
    n_kf = len(fs.kf_shell_ids)
    # the first chain is the classic keyframe's; every later one runs in
    # the fused body, the bootstrap budgets (20 and 15 GN steps) too
    assert g.eager == {"classic": 1}, g.eager
    assert sum(g.chains.values()) == n_kf - 2 >= 6
    assert 20 in fs.kf_n_its or 15 in fs.kf_n_its or max(fs.kf_n_its) > 6
    # frames were marginalized inside the graphs' chains
    assert any(sh.marginalized_at >= 0 for sh in fs.shells)
