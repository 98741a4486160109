"""The fused frame as one device program (models/fused_graph.py: the step,
the keyframe decision, the keyframe chain under `control.cond(need_kf)`
and the next frame's inputs) on the CPU, against the JAX package's
`_fused_frame_mono_jit` / `_fused_frame_vio_jit` and against the eager
fused path it replaces on a card.

The mono scene of tests/test_torch_chain_graph.py (256x192, 20 frames,
F = 8, P = 512) runs through the FusedFrameGraph's body, pipelined at
depth 3, with the selector rung moved by hand at the fifth keyframe,
recording each dispatch; on a card the body is one CUDA graph a selector
rung, here it runs as it is (`ops/control.py`'s plain twins). The eager
dispatch runs the same. tests/test_torch_fused_frame_vio.py holds the
VIO frame.
Tolerances against the JAX package (tests/test_torch_helpers.py):
`need_kf`, the slot, the flagged slots, the selection count, the
dead-point counts, the BA's step count and the masks exact; after the
chain's BA (a full GN step and more) float fields at 5e-3; 2e-4 where no
GN step lies between, but the tracker's outputs at the tolerances of
tests/test_torch_frame_graph.py (its T 1e-4, residuals, flow and affine
1e-3) and the trace's depths as there (a point may land one search step
apart)."""

import collections

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models import chain_graph as CG
from sos_slam_tpu_torch.models import energy as E
from sos_slam_tpu_torch.models import fused_graph as FU
from sos_slam_tpu_torch.models.full_system import FullSystem
from sos_slam_tpu_torch.ops import control, selector
from sos_slam_tpu_torch.utils import synthetic
from sos_slam_tpu_torch.utils import telemetry as TM
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import GN_TOL, close, exact, no_host_reads

torch.set_num_threads(2)

W, H = 256, 192
N_FRAMES = 20
TWIST = (0.05, 0.02, 0.03, 0.003, 0.006, 0.002)
SETTINGS_KW = dict(max_window_frames=8, max_points=512, max_immature=1024,
                   max_track_pts=4096, desired_point_density=400.0,
                   desired_immature_density=400.0)


RUNG_AT = 5       # the keyframe count at whose completion the rung moves


def _drive(graph, record=None):
    """The mono scene through the fused path pipelined at depth 3: the
    eager dispatch, or the FusedFrameGraph's body (`graph`); the selector
    rung is moved one rung down when the RUNG_AT-th keyframe completes,
    with frames in flight. `record`: a list that gets each graph
    dispatch's arguments, shell and record. Returns (fs, the frames
    dispatched again after the rung change)."""
    calib = synthetic.default_calib(W, H)
    imgs, _, _ = synthetic.make_sequence(calib, N_FRAMES, TWIST,
                                         plane_z=2.0, device="cpu")
    fs = FullSystem(calib, default_settings(**SETTINGS_KW), device="cpu")
    fs.pipeline, fs.pipeline_depth = True, 3
    finish = fs._finish_kf

    def forced(rec, got, classic):
        finish(rec, got, classic)
        if len(fs.kf_shell_ids) == RUNG_AT:
            assert len(fs._pending_fused) == 3
            fs._sel_pot = selector.pot_step(fs._sel_pot, up=False)
    fs._finish_kf = forced
    if graph:
        fs.fused_graph = g = FU.FusedFrameGraph(fs)
    if record is not None:
        dispatch, by_graph = g.dispatch, fs._dispatch_graph

        def recorded(*a):
            record.append(dict(args=a))
            return dispatch(*a)

        def dispatched(img, shell, *a, **kw):
            rec = by_graph(img, shell, *a, **kw)
            record[-1].update(shell=shell, rec=rec)
            return rec
        g.dispatch, fs._dispatch_graph = recorded, dispatched
    for i in range(N_FRAMES):
        with fs.intake(i):      # as SlamNode.process: stamps around it
            img = imgs[i]
        fs.add_active_frame(img, timestamp=0.05 * i, frame_id=i)
    fs.finish_pending()
    del fs._finish_kf
    if record is not None:
        del g.dispatch, fs._dispatch_graph
    return fs, fs.telemetry.report()["timers_ms"]["redispatch"]["n"]


@pytest.fixture(scope="module")
def runs():
    calls = []
    eager, eager_again = _drive(False)
    graph, graph_again = _drive(True, record=calls)
    return dict(eager=eager, graph=graph, calls=calls,
                again=(eager_again, graph_again))


def _pick(calls, kf: bool):
    """The last recorded dispatch that made a keyframe (`kf`) or not and
    completed (the scene's steady frames)."""
    for c in reversed(calls):
        if c["shell"].is_kf == kf and c["shell"].pose_valid:
            return c
    raise AssertionError(f"no recorded frame with need_kf={kf}")


# ---------------------------------------------------------------------------
# (a) the fused body against the JAX package's programs
# ---------------------------------------------------------------------------
def _jax_state(mod_cls, port_state):
    import jax.numpy as jnp
    return mod_cls(**{k: jnp.asarray(v.numpy())
                      for k, v in port_state._asdict().items()})


def _j(x):
    import jax.numpy as jnp
    return jnp.asarray(x.numpy() if torch.is_tensor(x) else x)


def _common_args(fs, c):
    """The JAX fused programs' arguments shared by the mono and the VIO
    form, from a recorded dispatch `c`, by name."""
    import jax.numpy as jnp
    from sos_slam_tpu.ops import ba as JB
    from sos_slam_tpu.ops import trace as JTR
    from sos_slam_tpu.ops import tracker as JTK
    (st, inp, prev, _, img, exposure, _, _, _, _, pot, _) = c["args"]
    s_cur, trapped, fails = inp["scale_state"]
    return dict(
        image=_j(img), ba=_jax_state(JB.BAState, st["ba"]),
        imm=_jax_state(JTR.ImmatureState, st["imm"]), dI=_j(st["dI"]),
        templates=tuple(_jax_state(JTK.LevelTemplate, tp)
                        for tp in st["templates"]),
        T_primary=_j(inp["T_primary"]), T_hyps=_j(inp["T_hyps"]),
        T_cw_ref=_j(inp["T_cw_ref"]), aff0=_j(inp["aff"]),
        ref_aff=_j(inp["ref_aff"]), ref_exp=_j(inp["ref_exp"]),
        exposure=np.float32(exposure), achieve_th=_j(inp["th"]),
        first_rmse=_j(inp["first_rmse"]),
        prior_row=_j(fs._prior_row(first=False)),
        min_act_dist=_j(st["min_act"]),
        host_out=jnp.asarray(np.asarray(inp["host_out"]), jnp.int32),
        n_kf=np.int32(int(inp["n_kf"])), key0=jnp.asarray(st["key"]),
        shell_id=np.int32(c["shell"].id), HdiF_in=_j(st["HdiF"]),
        pc_in=tuple(_j(x) for x in st["pc_l0"]),
        T_cw_prev_in=_j(inp["T_cw_prev"]), prev_was_kf=np.bool_(bool(prev)),
        last_rmse0=_j(inp["rms0"]),
        scale_state=(_j(s_cur), _j(trapped), jnp.int32(int(fails))),
        max_its=fs.settings.max_opt_iterations,
        min_its=fs.settings.min_opt_iterations, sizes=fs.tmpl_sizes,
        pot=pot, n_slots=min(fs.settings.max_immature,
                             st["imm"].u.shape[0]),
        w=W, h=H, n_levels=fs.n_levels,
        intr=tuple(tuple(float(x) for x in fs.calib.intrinsics(lvl))
                   for lvl in range(fs.n_levels)))


def _mostly_close(a, b, share=0.005):
    """Within 1e-3 (tests/test_torch_trace.py's depth tolerance) on all
    but `share` of the entries: the trace's discrete epipolar search on
    poses that agree to 1e-4 may put a point one search step apart."""
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
    off = np.abs(a - b) > 1e-3 * (np.abs(a) + scale)
    assert off.sum() <= share * a.size, (off.sum(), a.size)


def _held_to_jax(fs, c, jout, vio=False):
    """The port's recorded frame `c` against the JAX program's outputs
    `jout` (pyr, need_kf, state, nxt, raw, ...)."""
    _, need_j, state_j, nxt_j, raw, _, _ = jout
    _, out_j, accept_j, T_cw_new_j, back_j = raw
    (stats5, T_cw_all, affs, _, _, n_have, marg_ks, _, _, host_o, slot,
     scale_o) = back_j[:12]
    rec = c["rec"]
    got = fs._fetch(rec["readback"])
    kf = bool(got["need_kf"])
    assert kf == c["shell"].is_kf
    exact(np.asarray(need_j), got["need_kf"])
    exact(np.asarray(accept_j), got["accept"])
    exact(np.asarray(out_j["good"]), got["out.good"])
    close(np.asarray(out_j["T"]), got["out.T"], tol=1e-4)
    close(np.asarray(T_cw_new_j), got["T_cw_new"], tol=1e-4)
    for k in ("aff", "residuals", "flow"):
        close(np.asarray(out_j[k]), got["out." + k], tol=1e-3)
    for k, v in (("slot", slot), ("marg_ks", marg_ks), ("n_have", n_have),
                 ("host_out", host_o), ("n_its", stats5[2]),
                 ("n_active", stats5[3]), ("is_lost", stats5[4])):
        exact(np.asarray(v).astype(np.float32), got[k])
    if vio:
        ba3, imu5, imm3, dI3, min_act, _, templates, _ = state_j
    else:
        ba3, imm3, dI3, min_act, _, templates, _ = state_j
    st = rec["state"]
    for k in ("frame_valid", "pt_valid", "host", "res_exist", "res_state"):
        exact(np.asarray(getattr(ba3, k)), getattr(st["ba"], k))
    for k in ("valid", "host", "status", "my_type"):
        exact(np.asarray(getattr(imm3, k)), getattr(st["imm"], k))
    for k in ("u", "v"):
        close(np.asarray(getattr(imm3, k)), getattr(st["imm"], k))
    fin = np.isfinite(np.asarray(imm3.idepth_max))
    exact(fin, np.isfinite(st["imm"].idepth_max.numpy()))
    _mostly_close(np.asarray(imm3.idepth_min), st["imm"].idepth_min)
    close(np.asarray(dI3), st["dI"])
    close(np.asarray(min_act), st["min_act"])
    exact(np.asarray(nxt_j["n_kf"]), rec["nxt"]["n_kf"])
    exact(np.asarray(nxt_j["host_out"]), rec["nxt"]["host_out"])
    # 5e-3 after the chain's BA (and what the next frame chains from it);
    # without a keyframe the window passes through and the tracker's
    # tolerance holds the chained poses
    tol = GN_TOL if kf else 1e-4
    close(np.asarray(T_cw_all), got["T_cw_all_t"], tol)
    close(np.asarray(affs), got["affs_t"], tol)
    close(np.asarray(ba3.state), st["ba"].state, tol)
    live = np.asarray(ba3.pt_valid)
    close(np.asarray(ba3.idepth)[live], st["ba"].idepth.numpy()[live], tol)
    close(np.asarray(stats5[1]), got["rmse"], tol)
    for tj, tp in zip(templates, st["templates"]):
        exact(np.asarray(tj.valid), tp.valid)
        close(np.asarray(tj.idepth), tp.idepth, tol)
    for k in ("T_primary", "T_hyps", "T_cw_ref", "T_cw_prev", "aff",
              "ref_aff", "ref_exp"):
        close(np.asarray(nxt_j[k]), rec["nxt"][k], GN_TOL if kf else 1e-3)
    for k, v in zip(("scale_s", "scale_trapped", "scale_fails"), scale_o):
        close(np.asarray(v).astype(np.float32), got[k], tol)
    return got


@pytest.mark.parametrize("kf", [True, False])
def test_fused_body_matches_jax_mono(runs, kf):
    import jax.numpy as jnp
    from sos_slam_tpu.models import full_system as JFS
    from sos_slam_tpu.utils import config as JC
    fs = runs["graph"]
    c = _pick(runs["calls"], kf)
    args = _common_args(fs, c)
    eye = jnp.eye(4, dtype=jnp.float32)
    jout = JFS._fused_frame_mono_jit(
        **args, img_right=jnp.zeros((1, 1), jnp.float32),
        have_right=jnp.asarray(False), T_lr=eye,
        settings=JC.default_settings(**SETTINGS_KW))
    got = _held_to_jax(fs, c, jout)
    if not kf:
        # the skip branch's readback: JAX's zeros and -1s
        assert (got["marg_ks"] == -1).all() and got["n_have"] == 0


# ---------------------------------------------------------------------------
# (b) the BA budget on the device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_kf, its", [(1, 20), (2, 15), (3, None)])
def test_budget_ladder(runs, n_kf, its):
    """`ba_budget` of a device keyframe count gives the bootstrap's 20 and
    15 GN steps and then the settings' budget, as a host count does, and
    the bounded BA under that device budget is bit for bit the eager loop
    under the host's (a disturbed window that runs to its budget)."""
    fs = runs["eager"]
    s = fs.settings
    its = s.max_opt_iterations if its is None else its
    dev = CG.ba_budget(torch.tensor(n_kf), s)
    assert dev.dim() == 0 and int(dev) == its == CG.ba_budget(n_kf, s)
    assert its == fs._max_its(n_kf + 1)
    g = torch.Generator().manual_seed(3)
    ba = fs.ba._replace(idepth=fs.ba.idepth * (1.0 + 0.05 * torch.randn(
        fs.ba.idepth.shape, generator=g)))
    s_all = default_settings(th_opt_iterations=0.0, **SETTINGS_KW)
    ba_e, st_e = E.optimize(ba, fs.dI, s_all, W, H, max_its=its,
                            min_its=s.min_opt_iterations)
    ba_b, st_b = E.optimize(ba, fs.dI, s_all, W, H, max_its=dev,
                            min_its=s.min_opt_iterations, bounded=True)
    assert st_e["n_its"] == its == int(st_b["n_its"])
    for x, y in zip(ba_e, ba_b):
        exact(x, y)
    for k in ("energy", "rmse", "n_active", "HdiF"):
        exact(st_e[k], st_b[k])


# ---------------------------------------------------------------------------
# (c) no host read inside the body that the graphs capture
# ---------------------------------------------------------------------------
def _outputs(g, pot):
    """The body's outputs: the readback but its device stamps (the clock,
    its last entry), the state and the chained inputs."""
    o = g.outs[pot]
    assert g.spec[-1] == ("stamps", (len(TM.STAMPS),), FU.BITS)
    return control.clone((o["flat"][:-2 * len(TM.STAMPS)], g.state,
                          dict(g.frame.inp), g.chained))


@pytest.mark.parametrize("case", ["keyframe", "full_window", "export"])
def test_fused_body_reads_nothing_back(runs, monkeypatch, case):
    """The whole fused body in the twins a card runs outside a capture
    (every branch, every loop to its cap) reads nothing on the host and
    gives the bits of the body as the CPU runs it (the branch taken):
    on a keyframe frame, on a frame that makes no keyframe with a full
    window (the chain's branch then runs on slot F, clamped), and on the
    keyframe frame with an export consumer attached (the dying slots'
    energy columns gathered at their device slots)."""
    fs = runs["graph"]
    c = _pick(runs["calls"], kf=case != "full_window")
    (st, inp, prev, _, img, exposure, key, right, shell_idx, block, pot,
     exporting) = c["args"]
    if case == "export":
        monkeypatch.setattr(fs, "_exporting", lambda: True)
        exporting = True
    g = FU.FusedFrameGraph(fs)
    g.dispatch(st, inp, prev, None, img, exposure, key, right, shell_idx,
               block, pot, exporting)
    if case == "full_window":
        st = dict(st, ba=st["ba"]._replace(
            frame_valid=torch.ones_like(st["ba"].frame_valid)))
        inp = dict(inp, n_frames=fs.F)

    def run(guard):
        g._load(st, inp, prev)
        g._stage(img, exposure, key, right, shell_idx, block)
        if guard:
            with no_host_reads():
                g._body(pot)
        else:
            g._body(pot)
        return _outputs(g, pot)

    plain, guarded = run(False), run(True)
    for x, y in zip(control._leaves(plain), control._leaves(guarded)):
        exact(x, y)
    assert bool(g.outs[pot]["need"]) == (case != "full_window")
    if case == "export":
        assert [k for k, _, _ in g.spec][-7:-1] == [
            "ecols", "marg", "marg_pts.0", "marg_pts.1", "marg_pts.2",
            "marg_pts.3"]


# ---------------------------------------------------------------------------
# (d) the scene through the device path
# ---------------------------------------------------------------------------
def test_fused_path_equals_eager_path(runs):
    """The fused body on the fused path pipelined at depth 3, a rung change
    with frames in flight included, bit for bit the eager dispatch at the
    same depth; every keyframe after the classic one runs in the body
    (its BA budgets too), and the rung change dispatched every frame in
    flight again (their decisions are not known at dispatch)."""
    eager, fs = runs["eager"], runs["graph"]
    assert eager.kf_shell_ids == fs.kf_shell_ids
    exact(eager.trajectory(), fs.trajectory())
    for a, b in zip((*eager.ba, *eager.imm), (*fs.ba, *fs.imm)):
        exact(a, b)
    exact(eager.host_out, fs.host_out)
    exact(eager.current_min_act_dist, fs.current_min_act_dist)
    assert eager.kf_n_its == fs.kf_n_its
    assert eager._sel_pot == fs._sel_pot != 3
    g = fs.fused_graph
    assert g.eager == {"classic": 1}, g.eager
    n_kf = len(fs.kf_shell_ids)
    assert sum(g.chains.values()) == n_kf - 2 >= 6
    assert len(g.chains) == 2           # keyframes at both rungs
    # the bootstrap's budgets ran in the body
    assert {20, 15} & set(fs.kf_n_its) or max(fs.kf_n_its) > 6
    eager_again, graph_again = runs["again"]
    assert graph_again == 3 >= eager_again
    # the state is copied in at the first fused frame and at the first
    # frame dispatched again (from the record completed last; each later
    # one from the frame replayed just before it), and nowhere else
    assert g.copy_ins == 2


# ---------------------------------------------------------------------------
# (e) the run counts through the frame's readback
# ---------------------------------------------------------------------------
def test_staged_counts_credit_each_run_once(monkeypatch):
    """`control.staged` gathers the counted bodies' run counters on the
    device; riding the readback (as float32 pairs), they are credited at
    the frame's fetch: in completion order each run once, an older count
    after a newer one not at all, and a dropped graph's not after its
    final credit."""
    from tests.test_torch_control import _card, _graph
    d, k1, k3 = _card(monkeypatch)
    rec = _graph(d, [control.IF, control.WHILE], [{"K1": 1}, {"K3": 2}])
    dev = torch.device("cuda", 5)
    fs = FullSystem(synthetic.default_calib(W, H),
                    default_settings(**SETTINGS_KW), device="cpu")
    flat = torch.tensor([1.0, 2.0])
    spec = [("x", (2,), torch.float32)]

    def frame(runs, entries):
        d.runs[rec.slots] = torch.tensor(runs)
        d.entries[rec.slots[1]] = entries
        return fs._stage_flat(spec, flat, control.staged(dev))

    a, b = frame([2, 3], 1), frame([4, 5], 2)
    exact(fs._fetch(a)["x"], flat)
    assert (k1.launches, k3.launches) == (2, 6)
    fs._fetch(b)
    assert (k1.launches, k3.launches) == (4, 10)
    fs._fetch(a)
    assert (k1.launches, k3.launches) == (4, 10)
    c = frame([9, 9], 3)
    d.release(rec)
    control.account()
    assert (k1.launches, k3.launches) == (9, 18)
    fs._fetch(c)
    assert (k1.launches, k3.launches) == (9, 18)
    assert control.CREDITED["runs"] == 18


# ---------------------------------------------------------------------------
# (f) the device stamps and the series through the readback
# ---------------------------------------------------------------------------
def check_stamps(fs) -> dict:
    """The fused frames' stamps from the telemetry's records, in the
    order of `telemetry.STAMPS` (chain.end where the chain ran), held
    ordered, each frame with one intake; the frames' `dev.frame` spans
    (two where the frame was dispatched again). Returns {frame: the number
    of its dev.frame spans}."""
    spans = collections.defaultdict(dict)
    n = collections.Counter()
    for name, f, t0, t1 in fs.telemetry.records:
        n[name, f] += 1
        spans[f][name] = (t0, t1)      # the last dispatch's spans last
    frames = {f: n["dev.frame", f] for f in spans if "dev.track" in spans[f]}
    assert frames
    for f in frames:
        r = spans[f]
        assert n["dev.intake", f] == 1, f
        order = [*r["dev.intake"], r["dev.track"][0], r["dev.track"][1],
                 r["dev.trace"][1]]
        if "dev.chain" in r:
            assert r["dev.chain"][0] == r["dev.trace"][1]
            order.append(r["dev.chain"][1])
        order += [r["dev.frame"][1], r["dev.post"][1]]
        assert order == sorted(order) and r["dev.frame"][0] == order[2], (
            f, order)
    return frames


def test_stamps_and_series_of_the_fused_frames(runs):
    """Every fused frame's device stamps ordered intake.begin <=
    intake.end <= frame.begin <= track.end <= step.end (<= chain.end) <=
    frame.end <= post.end; one intake a frame, also for the frames the
    rung change dispatched again (their first dispatch, dropped unfetched,
    gives a second frame span: busy time, not idle); one `dev.chain` a
    fused keyframe and none for a skipped chain; `track.retry` and
    `track.lm_trips` one a completed frame; `kf_n_its` the `ba.gn_its`
    series counted."""
    fs = runs["graph"]
    g, t = fs.fused_graph, fs.telemetry.timers
    frames = check_stamps(fs)
    assert sorted(frames.values()).count(2) == runs["again"][1] == 3
    chained = [f for name, f, _, _ in fs.telemetry.records
               if name == "dev.chain"]
    assert len(chained) == len(t["dev.chain"]) == sum(g.chains.values())
    assert set(chained) <= set(fs.kf_shell_ids)
    done = len(t["complete"])
    assert len(t["track.retry"]) == len(t["track.lm_trips"]) == done
    assert sum(t["track.retry"]) == g.frame.retries
    assert min(t["track.lm_trips"]) >= 1
    assert fs.kf_n_its == collections.Counter(int(x) for x in t["ba.gn_its"])
    assert len(t["dev.track"]) == len(t["dev.trace"]) == done
    rep = fs.telemetry.report()
    assert rep["clock"]["calibrations"] >= 1 and rep["idle_by_host"]
    assert not fs._sent and sum(t["dev.idle"]) > 0
