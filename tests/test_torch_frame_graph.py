"""The device-decision frame step (models/frame_graph.py) and the tracker's
bounded form (ops/tracker.py) on the CPU, against the eager forms they
replace and against the JAX package's `_frame_step_jit` /
`_need_kf_jit`.

The mono scene of tests/test_torch_pipeline.py (256x192) runs through
the eager dispatch once, recording each fused frame step's inputs; the
same frames then go through the bounded tracker and the FrameGraph's one
body (the primary track, the retry under `control.cond`, the rest),
which on a card is captured as one CUDA graph with conditional nodes and
here runs as it is, `ops/control.py`'s loops and branches in their plain
twins. The eager and the bounded forms must give the same bits; the JAX
package is held at the tolerances of tests/test_torch_tracker.py and
tests/test_torch_trace.py (T 1e-4, residuals, flow and affine 1e-3,
trace depths 1e-3, quality 1e-2, the rest 2e-4 relative; bools, ints and
statuses exact)."""

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models import frame_graph as FG
from sos_slam_tpu_torch.models import fused_graph as FU
from sos_slam_tpu_torch.models.full_system import FullSystem
from sos_slam_tpu_torch.ops import tracker as TK
from sos_slam_tpu_torch.ops.image import build_pyramid
from sos_slam_tpu_torch.utils import lie, synthetic
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import close, exact, no_host_reads

torch.set_num_threads(2)

W, H = 256, 192
N_FRAMES = 20
TWIST = (0.05, 0.02, 0.03, 0.003, 0.006, 0.002)
SETTINGS_KW = dict(max_window_frames=8, max_points=512, max_immature=1024,
                   max_track_pts=4096, desired_point_density=400.0,
                   desired_immature_density=400.0)


def _scene():
    calib = synthetic.default_calib(W, H)
    imgs, _, _ = synthetic.make_sequence(calib, N_FRAMES, TWIST,
                                         plane_z=2.0, device="cpu")
    return calib, imgs


def _drive(graph: bool, record=None):
    """The mono scene through the pipelined fused path (depth 3): the eager
    step, or with `graph` the FrameGraph's body inside the fused frame's
    (models/fused_graph.py). `record`: a list that gets each eager step's
    inputs."""
    calib, imgs = _scene()
    fs = FullSystem(calib, default_settings(**SETTINGS_KW), device="cpu")
    if graph:
        fs.fused_graph = FU.FusedFrameGraph(fs)
    if record is not None:
        step, need = fs._frame_step, fs._need_kf

        def frame_step(*a):
            record.append(dict(args=a))
            return step(*a)

        def need_kf(out, accept, exp_t, ref_exp, first_rmse, n_kf):
            record[-1].update(first_rmse=first_rmse, n_kf=n_kf)
            return need(out, accept, exp_t, ref_exp, first_rmse, n_kf)

        fs._frame_step, fs._need_kf = frame_step, need_kf
    for i in range(N_FRAMES):
        fs.add_active_frame(imgs[i], timestamp=0.05 * i, frame_id=i)
    fs.finish_pending()
    if record is not None:
        del fs._frame_step, fs._need_kf
    return fs


@pytest.fixture(scope="module")
def runs():
    steps = []
    eager = _drive(False, steps)
    graph = _drive(True)
    return eager, graph, steps


def _bad_pose():
    xi = torch.tensor([0.3, -0.2, 0.2, 0.1, -0.1, 0.1])
    return lie.se3_exp(xi[None])[0]


def _rolled(img):
    # an unmodelled jump: every hypothesis is far off
    return torch.roll(img, 40, 1)


def _cases(steps):
    """(name, img, T_primary, T_hyps, the recorded step) of steady frames,
    a frame whose primary is far off (the retry picks) and a rolled frame
    (the step refuses it)."""
    steady = steps[3:6]
    out = [(f"steady{i}", r["args"][1], r["args"][2], r["args"][3], r)
           for i, r in enumerate(steady)]
    r = steps[4]
    out.append(("retry", r["args"][1], _bad_pose() @ r["args"][2],
                r["args"][3], r))
    out.append(("rejected", _rolled(r["args"][1]), r["args"][2],
                r["args"][3], r))
    return out


# ---------------------------------------------------------------------------
# (a) the bounded tracker against the eager one
# ---------------------------------------------------------------------------
def _tracks(fs, rec, img, T_inits, **kw):
    st, s = rec["args"][0], fs.settings
    pyr, _ = build_pyramid(img, fs.n_levels)
    ref_exp, exposure = rec["args"][7], rec["args"][8]
    return TK.track_newest_coarse(
        pyr, st["templates"], T_inits, rec["args"][5], rec["args"][6],
        torch.stack([ref_exp, exposure]), torch.full((6,), float("nan")),
        fs._intr, fs.n_levels, coarse_cutoff_th=s.coarse_cutoff_th,
        huber=s.huber_th, **kw)


@pytest.mark.parametrize("K", [1, 5])
def test_bounded_tracker_equals_eager(runs, K):
    """The bounded tracker is the eager one bit for bit, in both of
    `ops/control.py`'s plain twins: the CPU's (the loops leave, the
    branches are skipped, as the conditional nodes do) and, under the
    host-read guard, the one a card runs outside a capture (every loop to
    its bound, every branch)."""
    eager_fs, _, steps = runs
    reps = []
    level = TK.track_level

    def counted(*a, **kw):
        res = level(*a, **kw)
        if not a[12]:             # the eager form's cutoff repeat
            reps.append(bool((res[3] > 1.0).any()))
        return res

    TK.track_level = counted
    try:
        for name, img, T_p, T_h, rec in _cases(steps):
            T_inits = T_p[None] if K == 1 else T_h.clone()
            if K == 5 and name == "retry":
                T_inits[2] = T_p
            n = len(reps)
            a = _tracks(eager_fs, rec, img, T_inits)
            doubled = any(reps[n:])
            b = _tracks(eager_fs, rec, img, T_inits, bounded=True)
            for k in a:
                exact(a[k], b[k])
            if name in ("steady0", "rejected"):
                with no_host_reads():
                    c = _tracks(eager_fs, rec, img, T_inits, bounded=True)
                for k in a:
                    exact(a[k], c[k])
            if name.startswith("steady") and K == 1:
                assert not doubled, name
            if name == "rejected":
                # the cutoff doubles, the re-pass and the level repeat run
                assert doubled, name
    finally:
        TK.track_level = level


# ---------------------------------------------------------------------------
# (b) the device-decision step against the eager step and the JAX package
# ---------------------------------------------------------------------------
def _inputs(fs, rec) -> dict:
    """The chained inputs of a recorded step, as `step` takes them."""
    (_, _, _, _, T_cw_ref, aff0, ref_aff, ref_exp, _,
     achieve_th) = rec["args"]
    return dict(T_cw_ref=T_cw_ref, aff=aff0, ref_aff=ref_aff,
                ref_exp=ref_exp, th=achieve_th, first_rmse=rec["first_rmse"],
                rms0=achieve_th / fs.settings.re_track_threshold,
                T_cw_prev=T_cw_ref, n_kf=rec["n_kf"])


def _graph_step(fs, rec, img, T_p, T_h):
    g = FG.FrameGraph(fs)
    return g, g.step(rec["args"][0], img, T_p, T_h, _inputs(fs, rec),
                     float(rec["args"][8]))


def _eager_step(fs, rec, img, T_p, T_h):
    a = rec["args"]
    pyr, out, imm, accept, T_cw_new, stats = fs._frame_step(
        a[0], img, T_p, T_h, *a[4:])
    need = fs._need_kf(out, accept, a[8], a[7], rec["first_rmse"],
                       rec["n_kf"])
    return pyr, out, imm, accept, T_cw_new, stats, need


@pytest.fixture(scope="module")
def stepped(runs):
    eager_fs, _, steps = runs
    res = []
    for name, img, T_p, T_h, rec in _cases(steps):
        g, got = _graph_step(eager_fs, rec, img, T_p, T_h)
        res.append((name, img, T_p, T_h, rec, g, got,
                    _eager_step(eager_fs, rec, img, T_p, T_h)))
    return res


def test_device_step_equals_eager(stepped):
    seen = set()
    for name, _, _, _, _, g, got, ref in stepped:
        pyr, out, imm, accept, T_cw_new, stats, need = ref
        for a, b in zip(got["pyr"], pyr):
            exact(a, b)
        for k in out:
            exact(got["out"][k], out[k])
        for a, b in zip(got["imm"], imm):
            exact(a, b)
        assert bool(got["accept"]) == accept, name
        exact(got["T_cw_new"], T_cw_new)
        for a, b in zip(got["stats"], stats):
            exact(a, b)
        assert got["need_kf"] == need, name
        if g.retries:
            seen.add("retry")
        if not accept:
            seen.add("rejected")
        elif name == "retry":
            assert g.retries == 1
    assert seen == {"retry", "rejected"}


def _jax_state(mod_cls, port_state):
    import jax.numpy as jnp
    return mod_cls(**{k: jnp.asarray(v.numpy())
                      for k, v in port_state._asdict().items()})


def test_device_step_matches_jax(stepped):
    import jax.numpy as jnp
    from sos_slam_tpu.models import full_system as JFS
    from sos_slam_tpu.ops import ba as JB
    from sos_slam_tpu.ops import trace as JTR
    from sos_slam_tpu.ops import tracker as JTK
    from sos_slam_tpu.utils import config as JC
    settings = JC.default_settings(**SETTINGS_KW)
    for name, img, T_p, T_h, rec, _, got, _ in stepped:
        st = rec["args"][0]
        a = rec["args"]
        j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
        pyr, out, imm, accept, T_cw_new, stats = JFS._frame_step_jit(
            j(img), _jax_state(JB.BAState, st["ba"]),
            _jax_state(JTR.ImmatureState, st["imm"]),
            tuple(_jax_state(JTK.LevelTemplate, tp)
                  for tp in st["templates"]),
            j(T_p), j(T_h), j(a[4]), j(a[5]), j(a[6]), j(a[7]), j(a[8]),
            j(a[9]), settings, W, H, len(got["pyr"]),
            tuple(tuple(float(x) for x in i) for i in
                  _intrinsics(len(got["pyr"]))))
        need = JFS._need_kf_jit(out, accept, j(a[8]), j(a[7]),
                                j(rec["first_rmse"]), rec["n_kf"], settings,
                                W, H)
        exact(np.asarray(accept), got["accept"].numpy())
        exact(np.asarray(need), got["need_kf"])
        exact(np.asarray(out["good"]), got["out"]["good"].numpy())
        if not bool(accept):
            continue
        close(np.asarray(out["T"]), got["out"]["T"], tol=1e-4)
        close(np.asarray(T_cw_new), got["T_cw_new"], tol=1e-4)
        for k in ("aff", "residuals", "flow"):
            close(np.nan_to_num(np.asarray(out[k]), nan=-1),
                  np.nan_to_num(got["out"][k].numpy(), nan=-1), tol=1e-3)
        exact(np.asarray(imm.status), got["imm"].status)
        exact(np.asarray(imm.valid), got["imm"].valid)
        # the trace's discrete epipolar search on poses that agree to
        # 1e-4: a point may land one search step apart (1 of 1024 here)
        fin = np.isfinite(np.asarray(imm.idepth_max))
        exact(fin, np.isfinite(got["imm"].idepth_max.numpy()))
        _mostly_close(np.asarray(imm.idepth_min), got["imm"].idepth_min)
        _mostly_close(np.asarray(imm.idepth_max)[fin],
                      got["imm"].idepth_max.numpy()[fin])
        exact(np.asarray(stats[0]), got["stats"][0])
        exact(np.asarray(stats[1]), got["stats"][1])
        close(np.asarray(stats[2]), got["stats"][2])
        close(np.asarray(stats[3]), got["stats"][3])
        for lv, lj in zip(got["pyr"], pyr):
            close(np.asarray(lj), lv)


def _mostly_close(a, b, share=0.005):
    """Within 1e-3 (tests/test_torch_trace.py's depth tolerance) on all
    but `share` of the entries, and within 1e-2 on all."""
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
    off = np.abs(a - b) > 1e-3 * (np.abs(a) + scale)
    assert off.sum() <= share * a.size, (off.sum(), a.size)
    close(a, b, tol=1e-2)


def _intrinsics(n_levels):
    calib = synthetic.default_calib(W, H)
    return [calib.intrinsics(lvl) for lvl in range(n_levels)]


# ---------------------------------------------------------------------------
# (c) no host read inside the bodies that the graphs capture
# ---------------------------------------------------------------------------
def test_bodies_read_nothing_back(stepped):
    """The one body, its retry branch and loops in the twins a card runs
    outside a capture, reads nothing on the host, and gives the step's
    bits, on a steady frame and on the frame whose primary misses."""
    for name, img, T_p, T_h, rec, g, got, _ in stepped:
        if name not in ("steady0", "retry"):
            continue
        g._load(rec["args"][0], img, T_p, T_h, _inputs(g.fs, rec),
                float(rec["args"][8]), rec["n_kf"])
        with no_host_reads():
            g._frame()
        assert bool(g.a["miss"]) == (name == "retry"), name
        for k in got["out"]:
            exact(g.sel[k], got["out"][k])
        exact(g.b["T_cw_new"], got["T_cw_new"])
        assert bool(g.b["need_kf"]) == got["need_kf"], name


# ---------------------------------------------------------------------------
# (d) the scene through the device-decision step
# ---------------------------------------------------------------------------
def test_device_path_equals_eager_path(runs):
    eager, graph, _ = runs
    assert eager.kf_shell_ids == graph.kf_shell_ids
    exact(eager.trajectory(), graph.trajectory())
    for a, b in zip((*eager.ba, *eager.imm), (*graph.ba, *graph.imm)):
        exact(a, b)
    g = graph.fused_graph
    assert g.frame.replays >= 10
    # the state is updated in place: copied in at the first fused frame
    # only (no frame went again)
    assert g.copy_ins == 1
