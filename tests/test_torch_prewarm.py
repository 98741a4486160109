"""FullSystem.prewarm on the port, and Telemetry.device_trace.

`prewarm` runs the rare variants of the per-frame work on the current
state and changes none of it, but it records the selector rungs it
warmed, and the density adaptation then moves the rung only among them
(sos_slam_tpu/models/full_system.py, both rung-adaptation sites). The
scene is tests/test_torch_pipeline_invalidation.py's rung-moving one
(256x192, desired_immature_density 1200) in the JAX package's pixels: its
rung falls 3 -> 2 at the initialization keyframe (frame 7, before any
prewarm can run: it needs an initialized system) and 2 -> 1 at frame 11.
`prewarm(pots=(2,))` at frame 9 holds it at 2; both packages, given the
same call at the same frame, keep the same keyframes."""

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models import snapshot as SNAP
from sos_slam_tpu_torch.models.full_system import FullSystem
from sos_slam_tpu_torch.utils import config as TC
from sos_slam_tpu_torch.utils import synthetic
from sos_slam_tpu_torch.utils.telemetry import Telemetry
from tests.test_torch_helpers import exact, scene_images

torch.set_num_threads(2)

W, H = 256, 192
N_FRAMES = 18
TWIST = (0.05, 0.02, 0.03, 0.003, 0.006, 0.002)
LADDER = (1, 2, 3, 4, 6, 8, 12, 16)   # every rung of ops/selector.py
CLAMP_AT, CLAMP_POTS = 9, (2,)         # between the two rung moves
LADDER_AT = 10


def _settings(mod):
    return mod.default_settings(
        max_window_frames=8, max_points=512, max_immature=1024,
        max_track_pts=4096, desired_point_density=450.0,
        desired_immature_density=1200.0)


def _state(fs) -> dict:
    """Copies of everything prewarm must leave as it is."""
    out = {f"ba.{k}": v.clone() for k, v in fs.ba._asdict().items()}
    out.update({f"imm.{k}": v.clone() for k, v in fs.imm._asdict().items()})
    out.update(dI=fs.dI.clone(), HdiF=fs.HdiF.clone(),
               key=torch.as_tensor(np.array(fs.key)),
               host_out=torch.as_tensor(fs.host_out.copy()))
    for lvl, tp in enumerate(fs.templates or ()):
        out.update({f"tmpl.{lvl}.{k}": v.clone()
                    for k, v in tp._asdict().items()})
    out.update({f"pc_l0.{i}": v.clone() for i, v in enumerate(fs.pc_l0 or ())})
    return out


def _host(fs) -> dict:
    return dict(sel_pot=fs._sel_pot, last_chain=fs._last_chain,
                stats=dict(fs.stats), n_shells=len(fs.shells),
                telemetry=fs.telemetry.report())


def _feed(fs, imgs, frames, prewarm_at=None, pots=None, seen=None):
    """Frames `frames` into fs, `prewarm(pots)` before frame prewarm_at;
    with `seen`, the (state, host) before and after that call appended to
    it. Returns the rung after every frame."""
    rungs = []
    for i in frames:
        if i == prewarm_at and seen is None:
            fs.prewarm(pots=pots)
        elif i == prewarm_at:
            fs.finish_pending()      # what prewarm does first
            before = (_state(fs), _host(fs))
            fs.prewarm(pots=pots)
            seen.append((before, (_state(fs), _host(fs))))
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        rungs.append(getattr(fs, "_sel_pot", None))
    fs.finish_pending()
    return rungs


def _port(imgs, pipeline=True, fused=True, prewarm_at=None, pots=None,
          seen=None, frames=None):
    fs = FullSystem(synthetic.default_calib(W, H), _settings(TC),
                    device="cpu")
    fs.pipeline, fs.fused_kf = pipeline, fused
    rungs = _feed(fs, imgs, frames or range(len(imgs)), prewarm_at, pots,
                  seen)
    assert fs.initialized and not fs.is_lost and not fs.init_failed
    return fs, rungs


@pytest.fixture(scope="module")
def scene():
    return scene_images(W, H, N_FRAMES, TWIST)


@pytest.fixture(scope="module")
def jax_runs(scene):
    """The JAX package's FullSystem, fused and classic, prewarmed with
    CLAMP_POTS at CLAMP_AT (one process: the two share their programs)."""
    import jax.numpy as jnp
    from sos_slam_tpu.models.full_system import FullSystem as JFS
    from sos_slam_tpu.utils import config as JC
    from sos_slam_tpu.utils import synthetic as JSY
    imgs = [jnp.asarray(im) for im in scene[0]]
    out = {}
    for fused in (True, False):
        fs = JFS(JSY.default_calib(W, H), _settings(JC))
        fs.fused_kf = fused
        rungs = _feed(fs, imgs, range(len(imgs)), CLAMP_AT, CLAMP_POTS)
        out[fused] = fs, rungs
    return out


@pytest.fixture(scope="module")
def runs(scene):
    imgs = scene[0]
    seen = []
    r = dict(
        free=_port(imgs, pipeline=False),
        ladder_sync=_port(imgs, pipeline=False, prewarm_at=LADDER_AT,
                          pots=LADDER, seen=seen),
        ladder_pipe=_port(imgs, prewarm_at=LADDER_AT, pots=LADDER,
                          seen=seen),
        clamp=_port(imgs, prewarm_at=CLAMP_AT, pots=CLAMP_POTS, seen=seen),
        classic_free=_port(imgs, fused=False),
        classic_clamp=_port(imgs, fused=False, prewarm_at=CLAMP_AT,
                            pots=CLAMP_POTS, seen=seen))
    r["seen"] = seen
    return r


def _bitwise(fs_a, fs_b):
    ta, tb = fs_a.trajectory(), fs_b.trajectory()
    assert ta[:, 0].tolist() == tb[:, 0].tolist(), "keyframe sets differ"
    exact(ta[:, 1:4], tb[:, 1:4])
    for k, v in fs_a.ba._asdict().items():
        exact(v, getattr(fs_b.ba, k))
    exact(fs_a.imm.valid, fs_b.imm.valid)
    exact(fs_a.imm.u, fs_b.imm.u)


def _same_keyframes(fs_j, fs_t):
    """Keyframe ids equal, positions within test_torch_full_system.py's
    1e-3."""
    tj, tt = fs_j.trajectory(), fs_t.trajectory()
    assert tj[:, 0].astype(int).tolist() == tt[:, 0].astype(int).tolist()
    d = np.linalg.norm(tj[:, 1:4] - tt[:, 1:4], axis=1)
    assert d.max() < 1e-3, d.max()


def test_prewarm_changes_no_state(runs):
    """(a) Every state tensor, the key, the rung, the chained record, the
    stats and the telemetry are as they were; only the rung set is new.
    Four calls: the whole ladder (synchronous and pipelined, every rung
    but the live one dispatched) and CLAMP_POTS (fused and classic)."""
    assert len(runs["seen"]) == 4
    for (st_b, host_b), (st_a, host_a) in runs["seen"]:
        assert st_b.keys() == st_a.keys()
        for k in st_b:
            assert torch.equal(st_b[k], st_a[k]), k
        assert host_b["last_chain"] is host_a["last_chain"]
        assert host_b == host_a
    assert runs["ladder_sync"][0]._prewarmed_pots == set(LADDER)
    assert runs["clamp"][0]._prewarmed_pots == set(CLAMP_POTS)


@pytest.mark.parametrize("run", ["ladder_sync", "ladder_pipe"])
def test_whole_ladder_is_a_run_without_prewarm(runs, run):
    """(b) With every rung warmed the clamp never binds: bit for bit the
    synchronous run without prewarm, whose rung moves after LADDER_AT."""
    fs_free, rungs_free = runs["free"]
    assert rungs_free[LADDER_AT] != rungs_free[-1], rungs_free
    fs, rungs = runs[run]
    if run == "ladder_sync":    # a pipelined run moves it frames later
        assert rungs == rungs_free
    assert fs._sel_pot == fs_free._sel_pot
    _bitwise(fs, fs_free)


@pytest.mark.parametrize("fused", [True, False])
def test_clamp_holds_the_rung_and_matches_jax(runs, jax_runs, fused):
    """(c) Without prewarm the rung moves on to 1; with
    prewarm(pots=CLAMP_POTS) it stays, which changes the map; the port's
    keyframes are the JAX package's under the same call."""
    free, clamp = ("free", "clamp") if fused else \
        ("classic_free", "classic_clamp")
    fs_free, rungs_free = runs[free]
    fs, rungs = runs[clamp]
    assert min(rungs_free[CLAMP_AT:]) < min(CLAMP_POTS), rungs_free
    assert set(rungs[CLAMP_AT:]) == set(CLAMP_POTS), rungs
    assert not np.array_equal(fs.trajectory(), fs_free.trajectory())
    fs_j, rungs_j = jax_runs[fused]
    assert rungs_j[CLAMP_AT:] == rungs[CLAMP_AT:]
    _same_keyframes(fs_j, fs)


def test_prewarm_on_an_uninitialized_system_changes_nothing(scene):
    """(d) Before initialization prewarm returns at once: no rung set,
    nothing else touched."""
    fs = FullSystem(synthetic.default_calib(W, H), _settings(TC),
                    device="cpu")
    for i in range(3):
        fs.add_active_frame(scene[0][i], timestamp=i * 0.05, frame_id=i)
    assert not fs.initialized
    before = (_state(fs), _host(fs))
    fs.prewarm()
    assert fs._prewarmed_pots is None
    st, host = _state(fs), _host(fs)
    for k in before[0]:
        assert torch.equal(before[0][k], st[k]), k
    assert before[1] == host


def test_snapshot_keeps_the_rung_set(runs, scene, tmp_path):
    """(e) A port snapshot saved after prewarm resumes bit for bit on the
    clamped run (the set is a `port.*` entry); the JAX layout has no such
    entry and leaves the set unset."""
    imgs = scene[0]
    half = CLAMP_AT + 3
    fs, _ = _port(imgs, prewarm_at=CLAMP_AT, pots=CLAMP_POTS,
                  frames=range(half))
    path = str(tmp_path / "s.npz")
    SNAP.save_snapshot(fs, path)
    fs2 = SNAP.load_snapshot(FullSystem(synthetic.default_calib(W, H),
                                        _settings(TC), device="cpu"), path)
    assert fs2._prewarmed_pots == set(CLAMP_POTS)
    _feed(fs2, imgs, range(half, N_FRAMES))
    _bitwise(fs2, runs["clamp"][0])

    with np.load(path) as data:
        assert SNAP.PORT + "prewarmed_pots" in data.files
        kept = {k: data[k] for k in data.files
                if not k.startswith(SNAP.PORT)}
    jax_path = str(tmp_path / "jax_layout.npz")
    np.savez_compressed(jax_path, **kept)
    fs3 = SNAP.load_snapshot(FullSystem(synthetic.default_calib(W, H),
                                        _settings(TC), device="cpu"),
                             jax_path)
    assert fs3._prewarmed_pots is None


def test_device_trace_writes_a_trace(tmp_path):
    """Telemetry.device_trace on the CPU: one Chrome trace in log_dir that
    names the traced call's op."""
    tel = Telemetry(device="cpu")
    a = torch.rand(64, 64)
    with tel.device_trace(str(tmp_path / "trace")):
        torch.mm(a, a)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "aten::mm" in files[0].read_text()
