"""The invalidation paths of the port's pipelined fused driver
(`FullSystem._drain_pending`): tests/test_pipeline_invalidation.py on the
port. Fallback tracking and a selector-rung change must reprocess or
dispatch again the frames in flight so that the depth-3 pipeline stays bit
for bit the synchronous path, and a loss in the middle of the pipeline
must drain cleanly. Each test makes its event happen and asserts that the
path really ran with frames in flight."""

import numpy as np
import torch

from sos_slam_tpu_torch.models.full_system import FullSystem
from sos_slam_tpu_torch.utils import synthetic
from sos_slam_tpu_torch.utils.config import default_settings
from tests.test_torch_helpers import exact

torch.set_num_threads(2)

W, H = 256, 192
N_FRAMES = 26
ROLL_FRAME = 14      # after initialization, mid-sequence
TWIST = (0.05, 0.02, 0.03, 0.003, 0.006, 0.002)


def _settings(**kw):
    base = dict(max_window_frames=8, max_points=512, max_immature=1024,
                max_track_pts=4096, desired_point_density=400.0,
                desired_immature_density=400.0)
    base.update(kw)
    return default_settings(**base)


def _sequence(roll_frame=None, roll_px=0):
    calib = synthetic.default_calib(W, H)
    imgs, _, _ = synthetic.make_sequence(calib, N_FRAMES, TWIST,
                                         plane_z=2.0, device="cpu")
    imgs = [im.clone() for im in imgs]
    if roll_frame is not None:
        # an unmodelled jump: every motion hypothesis is far off, the
        # step refuses the frame and fallback tracking runs
        imgs[roll_frame] = torch.roll(imgs[roll_frame], roll_px, 1)
    return imgs


def _run(imgs, pipeline, settings=None):
    """Returns (fs, events): per completion (redo, frames still in flight
    after it, whether it moved the selector rung); per dispatch made again
    inside `_drain_pending`, the completion that caused it; and the
    selector rung after every frame."""
    fs = FullSystem(synthetic.default_calib(W, H), settings or _settings(),
                    device="cpu")
    fs.pipeline = pipeline
    events = dict(completions=[], redispatched=[], pots=[], draining=False)
    complete, drain, dispatch = (fs._complete_fused, fs._drain_pending,
                                 fs._dispatch_fused)

    def counted(rec):
        in_flight, pot = len(fs._pending_fused), fs._sel_pot
        redo = complete(rec)
        events["completions"].append((bool(redo), in_flight,
                                      fs._sel_pot != pot))
        return redo

    def draining(depth):
        events["draining"] = True
        try:
            drain(depth)
        finally:
            events["draining"] = False

    def dispatched(*a, **kw):
        if events["draining"]:
            events["redispatched"].append(events["completions"][-1])
        return dispatch(*a, **kw)

    fs._complete_fused = counted
    fs._drain_pending = draining
    fs._dispatch_fused = dispatched
    for i, im in enumerate(imgs):
        fs.add_active_frame(im, timestamp=i * 0.05, frame_id=i)
        events["pots"].append(fs._sel_pot)
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    return fs, events


def _assert_bitwise_equal(fs_s, fs_p):
    traj_s, traj_p = fs_s.trajectory(), fs_p.trajectory()
    assert traj_s[:, 0].astype(int).tolist() == \
        traj_p[:, 0].astype(int).tolist(), "keyframe sets differ"
    exact(traj_s[:, 1:4], traj_p[:, 1:4])
    exact(fs_s.ba.state, fs_p.ba.state)
    exact(fs_s.ba.pt_valid, fs_p.ba.pt_valid)
    exact(fs_s.imm.valid, fs_p.imm.valid)


def test_fallback_track_reprocesses_in_flight_frames():
    imgs = _sequence(roll_frame=ROLL_FRAME, roll_px=40)
    fs_s, ev_s = _run(imgs, pipeline=False)
    fs_p, ev_p = _run(imgs, pipeline=True)
    assert not fs_p.is_lost and not fs_p.init_failed
    # the rolled frame sent the step to fallback tracking...
    assert any(r for r, _, _ in ev_s["completions"]), "no fallback in sync"
    # ...and in the pipelined run it did so with frames in flight, which
    # were processed again
    assert any(r and q >= 2 for r, q, _ in ev_p["redispatched"]), \
        ev_p["completions"]
    _assert_bitwise_equal(fs_s, fs_p)


def test_selector_rung_change_redispatches_in_flight_frames():
    imgs = _sequence()
    # a density target far above what the scene gives at the default rung
    # makes the one-rung-a-keyframe density adaptation move (towards more
    # selections: the starving direction loses tracking)
    s = _settings(desired_immature_density=1200.0,
                  desired_point_density=450.0)
    fs_s, _ = _run(imgs, pipeline=False, settings=s)
    fs_p, ev_p = _run(imgs, pipeline=True, settings=s)
    assert not fs_p.is_lost and not fs_p.init_failed
    assert len(set(ev_p["pots"])) > 1, "the selector rung never moved"
    # a rung change with frames in flight dispatched some of them again
    # (from the first keyframe among them on)
    assert any(moved and q >= 2 for _, q, moved in ev_p["redispatched"]), \
        ev_p["completions"]
    assert fs_p.telemetry.report()["timers_ms"]["redispatch"]["n"] >= 1
    # no fallback in this scene: the rung path alone keeps the pipeline
    # bit for bit the synchronous path
    assert not any(r for r, _, _ in ev_p["completions"])
    _assert_bitwise_equal(fs_s, fs_p)


def test_lost_mid_pipeline_drains_cleanly():
    imgs = _sequence()
    # a non-finite frame mid-pipeline: every hypothesis' residual is NaN
    imgs[ROLL_FRAME] = torch.full_like(imgs[ROLL_FRAME], float("nan"))
    fs_p, ev = _run(imgs, pipeline=True)
    assert fs_p.is_lost
    assert len(fs_p._pending_fused) == 0      # the queue drained
    # the loss came with frames in flight, and no later frame was
    # processed
    assert ev["completions"][-1][:2] == (True, fs_p.pipeline_depth)
    assert len(fs_p.shells) <= ROLL_FRAME + fs_p.pipeline_depth + 1
    assert not any(sh.id > ROLL_FRAME and sh.pose_valid and
                   np.any(sh.cam_to_world != np.eye(4))
                   for sh in fs_p.shells)
