"""The comparison that decides `correct`, driven through the rest of a run
on the CPU at a small size (the harness's look for a card skipped): a
sound run is correct; the control and each fault planted in the program's
timed path make it false.

The faults a SLAM cell can have, planted from the window on (armed when
`prewarm()` returns):
- the frame step returns its state unchanged: every published pose is
  the previous frame's;
- an answer altered where it is produced: every third frame's pose turned
  by 20 mrad before it is published;
- half of the batch left out: the lower half of each rectified frame
  zeroed in the intake.
One card has no exchange between chips to leave out."""

import copy
import time

import numpy as np
import pytest

from benchmark.harness import manifest as MF
from benchmark.harness.runner import RunFailed, run

SMALL = MF.BENCH_DIR / "tests" / "data"


def small_cell(name: str) -> MF.Cell:
    """The cell at 376x240 raw (320x240 rectified) and a 20 s period: the
    same code paths, a CPU's size."""
    cell = copy.deepcopy(MF.resolve(name))
    n = len(cell.config["calib"])
    cell.config["calib"] = [str(SMALL / f"small_cam{i}.txt")
                            for i in range(n)]
    cell.traffic.update(period_s=20, translation_harmonics=[3, 2, 4],
                        rotation_harmonics=[3, 3, 2], intake_samples=2,
                        intake_sample_span=3, window_start_frame=120)
    return cell


def arm(monkeypatch, fault: str):
    from sos_slam_tpu_torch.io import undistort as UD
    from sos_slam_tpu_torch.models.full_system import FullSystem
    armed = {"on": False, "last": None}
    prewarm = FullSystem.prewarm

    def prewarm_then_arm(self, *a, **kw):
        prewarm(self, *a, **kw)
        armed["on"] = True

    monkeypatch.setattr(FullSystem, "prewarm", prewarm_then_arm)
    if fault in ("unchanged", "altered"):
        finish = FullSystem._finish_step_host

        def finish_step_host(self, p, out, accept, T_cw_new):
            got = finish(self, p, out, accept, T_cw_new)
            shell = p["shell"]
            if armed["on"]:
                if fault == "unchanged" and armed["last"] is not None:
                    shell.cam_to_world = armed["last"].copy()
                elif fault == "altered" and shell.id % 3 == 0:
                    c, s = np.cos(0.02), np.sin(0.02)
                    turn = np.array([[1, 0, 0, 0], [0, c, -s, 0],
                                     [0, s, c, 0], [0, 0, 0, 1.0]])
                    shell.cam_to_world = shell.cam_to_world @ turn
            armed["last"] = np.array(shell.cam_to_world)
            return got

        monkeypatch.setattr(FullSystem, "_finish_step_host",
                            finish_step_host)
    elif fault == "half_frame":
        undistort = UD.Undistorter.undistort

        def half(self, image):
            out = undistort(self, image)
            if armed["on"]:
                out = out.clone()
                out[out.shape[0] // 2:] = 0.0
            return out

        monkeypatch.setattr(UD.Undistorter, "undistort", half)


def one_run(cell, control=None):
    try:
        return run(cell, 2 ** 33 + 17, 10.0, False, "cpu",
                   time.perf_counter(), control=control)
    except RunFailed:
        return None


def test_a_sound_run_is_correct():
    res = one_run(small_cell("euroc_mono.cruise"))
    assert res is not None and res["correct"], res and res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_frame",
                                   "control"])
def test_a_fault_or_the_control_is_not_correct(monkeypatch, fault):
    cell = small_cell("euroc_mono.cruise")
    if fault == "control":
        res = one_run(cell, control="tf32")
    else:
        arm(monkeypatch, fault)
        res = one_run(cell)
    assert res is None or not res["correct"], res["checks"]
