"""utils/telemetry.py's bookkeeping on made-up timelines (the clock's
calibration, the device spans of a dispatch's stamps, the idle gaps and
the host span each is put down to, the bounded records), ops/control.py's
stamp on the CPU, and the benchmark's readers of the new series
(benchmark/metrics/) on an empty and on a made-up window. The stamps of
real fused frames: tests/test_torch_fused_frame.py and
tests/test_torch_fused_frame_vio.py."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import manifest as MF
from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.utils import telemetry as TM
from sos_slam_tpu_torch.utils.telemetry import Telemetry


def _stamps(**at):
    """The STAMPS slots by name (dots as underscores), 0 elsewhere."""
    return [at.get(n.replace(".", "_"), 0) for n in TM.STAMPS]


def _span(tel, name, frame, t0, t1):
    """A closed host span as `timed` leaves it."""
    tel.timers[name].append((t1 - t0) * 1e-6)
    tel.records.append((name, frame, t0, t1))


def _calibrated(offset=0):
    tel = Telemetry()
    tel.calibrate([(1000, 1000 + offset, 1000)])
    return tel


def test_calibration_offset_uncertainty_and_drift():
    """The tightest pair's midpoint sets the offset, its half round trip
    the uncertainty; a later calibration's change of offset is the drift,
    in ns and in ppm of the host time between."""
    tel = Telemetry()
    tel.calibrate([(0, 5_000_600, 1_000), (10, 5_000_060, 110)])
    c = tel.report()["clock"]
    assert (c["offset_ns"], c["uncertainty_ns"]) == (5_000_000, 50)
    tel.calibrate([(1_000_000_110, 1_005_000_160, 1_000_000_130)])
    c = tel.report()["clock"]
    assert c["offset_ns"] == 5_000_040 and c["drift_ns"] == 40.0
    assert c["drift_ppm"] == pytest.approx(0.04, rel=1e-6)
    assert c["calibrations"] == 2


def test_a_dispatch_gives_its_spans_in_stream_order():
    """Intake, frame and its stages mapped by the offset; the post span
    closed by the next dispatch's post.end; a skipped chain (0) gives no
    `dev.chain`; a dispatch dropped unfetched gives its frame span (busy
    time) but no stages; an intake only where the dispatch carried it;
    the gaps between spans are `dev.idle`."""
    tel = _calibrated(offset=7)
    s1 = _stamps(intake_begin=107, intake_end=117, frame_begin=127,
                 track_end=137, step_end=147, chain_end=177, frame_end=187,
                 post_end=3)
    tel.stamped(1, s1, intake=True, whole=True)
    assert [(n, f, t0, t1) for n, f, t0, t1 in tel.records] == [
        ("dev.intake", 1, 100, 110), ("dev.idle", 1, 110, 120),
        ("dev.frame", 1, 120, 180), ("dev.track", 1, 120, 130),
        ("dev.trace", 1, 130, 140), ("dev.chain", 1, 140, 170)]
    # dropped unfetched: its frame, no stages; its intake from slots 0-1
    # is the next frame's, not its own
    s2 = _stamps(intake_begin=999, intake_end=999, frame_begin=207,
                 track_end=217, step_end=227, frame_end=237, post_end=197)
    tel.stamped(2, s2, intake=False, whole=False)
    s3 = _stamps(intake_begin=999, intake_end=999, frame_begin=257,
                 track_end=267, step_end=277, frame_end=287, post_end=247)
    tel.stamped(2, s3, intake=False, whole=True)
    tel.ended(297)
    t = tel.timers
    assert t["dev.post"] == [pytest.approx(1e-5)] * 3
    assert t["dev.frame"] == [pytest.approx(6e-5), pytest.approx(3e-5),
                              pytest.approx(3e-5)]
    assert len(t["dev.track"]) == len(t["dev.trace"]) == 2
    assert len(t["dev.chain"]) == 1 and len(t["dev.intake"]) == 1
    # gaps: intake-frame 10, post-frame 10, post-frame 10
    assert t["dev.idle"] == [pytest.approx(1e-5)] * 3
    # the timeline is closed: the next dispatch's post.end closes nothing
    tel.stamped(3, _stamps(frame_begin=407, frame_end=417, post_end=397),
                intake=False, whole=True)
    assert len(t["dev.post"]) == 3 and len(t["dev.idle"]) == 3


def test_idle_is_put_down_to_the_innermost_host_span():
    """Each gap goes to the innermost host span open when it began: a
    closed one (the last opened of those holding the time), else one still
    open, else "outside process"."""
    tel = _calibrated()
    _span(tel, "node.upload", 5, 10, 30)
    _span(tel, "node.intake", 5, 5, 40)
    _span(tel, "complete", 2, 45, 60)
    _span(tel, "frame", 5, 42, 80)
    _span(tel, "node.process", 5, 0, 90)
    tel._open.append(("node.process", 95))
    # gap 1 begins at 20 (upload, inside intake and process), gap 2 at 50
    # (complete, inside frame), gap 3 at 92 (between two process spans)
    # and gap 4 at 96 (the open process span)
    tel.stamped(5, _stamps(intake_begin=1, intake_end=20, frame_begin=25,
                           frame_end=50), intake=True, whole=False)
    tel.stamped(6, _stamps(frame_begin=55, frame_end=92, post_end=50),
                intake=False, whole=False)
    tel.stamped(7, _stamps(frame_begin=94, frame_end=96, post_end=92),
                intake=False, whole=False)
    tel.stamped(8, _stamps(frame_begin=99, frame_end=100, post_end=96),
                intake=False, whole=False)
    got = tel.report()["idle_by_host"]
    assert got == {"node.upload": pytest.approx(5e-6),
                   "complete": pytest.approx(5e-6),
                   TM.OUTSIDE: pytest.approx(2e-6),
                   "node.process": pytest.approx(3e-6)}


def test_spans_carry_frames_and_records_are_bounded():
    """`timed` records (name, frame, t0, t1) on the host's clock and its
    ms in the series; `observe` feeds a count series, reported apart; the
    records keep the last RECORDS spans."""
    tel = Telemetry()
    with tel.timed("node.process", 3):
        with tel.timed("node.intake", 3):
            pass
    (n1, f1, a1, b1), (n2, f2, a2, b2) = tel.records
    assert (n1, f1, n2, f2) == ("node.intake", 3, "node.process", 3)
    assert a2 <= a1 <= b1 <= b2 and not tel._open
    tel.observe("track.retry", True)
    rep = tel.report()
    assert rep["counts"]["track.retry"]["n"] == 1
    assert set(rep["timers_ms"]) == {"node.intake", "node.process"}
    for i in range(TM.RECORDS + 10):
        with tel.timed("x", i):
            pass
    assert len(tel.records) == TM.RECORDS
    assert tel.records[-1][1] == TM.RECORDS + 9
    assert len(tel.timers["x"]) == TM.RECORDS + 10


def test_stamp_and_clock_pair_on_the_cpu():
    """On the CPU a stamp is the host clock at the call, so a clock pair
    lies between its two host reads (offset within the uncertainty)."""
    buf = torch.zeros(3, dtype=torch.int64)
    control.stamp(buf, 1)
    t0, dev, t1 = control.clock_pair(buf, 2)
    assert 0 < int(buf[1]) <= t0 <= dev <= t1 and buf[0] == 0
    tel = Telemetry()
    tel.calibrate([(t0, dev, t1)])
    c = tel.clock
    assert abs(c["offset_ns"]) <= c["uncertainty_ns"] + 1


# what each new reader gives on a made-up window of three frames
_SERIES = {
    "dev.intake": [1.0, 2.0, 3.0], "node.intake": [5.0, 5.0, 5.0],
    "node.upload": [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
    "dev.track": [4.0, 5.0, 6.0], "dev.trace": [1.0, 1.0, 4.0],
    "dev.chain": [10.0], "dev.frame": [10.0, 10.0, 20.0],
    "dev.post": [1.0, 1.0, 1.0], "dev.idle": [2.0, 2.0, 2.0],
    "track.lm_trips": [10.0, 12.0, 20.0], "track.retry": [0.0, 1.0, 0.0],
    "ba.gn_its": [6.0, 8.0],
}
_WANT = dict(intake_dev_ms=2.0, upload_ms=4.0, track_dev_ms=5.0,
             trace_dev_ms=2.0, chain_dev_ms=10.0,
             stamp_idle_pct=100.0 * 6.0 / (6.0 + 6.0 + 40.0 + 3.0),
             lm_trips=14.0, retry_pct=100.0 / 3.0, gn_its=7.0)


@pytest.mark.parametrize("name", sorted(_WANT))
def test_metric_readers_of_the_stamped_series(name):
    """Each reader gives None on a window that holds nothing to read (the
    program before the stamps) and its value on a made-up one."""
    read = MF.reader(name)
    assert read(SimpleNamespace(timers_ms={})) is None
    assert read(SimpleNamespace(timers_ms=dict(_SERIES))) == \
        pytest.approx(_WANT[name])
