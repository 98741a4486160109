"""Telemetry: named per-event series, host and device spans on one clock,
and a torch.profiler trace (`device_trace`).

`timers` is the one store of named per-event series: a host span's ms
(`timed`), a device span's ms (`stamped`) or an event's count (`observe`),
one list a name, appended in event order. `records` keeps the last
RECORDS spans as (name, frame, t0_ns, t1_ns) on the host's clock
(`time.perf_counter_ns()`), host and device alike.

Device spans come from the fused frame's stamps (models/fused_graph.py:
%globaltimer written by one-thread kernels at the graph's node
boundaries, riding the frame's pinned readback), handed over in stream
order, one dispatch at a time (`stamped`). `calibrate` maps the device's
clock onto the host's by an offset, from stamps timed between two host
reads; its half round trip is the offset's uncertainty, and the change of
the offset between calibrations its drift (`report()["clock"]`). The gaps
between the device's spans in stream order are the card's idle time
(`dev.idle`); each is put down to the innermost host span open when it
began, or to "outside process" (`report()["idle_by_host"]`, ms). A
calibration closes the device's timeline: the next span opens a new one,
so the time between (a drained pipeline, prewarm's eager work) is not
taken for idle.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

RECORDS = 4096      # the spans `records` keeps
# the fused frame's stamp slots (models/fused_graph.py), in stream order
STAMPS = ("intake.begin", "intake.end", "frame.begin", "track.end",
          "step.end", "chain.end", "frame.end", "post.end")
(INTAKE_BEGIN, INTAKE_END, FRAME_BEGIN, TRACK_END, STEP_END, CHAIN_END,
 FRAME_END, POST_END) = range(len(STAMPS))
OUTSIDE = "outside process"


class Telemetry:
    def __init__(self, device=None):
        """`device`: the run's device; `device_trace` records the card's
        activity when it is a CUDA device."""
        self.timers: Dict[str, List[float]] = defaultdict(list)
        self.records = collections.deque(maxlen=RECORDS)
        self.idle_by_host: Dict[str, float] = defaultdict(float)
        self.device = device
        self.clock = None       # the last calibration (`calibrate`)
        self._counts = set()    # the names fed by `observe`
        self._open = []         # the host spans open: (name, t0_ns)
        self._busy_end = None   # the end of the last device span (host ns)
        self._post = None       # (frame, frame.end) of the dispatch before

    # ------------------------------------------------------------------
    # host spans and counts
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def timed(self, name: str, frame=None):
        """The block as the host span `name` of frame id `frame`."""
        t0 = time.perf_counter_ns()
        self._open.append((name, t0))
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self._open.pop()
            self.timers[name].append((t1 - t0) * 1e-6)
            self.records.append((name, frame, t0, t1))

    def observe(self, name: str, value) -> None:
        """One event's count into the series `name`."""
        self._counts.add(name)
        self.timers[name].append(float(value))

    # ------------------------------------------------------------------
    # the device's clock and spans
    # ------------------------------------------------------------------
    def calibrate(self, pairs) -> None:
        """Map the device's clock onto the host's from `pairs` of
        `ops/control.py::clock_pair` (host before, device, host after):
        the tightest pair's midpoint. Closes the device's timeline."""
        t0, dev, t1 = min(pairs, key=lambda p: p[2] - p[0])
        offset = dev - (t0 + t1) // 2
        last = self.clock
        drift = ppm = 0.0
        if last is not None and t1 > last["host_ns"]:
            drift = float(offset - last["offset_ns"])
            ppm = 1e6 * drift / (t1 - last["host_ns"])
        self.clock = dict(offset_ns=offset, uncertainty_ns=(t1 - t0) / 2,
                          host_ns=t1, drift_ns=drift, drift_ppm=ppm,
                          calibrations=(last["calibrations"] + 1
                                        if last else 1))
        self._close()

    def _close(self) -> None:
        """End the device's timeline (the next span opens a new one)."""
        self._busy_end = self._post = None

    def stamped(self, frame, stamps, intake: bool, whole: bool,
                opens: bool = False) -> None:
        """One dispatch of the fused frame `frame` from its device stamps
        (the STAMPS slots, device ns; 0 where a slot was not reached), in
        stream order after the dispatch before it: that one's post span
        (its `post.end` rides this readback), the intake where this
        dispatch carried it (`intake`: the frame's first), the frame, and
        with `whole` (a completed dispatch, not one dropped unfetched)
        its stages: `dev.track`, `dev.trace` and, where the chain ran,
        `dev.chain`. `opens`: the frame opens a new timeline (its dispatch
        captured a graph first, whose warm-up ran unstamped)."""
        off = self.clock["offset_ns"]
        s = [int(x) - off if x else None for x in stamps]
        if self._post is not None and s[POST_END] is not None:
            self._span("dev.post", *self._post, s[POST_END])
        self._post = None
        if intake and s[INTAKE_BEGIN] is not None \
                and s[INTAKE_END] is not None:
            self._span("dev.intake", frame, s[INTAKE_BEGIN], s[INTAKE_END])
        if s[FRAME_BEGIN] is None or s[FRAME_END] is None:
            return
        if opens:
            self._close()
        self._span("dev.frame", frame, s[FRAME_BEGIN], s[FRAME_END])
        if whole:
            self._inner("dev.track", frame, s[FRAME_BEGIN], s[TRACK_END])
            self._inner("dev.trace", frame, s[TRACK_END], s[STEP_END])
            if s[CHAIN_END] is not None:
                self._inner("dev.chain", frame, s[STEP_END], s[CHAIN_END])
        self._post = (frame, s[FRAME_END])

    def ended(self, post_end) -> None:
        """The `post.end` stamp of the last dispatch (read once the card
        is idle), then the timeline closed."""
        if self._post is not None and post_end:
            self._span("dev.post", *self._post,
                       int(post_end) - self.clock["offset_ns"])
        self._close()

    def _inner(self, name, frame, t0, t1) -> None:
        if t0 is not None and t1 is not None:
            self.timers[name].append((t1 - t0) * 1e-6)
            self.records.append((name, frame, t0, t1))

    def _span(self, name, frame, t0, t1) -> None:
        """A device span in stream order: the gap since the one before is
        idle, put down to the host span open when it began."""
        end = self._busy_end
        if end is not None and t0 > end:
            self._inner("dev.idle", frame, end, t0)
            self.idle_by_host[self._blame(end)] += (t0 - end) * 1e-6
        self._inner(name, frame, t0, t1)
        self._busy_end = t1 if end is None else max(end, t1)

    def _blame(self, t: int) -> str:
        """The innermost host span open at host time `t`: of those that
        closed since (`records` holds them in the order they closed), the
        last opened; else of those still open; else OUTSIDE."""
        best = None
        for name, _, t0, t1 in reversed(self.records):
            if name.startswith("dev."):
                continue
            if t1 <= t:
                break
            if t0 <= t and (best is None or t0 > best[1]):
                best = (name, t0)
        if best is not None:
            return best[0]
        for name, t0 in reversed(self._open):
            if t0 <= t:
                return name
        return OUTSIDE

    # ------------------------------------------------------------------
    def report(self) -> Dict:
        """The series by name (n, mean, median, max): "timers_ms" the
        spans' ms, "counts" the counts; "clock", the last calibration;
        "idle_by_host", the card's idle ms by the host span it began in."""
        out = {"timers_ms": {}, "counts": {}}
        for k, v in self.timers.items():
            a = np.asarray(v)
            out["counts" if k in self._counts else "timers_ms"][k] = dict(
                n=len(v), mean=float(a.mean()) if len(v) else 0.0,
                median=float(np.median(a)) if len(v) else 0.0,
                max=float(a.max()) if len(v) else 0.0,
            )
        if self.clock is not None:
            out["clock"] = dict(self.clock)
        if self.idle_by_host:
            out["idle_by_host"] = dict(sorted(self.idle_by_host.items()))
        return out

    @contextlib.contextmanager
    def device_trace(self, log_dir: str):
        """torch.profiler over the block (the counterpart of the JAX
        package's jax.profiler trace): host activity, and the card's when
        the run's device is CUDA, written as one Chrome trace
        `trace.<pid>.<ns>.json` into `log_dir`. Yields the profiler.

        On a card the profiler may drop the first device events of a
        window, more the longer the process has lived
        (scripts/torch_profiler_drops.py measures it): a trace that must
        hold every kernel of the block opens with throwaway launches, as
        chip_smoke.py's windows do."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        cuda = self.device is not None \
            and torch.device(self.device).type == "cuda"
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))
