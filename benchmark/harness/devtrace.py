"""The device trace of a traced run: torch.profiler over a short segment of
frames after the measured window (so the profiler's own cost stays out of
the window's spans), reduced to the seconds the card was busy, the
segment's length, the device operations that took most time, and the
longest idle gaps named by what the host was doing.

torch.profiler shows a WHILE node's body once per entry and, late in a
process that made many conditional nodes, loses records inside them: the
busy seconds from it are a floor. `device_idle_pct` reads NVML instead."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

SPAN_NAMES = ("SlamNode.process", "FullSystem.add_active_frame",
              "FullSystem.finish_pending")


def _merge(intervals: List[Tuple[float, float]]):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_segment(torch, device, body: Callable[[], None]) -> Dict:
    """Run `body` (which feeds frames and drains them) under the profiler.
    Returns busy_s, window_s and the breakdown lists."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev_iv, by_name = [], defaultdict(float)
    host = []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in SPAN_NAMES or getattr(e, "is_user_annotation",
                                               False):
                continue        # a range's shadow on the device, no work
            dev_iv.append((a, b))
            by_name[e.name[:80]] += (b - a) * 1e-6
        elif e.device_type == DeviceType.CPU:
            host.append((a, b, e.name))
    merged = _merge(dev_iv)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    spans = [h for h in host if h[2] in SPAN_NAMES]
    ops = [h for h in host if h[2] not in SPAN_NAMES]
    gaps = []
    for (_, end), (start, _) in zip(merged, merged[1:]):
        gaps.append((start - end, end))
    gaps.sort(reverse=True)
    idle = []
    for length, at in gaps[:10]:
        idle.append([_doing(spans, ops, at), length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_s, window_s=window_s,
                device_ops=[[n, s] for n, s in top], idle_gaps=idle)


def _doing(spans, ops, at: float) -> str:
    """The innermost benchmark span and host operation running at `at`."""
    def innermost(events):
        best = None
        for a, b, name in events:
            if a <= at <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else None
    span = innermost(spans) or "between frames"
    op = innermost(ops)
    return f"{span}: {op}" if op else span
