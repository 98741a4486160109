"""Device time of one kernel call with the queue full (copied from the
program's chip_smoke.py, where it was sound): a pair of CUDA events around
n back-to-back calls that were enqueued while a sleeping kernel held the
stream, so the host's launch cost is hidden. No profiler."""

from __future__ import annotations

import time
from typing import Callable, List

QUEUED = 200


def queued_ms(torch, fn: Callable, n: int = QUEUED,
              repeats: int = 3) -> List[float]:
    """Device ms a call of `fn`, `repeats` times. The queue held only if
    the sleep had not ended when the host enqueued the last call (the
    first event not yet reached); a repeat whose queue ran dry is taken
    again with twice the sleep, up to four times, then an error."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    khz = torch.cuda.get_device_properties(0).clock_rate
    cycles = int((1.5 * host_s + 0.005) * khz * 1e3)
    out = []
    for _ in range(repeats):
        for _ in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            for _ in range(n):
                fn()
            held = not a.query()
            b.record()
            b.synchronize()
            if held:
                out.append(a.elapsed_time(b) / n)
                break
            cycles *= 2
        else:
            raise RuntimeError("the queue ran dry behind four sleeps")
    return out
