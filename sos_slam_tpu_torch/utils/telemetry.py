"""Timing + counter telemetry (the port's copy of sos_slam_tpu's).

Named timer vectors, named counters and a quiet-gated logger, after the
reference's TimeVectors and `statistics_num*` counters. Host wall clock:
callers that time device work synchronise first.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


class Telemetry:
    def __init__(self, quiet: bool = True):
        self.timers: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, int] = defaultdict(int)
        self.quiet = quiet

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name].append((time.perf_counter() - t0) * 1000.0)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def log(self, msg: str):
        if not self.quiet:
            print(msg, flush=True)

    def report(self) -> Dict:
        out = {"counters": dict(self.counters), "timers_ms": {}}
        for k, v in self.timers.items():
            a = np.asarray(v)
            out["timers_ms"][k] = dict(
                n=len(v), mean=float(a.mean()) if len(v) else 0.0,
                median=float(np.median(a)) if len(v) else 0.0,
                max=float(a.max()) if len(v) else 0.0,
            )
        return out
