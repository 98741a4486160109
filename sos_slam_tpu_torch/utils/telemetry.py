"""Timing + counter telemetry (the port's copy of sos_slam_tpu's).

Named timer vectors, named counters and a quiet-gated logger, after the
reference's TimeVectors and `statistics_num*` counters, plus a
torch.profiler trace for device-side analysis (`device_trace`). Host wall
clock: callers that time device work synchronise first.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


class Telemetry:
    def __init__(self, quiet: bool = True, device=None):
        """`device`: the run's device; `device_trace` records the card's
        activity when it is a CUDA device."""
        self.timers: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, int] = defaultdict(int)
        self.quiet = quiet
        self.device = device

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
