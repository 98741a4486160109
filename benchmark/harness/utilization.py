"""The card's kernel-busy utilization, sampled by NVML every ~100 ms through
a window: `torch.cuda.utilization()` where pynvml is present, else
`nvidia-smi` in a subprocess of its own, ended with the window. NVML sees
kernels inside conditional graph nodes, which torch.profiler does not
show in full."""

from __future__ import annotations

import subprocess
import threading
from typing import List, Optional


class Sampler:
    def __init__(self, torch, device, period_s: float = 0.1):
        self.torch = torch
        self.device = device
        self.period_s = period_s
        self.samples: List[float] = []
        self.how = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        try:
            self.torch.cuda.utilization(self.device)
            self.how = "pynvml"
            self._thread = threading.Thread(target=self._poll, daemon=True)
        except Exception:       # no pynvml: read nvidia-smi's stream
            uuid = str(self.torch.cuda.get_device_properties(
                self.device).uuid)
            ident = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
            self._proc = subprocess.Popen(
                ["nvidia-smi", "-i", ident,
                 "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits",
                 f"--loop-ms={int(self.period_s * 1000)}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            self.how = "nvidia-smi"
            self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        while not self._stop.wait(self.period_s):
            self.samples.append(float(
                self.torch.cuda.utilization(self.device)))

    def _read(self) -> None:
        for line in self._proc.stdout:
            line = line.strip()
            if line and not self._stop.is_set():
                try:
                    self.samples.append(float(line))
                except ValueError:
                    pass

    def stop(self) -> List[float]:
        self._stop.set()
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        if self._thread is not None:
            self._thread.join(timeout=10)
        return self.samples
