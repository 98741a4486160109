"""How many device events torch.profiler drops from the start of a window,
as a process ages: every --every seconds for --seconds, one window of 30
K1 calls (640x480, 4 levels) as it is, and one opened by 300 throwaway
launches; prints the launches of each kind that the profiler kept.

    python3 scripts/torch_profiler_drops.py [--seconds 60] [--every 10]

Needs a CUDA card (K1 is built at first use). Between windows the card
runs small matrix products, as a SLAM run keeps it busy.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from sos_slam_tpu_torch.ops import image as IMG  # noqa: E402


def window(fn, spin, prelude):
    """{kernel name: launches kept} of 30 calls of fn behind `prelude`
    calls of spin."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prelude):
            spin()
        torch.cuda.synchronize()
        for _ in range(30):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][-24:]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--every", type=float, default=10.0)
    args = ap.parse_args()
    dev = torch.device("cuda")
    img = torch.rand(480, 640, device=dev) * 255
    x = torch.rand(256, 256, device=dev)
    z = torch.zeros(16, device=dev)

    def fn():
        return IMG.pyramid_levels(img, 4)

    def spin():
        z.add_(1)

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        print(json.dumps({"t_s": round(time.perf_counter() - t0, 1),
                          "bare": window(fn, spin, 0),
                          "prelude_300": window(fn, spin, 300)}), flush=True)
        t = time.perf_counter()
        while time.perf_counter() - t < args.every:
            for _ in range(200):
                x = (x @ x).clamp_(-1, 1)
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
