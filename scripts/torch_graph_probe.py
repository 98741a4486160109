#!/usr/bin/env python3
"""What the installed PyTorch offers for CUDA graphs of the frame step.

    python3 scripts/torch_graph_probe.py

Prints the versions, whether torch.cuda.CUDAGraph exposes conditional
nodes (if, while), whether numerics.solve / inv (solve_ex, inv_ex) capture
and replay to the eager bits at the tracker's shapes, whether nested if
nodes with allocations inside their bodies replay right for every
predicate, whether a capture in "thread_local" mode survives another
thread launching and allocating on the card, and the card's time a node
of a replayed graph of tiny kernels and of a skipped if node. Needs a
card; exits 2 without one.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from sos_slam_tpu_torch.ops import numerics as NUM
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    G = torch.cuda.CUDAGraph
    names = [m for m in dir(G) if "conditional" in m or "_node" in m]
    print(f"CUDAGraph conditional-node methods: {names}")
    src = os.path.join(os.path.dirname(torch.__file__), "_higher_order_ops")
    for f in sorted(os.listdir(src)):
        if f.endswith(".py"):
            text = open(os.path.join(src, f)).read()
            if "capture_to" in text:
                print(f"  {f} uses: " + ", ".join(sorted(
                    {w.split("(")[0] for w in text.split()
                     if "capture_to" in w})))

    # solve_ex / inv_ex under capture, against eager bits
    g = torch.Generator(device="cpu").manual_seed(0)
    for K in (1, 5):
        J = torch.rand(K, 16, 8, generator=g)
        A = (J.transpose(1, 2) @ J + 1e-3 * torch.eye(8)).to(dev)
        b = torch.rand(K, 8, generator=g).to(dev)
        T = (torch.eye(4) + 0.1 * torch.rand(K, 4, 4, generator=g)).to(dev)
        ref = (NUM.solve(A, b), NUM.inv(T), NUM.inv(T[0]))
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            for _ in range(2):
                NUM.solve(A, b), NUM.inv(T), NUM.inv(T[0])
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = (NUM.solve(A, b), NUM.inv(T), NUM.inv(T[0]))
            graph.replay()
            torch.cuda.synchronize()
            print(f"K={K}: solve_ex / inv_ex captured; replay bit for bit "
                  f"eager: {[torch.equal(a, c) for a, c in zip(outs, ref)]}")
        except Exception as e:  # noqa: BLE001 - the probe reports any fault
            print(f"K={K}: capture of solve_ex / inv_ex failed: "
                  f"{type(e).__name__}: {e}")

    # nested if nodes with allocations inside the bodies
    if hasattr(G, "begin_capture_to_if_node"):
        try:
            x = torch.zeros(64, device=dev)
            p1 = torch.zeros((), dtype=torch.bool, device=dev)
            p2 = torch.zeros((), dtype=torch.bool, device=dev)
            graph = torch.cuda.CUDAGraph()

            @contextlib.contextmanager
            def gate(pred):
                graph.begin_capture_to_if_node(pred)
                try:
                    yield
                finally:
                    graph.end_capture_to_conditional_node()

            def body():
                x.copy_(x + 1.0)
                with gate(p1):
                    y = x * 2.0 + 1.0
                    x.copy_(y)
                    with gate(p2 & (x.sum() > 0)):
                        z = torch.sqrt(x) + y
                        x.copy_(z)
                x.copy_(x - 0.5)

            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                body()
            ok = []
            for a, b_ in ((False, False), (True, False), (True, True),
                          (False, True)):
                x.zero_()
                p1.fill_(a)
                p2.fill_(b_)
                graph.replay()
                ref = torch.ones(64, device=dev)
                if a:
                    y = ref * 2.0 + 1.0
                    ref = y
                    if b_:
                        ref = torch.sqrt(ref) + y
                ref = ref - 0.5
                ok.append(torch.equal(x, ref))
            print(f"nested if nodes with allocations: right for (p1, p2) in "
                  f"FF, TF, TT, FT: {ok}")
            # a skipped if node against a node of a tiny kernel
            n = 500
            v = torch.zeros(16, device=dev)
            off = torch.zeros((), dtype=torch.bool, device=dev)
            g_if, g_plain = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            graph = g_if
            with torch.cuda.graph(g_if):
                for _ in range(n):
                    with gate(off):
                        v.add_(1.0)
            with torch.cuda.graph(g_plain):
                for _ in range(n):
                    v.add_(1.0)
            for name, gg in (("skipped if node", g_if),
                             ("tiny kernel node", g_plain)):
                gg.replay()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(10):
                    gg.replay()
                e1.record()
                torch.cuda.synchronize()
                print(f"{name}: {1e3 * e0.elapsed_time(e1) / (10 * n):.2f} "
                      "us a node (device, replayed graph)")
        except Exception as e:  # noqa: BLE001
            print(f"if nodes failed: {type(e).__name__}: {e}")

    # thread_local capture with another thread launching and allocating
    stop = threading.Event()
    errors = []

    def worker():
        try:
            while not stop.is_set():
                a = torch.rand(256, 256, device=dev)
                (a @ a).sum().item()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    time.sleep(0.2)
    try:
        y = torch.zeros(1024, device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(200):
                y.copy_(torch.sin(y) + 1.0)
        graph.replay()
        torch.cuda.synchronize()
        print("thread_local capture beside a launching thread: captured")
    except Exception as e:  # noqa: BLE001
        print(f"thread_local capture beside a launching thread failed: "
              f"{type(e).__name__}: {e}")
    stop.set()
    th.join(timeout=30)
    print(f"worker thread errors: {errors}; alive {th.is_alive()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
