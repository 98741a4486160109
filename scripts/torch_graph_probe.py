#!/usr/bin/env python3
"""What the installed PyTorch offers for CUDA graphs of the frame step.

    python3 scripts/torch_graph_probe.py

Prints the versions, whether torch.cuda.CUDAGraph exposes conditional
nodes (if, while; it does not), whether numerics.solve / inv (solve_ex,
inv_ex) capture and replay to the eager bits at the tracker's shapes, the
conditional nodes that ops/control.py opens inside torch's capture
through the driver API (csrc/graph_cond.cu), each case held bit for bit
to its eager form and to the plain twin (`control_cases`: an IF taken and
skipped, an IF with an else, nested IFs with allocations in the bodies,
five bodies deep as the fused frame's deepest path nests them, a WHILE of
no trip, one that reaches its cap, one whose trips the data set,
the launch counters credited from the device's run counts and the setter
launches counted on the device), the card's time of a skipped IF node, of a WHILE trip and of a node of a tiny
kernel (`node_costs`), what torch.profiler reports of the kernels inside
conditional nodes (`profiler_view`), and whether a capture in "thread_local" mode
survives another thread launching and allocating on the card. Needs a
card; exits 2 without one.
"""

from __future__ import annotations

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
    from sos_slam_tpu_torch.ops import control
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

    # conditional nodes opened inside torch's capture (ops/control.py)
    print(f"driver CUDA {control.driver_version()}; torch._C "
          f"_cuda_beginAllocateCurrentThreadToPool "
          f"{hasattr(torch._C, '_cuda_beginAllocateCurrentThreadToPool')}, "
          f"_cuda_endAllocateToPool "
          f"{hasattr(torch._C, '_cuda_endAllocateToPool')}, "
          f"_cuda_releasePool {hasattr(torch._C, '_cuda_releasePool')}")
    for name, ok, detail in control_cases(dev):
        print(f"control {name}: bit for bit eager {ok} ({detail})")
    for k, v in node_costs(dev).items():
        print(f"control {k}: {v:.3f} us (device, replayed graph)")
    for k, (seen, rule) in profiler_view(dev).items():
        print(f"torch.profiler, K1 launches: {k}: seen {seen}, by the "
              f"rule {rule}")

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


def _captured(dev, fn):
    """Warm `fn` up on a side stream, then capture it through
    control.capture into a graph of its own pool. Returns the graph."""
    import torch
    from sos_slam_tpu_torch.ops import control
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with control.capture(g, torch.cuda.graph_pool_handle(), side):
        fn()
    torch.cuda.synchronize(dev)
    return g


def control_cases(dev):
    """Each conditional-node case of ops/control.py, captured and replayed
    on the card for every input it is given, against its eager form (the
    host reads the condition) and its plain twin (control's uncaptured
    form). Returns [(name, bit for bit, detail)]."""
    import torch
    from sos_slam_tpu_torch.ops import control
    from sos_slam_tpu_torch.ops import image as IMG
    out = []
    x = torch.zeros(256, device=dev)
    v = torch.zeros(256, device=dev)
    src = torch.zeros(256, device=dev)
    p1 = torch.zeros((), dtype=torch.bool, device=dev)
    p2 = torch.zeros((), dtype=torch.bool, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    inputs = torch.randn(4, 256, generator=gen).to(dev)

    def run_case(name, body, eager, feeds):
        g = _captured(dev, body)
        ok = []
        for feed in feeds:
            feed()
            g.replay()
            torch.cuda.synchronize(dev)
            got = v.clone()
            feed()
            eager()
            ref = v.clone()
            feed()
            body()           # the plain twin, uncaptured
            ok.append(torch.equal(got, ref) and torch.equal(v, ref))
        out.append((name, all(ok), f"{len(feeds)} inputs: {ok}"))

    def feed_of(i, a, b):
        def feed():
            src.copy_(inputs[i])
            v.zero_()
            p1.fill_(a)
            p2.fill_(b)
        return feed

    flags = [(False, False), (True, False), (True, True), (False, True)]
    feeds = [feed_of(i, a, b) for i, (a, b) in enumerate(flags)]

    # IF without else: the body allocates and writes v
    def if_body():
        control.cond(p1, lambda: torch.sin(src) * 2.0 + 1.0, None, out=v)

    def if_eager():
        if bool(p1):
            v.copy_(torch.sin(src) * 2.0 + 1.0)
    run_case("IF", if_body, if_eager, feeds)

    # IF with an else body
    def ifelse_body():
        control.cond(p1, lambda: torch.sin(src), lambda: torch.cos(src) - 3,
                     out=v)

    def ifelse_eager():
        v.copy_(torch.sin(src) if bool(p1) else torch.cos(src) - 3)
    run_case("IF/else", ifelse_body, ifelse_eager, feeds)

    # nested IFs, the inner condition computed inside the outer body
    def nested_body():
        def outer():
            y = src * 2.0 + 1.0
            z = y.clone()
            control.cond(p2 & (y.sum() > 0), lambda: torch.sqrt(y.abs()) + y,
                         None, out=z)
            return z - 0.5
        control.cond(p1, outer, None, out=v)

    def nested_eager():
        if bool(p1):
            y = src * 2.0 + 1.0
            z = torch.sqrt(y.abs()) + y if bool(p2 & (y.sum() > 0)) else y
            v.copy_(z - 0.5)
    run_case("nested IF", nested_body, nested_eager, feeds)

    # five bodies deep, as the fused frame's deepest path nests them (the
    # chain's IF under need_kf, the right image's IF, the scale solve's
    # IF/else, the LM's WHILE, its cutoff WHILE): each level's result
    # leaves through a tensor made before its node
    def deep_body():
        def level_if(y):
            z = y.clone()

            def inner():
                w = y * 0.5 + 0.125
                control.cond(p2, lambda: lm(w), lambda: lm(-w), out=w)
                return w
            control.cond(y.sum() > -1e30, inner, None, out=z)
            return z

        def lm(w):
            n = torch.zeros((), dtype=torch.int32, device=dev)
            w = w.clone()

            def trip():
                m = torch.zeros((), dtype=torch.int32, device=dev)

                def go():
                    return (m < 2) & (n < 3)

                def cut():
                    live = go()
                    w.copy_(torch.where(live, w * 0.75 + 0.0625, w))
                    m.add_(live.int())
                control.while_loop(go, cut, 3)
                n.add_((n < 3).int())
            control.while_loop(lambda: n < 3, trip, 4)
            return w
        control.cond(p1, lambda: level_if(src * 2.0 - 1.0), None, out=v)

    def deep_eager():
        if bool(p1):
            w = (src * 2.0 - 1.0) * 0.5 + 0.125
            w = w if bool(p2) else -w
            for _ in range(3):
                for _ in range(2):
                    w = w * 0.75 + 0.0625
            v.copy_(w)
    run_case("5 bodies deep", deep_body, deep_eager, feeds)

    # WHILE: x counts on while it is below the limit x[0] sets (no trip,
    # some trips, the cap)
    lim = torch.zeros((), device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    cap = 7

    def loop_body():
        it.zero_()
        v.copy_(src)

        def go():
            return (it.float() < lim) & (v.sum() < 1e30)

        def body():
            g_ = go()
            v.copy_(torch.where(g_, v * 1.5 + 0.25, v))
            it.copy_(torch.where(g_, it + 1, it))
        control.while_loop(go, body, cap)

    def loop_eager():
        it.zero_()
        v.copy_(src)
        k = 0
        while k < cap and bool((it.float() < lim) & (v.sum() < 1e30)):
            v.copy_(v * 1.5 + 0.25)
            it.copy_(it + 1)
            k += 1

    for name, limit in (("WHILE, no trip", 0.0), ("WHILE, 3 trips", 3.0),
                        ("WHILE, cap reached", 100.0)):
        def feed(limit=limit):
            src.copy_(inputs[0])
            lim.fill_(limit)
        run_case(name, loop_body, loop_eager, [feed])

    # the counters: a K1 launch in a WHILE body of 3 trips and in an IF
    # body, replayed twice, credited from the device's run counts; as the
    # profiler reports them (the WHILE body's once a replay); the setter
    # launches (a replay: the WHILE's 1 + 3, the IF's 1)
    img = torch.rand(64, 64, generator=gen).to(dev)
    n3 = torch.zeros((), dtype=torch.int32, device=dev)
    pyr_sum = torch.zeros((), device=dev)

    def counted():
        n3.zero_()

        def body():
            lv, _ = IMG.pyramid_levels(img, 2)
            pyr_sum.add_(lv[1].sum() * (n3 < 3).float())
            n3.add_((n3 < 3).int())
        control.while_loop(lambda: n3 < 3, body, 10)
        control.cond(p1, lambda: IMG.pyramid_levels(img, 1)[0][0].sum(),
                     None, out=pyr_sum)
    g = _captured(dev, counted)
    control.account(dev)
    k0 = IMG.pyramid_levels.launches
    p0 = control.PROFILED["K1"]
    s0 = control.setter_launches(dev)
    p1.fill_(True)
    g.replay()
    p1.fill_(False)
    g.replay()
    control.account(dev)
    got = IMG.pyramid_levels.launches - k0
    shown = control.PROFILED["K1"] - p0
    setters = control.setter_launches(dev) - s0
    out.append(("launch counters from run counts",
                (got, shown, setters) == (7, 3, 10),
                f"K1 launches credited {got}, expected 3 + 1 + 3; as the "
                f"profiler reports them {shown}, expected 1 + 1 + 1; setter "
                f"launches {setters}, expected 2 * (1 + 3 + 1)"))
    return out


def node_costs(dev, n=500, trips=2000):
    """Device us of a skipped IF node, of a node of one tiny kernel, and
    of one trip of a WHILE node whose body is one tiny kernel, each from
    10 replays of a graph of `n` nodes (`trips` trips) under CUDA
    events."""
    import torch
    from sos_slam_tpu_torch.ops import control
    x = torch.zeros(16, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)

    def skipped():
        for _ in range(n):
            control.cond(off, lambda: x + 1.0, None, out=x)

    def plain():
        for _ in range(n):
            x.add_(1.0)

    def loop():
        control.while_loop(lambda: on, lambda: x.add_(1.0), trips)

    res = {}
    for name, fn, count in (("skipped IF node", skipped, n),
                            ("tiny kernel node", plain, n),
                            ("WHILE trip of one tiny kernel", loop, trips)):
        g = _captured(dev, fn)
        g.replay()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(10):
            g.replay()
        e1.record()
        torch.cuda.synchronize(dev)
        res[name] = 1e3 * e0.elapsed_time(e1) / (10 * count)
    return res


def profiler_view(dev, fill=10):
    """What torch.profiler reports of the kernels inside conditional
    nodes against control.PROFILED's rule (an IF body's kernels at each
    run, a WHILE body's once each time the node is entered): a K1 launch
    in a WHILE body of 5 trips and of no trip, in 5 IF nodes and in 5
    plain kernel nodes, each graph replayed once in a window; then, once
    `fill` graphs of 300 IF nodes each have been made, the IF graph and
    the plain one again, and 5 plain K1 nodes beside 300 IF nodes of
    another kernel. Returns {case: (K1 launches seen, by the rule)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sos_slam_tpu_torch.ops import control
    from sos_slam_tpu_torch.ops import image as IMG
    img = torch.rand(64, 64, device=dev)
    x = torch.zeros(16, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)

    def loop(trips):
        def run():
            k.zero_()

            def body():
                IMG.pyramid_levels(img, 2)
                k.add_((k < trips).int())
            control.while_loop(lambda: k < trips, body, 10)
        return run

    def ifs():
        for _ in range(5):
            control.cond(on, lambda: IMG.pyramid_levels(img, 2)[0][0].sum(),
                         None, out=torch.zeros((), device=dev))

    def plain():
        for _ in range(5):
            IMG.pyramid_levels(img, 2)

    def beside():
        plain()
        for _ in range(300):
            control.cond(on, lambda: x + 1.0, None, out=x)

    def seen(g):
        torch.cuda.synchronize(dev)
        control.account(dev)
        k0 = IMG.pyramid_levels.launches - control.CREDITED["K1"] \
            + control.PROFILED["K1"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            g.replay()
            torch.cuda.synchronize(dev)
        if g in plain_graphs:
            IMG.pyramid_levels.launches += 5    # a replay adds its nodes'
        control.account(dev)
        rule = IMG.pyramid_levels.launches - control.CREDITED["K1"] \
            + control.PROFILED["K1"] - k0
        return (sum(e.count for e in prof.key_averages()
                    if "pyramid_kernel" in e.key), rule)

    graphs = {name: _captured(dev, fn) for name, fn in (
        ("WHILE of 5 trips", loop(5)), ("WHILE of no trip", loop(0)),
        ("5 IF nodes", ifs), ("5 kernel nodes", plain))}
    plain_graphs = [graphs["5 kernel nodes"]]
    out = {name: seen(g) for name, g in graphs.items()}
    made = []
    for _ in range(fill):
        made.append(_captured(dev, lambda: [control.cond(
            on, lambda: x + 1.0, None, out=x) for _ in range(300)]))
    plain_graphs.append(_captured(dev, beside))
    for j in range(3):
        out[f"5 IF nodes after {300 * fill} more IF nodes, window {j + 1}"] \
            = seen(graphs["5 IF nodes"])
    out[f"5 kernel nodes after {300 * fill} more IF nodes"] = \
        seen(graphs["5 kernel nodes"])
    out["5 kernel nodes beside 300 IF nodes of another kernel"] = \
        seen(plain_graphs[1])
    return out


if __name__ == "__main__":
    sys.exit(main())
