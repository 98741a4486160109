"""Device control flow on the fused path's CUDA graphs: the counterparts
of the JAX package's `lax.cond` and `lax.while_loop`.

Inside a capture opened by `capture` on a card, `cond` and `while_loop`
add CUDA conditional nodes to the graph under capture
(csrc/graph_cond.cu): `cond` an IF node with a body for each branch it
is given, `while_loop` a WHILE node whose body is the loop's body
followed by its condition. A replay then runs only the branch taken and
leaves a loop when its condition fails, reading nothing back. A one-thread
kernel before each node sets it from a device bool; a WHILE node's
condition is set before its first trip too, since JAX tests it before the
first trip and the node after each. The same kernels count, on the device,
the branches taken, the trips made and the WHILE nodes entered, in run
slots that each captured graph holds while it lives (a dropped graph's
slots are cleared and reused at the next capture or `account`); `read`
(with a step graph's host read: the live graphs' bodies that launch
counted kernels), `staged` + `credit_staged` (the same counts through a
frame's readback) and `account` (all) bring those counts to the host and
add the kernel launches captured in each body times its runs to the
kernels' launch counters (K1-K5), which a replay can no longer add by
itself. `PROFILED` keeps the same launches as torch.profiler reports
them: an IF body's at each run, a WHILE body's once each time the node is
entered, whatever its trips (scripts/torch_graph_probe.py's profiler
view).

Elsewhere they run their plain twins, which give the same bits. On a
card outside a capture (a capture's warm-up) the twins read nothing on the
host: `cond` runs every branch and selects on the device, `while_loop`
runs its body `cap` times, where the body leaves its state as it is once
the condition fails (the bounded forms' masks). On the CPU, where a read
waits for nothing, they do what the nodes do: `cond` runs the branch
taken, `while_loop` leaves when its condition fails
(tests/test_torch_helpers.py::no_host_reads makes them take the card's
twins, to hold the bodies to a capture's rules). The eager dispatch's
loops (`cuda_graphs=False`) do not come here: they read the host and
leave early (its frame marginalizations do, in the card's twin).

Rules for the bodies, which a capture does not check:
  * what leaves a body is written into tensors allocated before its node
    (`cond`'s `out`, a loop's state): a skipped body writes nothing, and
    its own allocations come from the capture's pool, which a later
    capture may hand on;
  * no host-to-device copy inside a body.
The fused frame's graphs (models/fused_graph.py) read nothing at their
dispatch: `staged` gathers the counts on the device after the replay, and
`credit_staged` credits them from the frame's pinned readback when it
completes. `stamp` writes the device's clock into a slot in stream order
(a kernel node inside a capture, in a body too), and `clock_pair` times
one stamp between two host reads of `time.perf_counter_ns()`: how the
fused frame's device stamps are put on the host's clock
(utils/telemetry.py).
The node types a body may hold are checked at its end (`_check_body`:
a library that allocates stream-ordered memory there raises, naming the
code).
Bodies capture on streams of their own (one a nesting depth), made and
warmed up (cuBLAS and cuSOLVER handles, workspaces) before the first
capture of a device. A failed build, node or launch raises: a card never
falls back to the plain twins inside a capture.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
import time
import weakref

import torch

from sos_slam_tpu_torch.utils import cuda_build

# the C entry points of csrc/graph_cond.cu and their argument types
_V, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = dict(
    gc_handle=[_V, _V],
    gc_set_if=[_V, _V, _I, _V, _V, _V],
    gc_set_while=[_V, _V, _V, _I, _I, _V, _V],
    gc_add_node=[_V, _V, _I, _I, _V],
    gc_begin_body=[_V, _V],
    gc_end_body=[_V],
    gc_stream_create=[_V],
    gc_node_types=[_V, _V],
    gc_launches=[_V],
    gc_driver_version=[_V],
    gc_stamp=[_V, _V],
)
# the node types a conditional node's body may hold (CUgraphNodeType):
# kernel, memcpy, memset, child graph, empty, conditional
BODY_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 4: "graph",
                   5: "empty", 13: "conditional"}
NODE_TYPE_NAMES = {3: "host", 6: "event wait", 7: "event record",
                   8: "semaphore signal", 9: "semaphore wait",
                   10: "memory alloc", 11: "memory free",
                   12: "batch memory op"}
SLOTS = 1 << 16     # the run counters of a device (one per body alive)
MAX_DEPTH = 8       # the deepest nesting of bodies
IF, WHILE = 0, 1    # the kinds of body
# what `credit` has added so far: launches by counter; and "runs", the
# branches taken and trips made
CREDITED = collections.Counter()
# the same launches as torch.profiler reports them (module docstring)
PROFILED = collections.Counter()


def counters():
    """The kernels' launch counters, by name."""
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.ops import tracker as TK
    return (("K1", IMG.pyramid_levels), ("K2", WIN.template_levels),
            ("K3", BP.fused_iteration), ("K4", BP.act_pass),
            ("K5", TK.tracker_trip))


def _call(symbol: str, *args) -> None:
    err = cuda_build.function("graph_cond", symbol, ARGTYPES[symbol])(*args)
    if err != 0:
        raise RuntimeError(f"graph_cond {symbol}: CUDA error {err}")


def driver_version() -> int:
    """The driver's CUDA version (12080 for 12.8)."""
    out = ctypes.c_int()
    _call("gc_driver_version", ctypes.byref(out))
    return out.value


class _Record:
    """The run slots of one captured graph, and its bodies: (slot, kind,
    {counter: launches a run}) each."""

    def __init__(self):
        self.slots = []
        self.bodies = []


class _Device:
    """A card's run counters (`runs`: branches taken and trips made;
    `entries`: a WHILE node's entries; `trips`: its trips in the replay
    under way), the records of the graphs captured on it, and its body
    streams (`streams` of them; none for a test of the bookkeeping)."""

    def __init__(self, dev, streams: int = MAX_DEPTH):
        self.dev = dev
        self.runs = torch.zeros(SLOTS, dtype=torch.int64, device=dev)
        self.entries = torch.zeros(SLOTS, dtype=torch.int64, device=dev)
        self.trips = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
        self.free = list(range(SLOTS - 1, -1, -1))
        # the counts credited so far, by slot, and each slot's generation
        # (raised where `recycle` frees it: a staged count of an earlier
        # generation is not credited)
        self.credited = [0] * SLOTS
        self.entered = [0] * SLOTS
        self.gen = [0] * SLOTS
        self.live = []          # records of the graphs captured
        self.dead = []          # those whose graph is gone
        self.counted = None     # `_counted`'s bodies and their slots
        self.streams = []
        for _ in range(streams):
            out = ctypes.c_void_p()
            _call("gc_stream_create", ctypes.byref(out))
            s = torch.cuda.ExternalStream(out.value, device=dev)
            _warm(s, dev)
            self.streams.append(s)
        if streams:
            torch.cuda.synchronize(dev)

    def take(self, rec: _Record) -> int:
        if not self.free:
            raise RuntimeError(f"more than {SLOTS} conditional bodies in "
                               "the graphs alive")
        slot = self.free.pop()
        rec.slots.append(slot)
        return slot

    def release(self, rec: _Record) -> None:
        """`rec`'s graph is gone (a finalizer, which may run anywhere: it
        only queues the record for `recycle`)."""
        self.dead.append(rec)

    def recycle(self) -> None:
        """Credit the dropped graphs' last runs, clear their slots and make
        them free (outside a capture: it reads the card)."""
        if not self.dead:
            return
        dead = []
        while self.dead:    # a finalizer may append meanwhile
            dead.append(self.dead.pop())
        gone = {id(r) for r in dead}
        self.live = [r for r in self.live if id(r) not in gone]
        _credit_bodies(self, [b for r in dead for b in r.bodies])
        slots = [s for r in dead for s in r.slots]
        if slots:
            idx = torch.tensor(slots, dtype=torch.int64, device=self.dev)
            for t in (self.runs, self.entries, self.trips):
                t.index_fill_(0, idx, 0)
        for s in slots:
            self.credited[s] = self.entered[s] = 0
            self.gen[s] += 1
        self.free.extend(slots)
        self.counted = None
        _counted(self)


def _warm(s, dev) -> None:
    """Make the libraries' handles and workspaces of body stream `s` now:
    made inside a body's capture they would allocate from its pool."""
    with torch.cuda.stream(s):
        for dt in (torch.float32, torch.float64):
            a = torch.eye(8, dtype=dt, device=dev).repeat(2, 1, 1) + 0.5
            b = a[:, :, :1]
            # cuBLAS (the handle's workspace on this stream), cuBLASLt (a
            # product with a bias: its own workspace) and cuSOLVER
            _ = (a @ a, a[0] @ a[0], a[0] @ b[0, :, 0],
                 torch.nn.functional.linear(a[0], a[0], a[0, 0]),
                 torch.einsum("kij,kjl->kil", a, a), torch.bmm(a, a),
                 torch.linalg.solve_ex(a, b), torch.linalg.inv_ex(a),
                 torch.linalg.inv_ex(a[0]), torch.linalg.lu_factor_ex(a[0]),
                 torch.linalg.solve_triangular(a[0], b[0], upper=True))
    s.synchronize()


_DEVICES = {}
_TLS = threading.local()


def _index(dev) -> int:
    idx = torch.device(dev).index
    return torch.cuda.current_device() if idx is None else idx


def _device(dev) -> _Device:
    idx = _index(dev)
    d = _DEVICES.get(idx)
    if d is None:
        d = _DEVICES[idx] = _Device(torch.device("cuda", idx))
    return d


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _at(t, slot: int) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() + slot * t.element_size())


def _sp(s) -> ctypes.c_void_p:
    return ctypes.c_void_p(s.cuda_stream)


class _Capture:
    """A capture under way that `cond` and `while_loop` add nodes to."""

    def __init__(self, d: _Device, pool, rec: _Record):
        self.d = d
        self.pool = pool
        self.rec = rec
        self.depth = 0

    def take(self) -> int:
        return self.d.take(self.rec)

    def stream(self):
        return torch.cuda.current_stream(self.d.dev)

    def handle(self):
        """A new conditional handle in the graph under capture."""
        h = ctypes.c_uint64()
        _call("gc_handle", _sp(self.stream()), ctypes.byref(h))
        return h

    def add(self, h, kind: int, size: int):
        """The node of handle `h` (kind 0: IF with `size` bodies, 1: WHILE)
        after the setter launched last. Returns its body graphs."""
        bodies = (ctypes.c_void_p * 2)()
        _call("gc_add_node", _sp(self.stream()), ctypes.byref(h), kind,
              size, bodies)
        return [bodies[i] for i in range(size)]

    @contextlib.contextmanager
    def body(self, graph, slot: int, kind: int):
        """Capture the block into body graph `graph` on the stream of the
        next nesting depth; its kernels' launches are recorded as a run's
        of `slot` (a body of `kind`) and taken off the counters (a capture
        launches nothing)."""
        if self.depth >= MAX_DEPTH:
            raise RuntimeError(f"conditional bodies nested deeper than "
                               f"{MAX_DEPTH}")
        s = self.d.streams[self.depth]
        before = {n: fn.launches for n, fn in counters()}
        _call("gc_begin_body", _sp(s), ctypes.c_void_p(graph))
        self.depth += 1
        try:
            with torch.cuda.stream(s):
                yield s
        finally:
            self.depth -= 1
            err = cuda_build.function("graph_cond", "gc_end_body",
                                      ARGTYPES["gc_end_body"])(_sp(s))
            per_run = {}
            for n, fn in counters():
                if fn.launches != before[n]:
                    per_run[n] = fn.launches - before[n]
                    fn.launches = before[n]
            self.rec.bodies.append((slot, kind, per_run))
        if err != 0:
            raise RuntimeError(f"graph_cond gc_end_body: CUDA error {err}")
        _check_body(graph)


def _check_body(graph) -> None:
    """Raise, naming the code that captured it, where a body graph holds
    nodes a conditional node does not take (its graph would fail to
    instantiate at the capture's end, with no hint of where)."""
    counts = (ctypes.c_int * 18)()
    _call("gc_node_types", ctypes.c_void_p(graph), counts)
    bad = {NODE_TYPE_NAMES.get(t, str(t)): counts[t] for t in range(16)
           if counts[t] and t not in BODY_NODE_TYPES}
    if counts[16]:
        bad["memcpy to or from host memory or an array"] = counts[16]
    if counts[17]:
        bad["edges of another than the default type"] = counts[17]
    if bad:
        import traceback
        where = "".join(traceback.format_stack(limit=12)[:-3])
        raise RuntimeError(f"a conditional body holds nodes it may not: "
                           f"{bad}; captured at\n{where}")


def _on_host(t) -> bool:
    """Whether a plain twin reads the condition `t` on the host: on the
    CPU (module docstring)."""
    return t.device.type == "cpu"


def _capturing():
    cap = getattr(_TLS, "cap", None)
    if cap is None:
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a capture not opened by control.capture: "
                               "its conditional nodes have no pool")
        return None
    return cap


@contextlib.contextmanager
def capture(graph, pool, stream):
    """`torch.cuda.graph(graph, pool=pool, stream=stream,
    capture_error_mode="thread_local")`, inside which `cond` and
    `while_loop` add conditional nodes. `pool`: a `graph_pool_handle()`.

    The bodies capture on streams of their own, which the allocator's
    filter for the capture (its stream's capture id) does not take: so
    the capture's pool takes every allocation of this thread instead
    (`_cuda_beginAllocateCurrentThreadToPool`, whose entry the capture's
    end removes), which the loop worker's thread does not share."""
    if pool is None:
        raise ValueError("control.capture needs the capture's pool")
    d = _device(stream.device)
    d.recycle()
    idx = d.dev.index
    prev = getattr(_TLS, "cap", None)
    rec = _Record()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            torch._C._cuda_endAllocateToPool(idx, pool)
            torch._C._cuda_beginAllocateCurrentThreadToPool(idx, pool)
            # the capture holds the pool once, as it did before the swap
            torch._C._cuda_releasePool(idx, pool)
            _TLS.cap = _Capture(d, pool, rec)
            try:
                with _refusing_reads():
                    yield
            finally:
                _TLS.cap = prev
    except BaseException:
        d.release(rec)      # its slots never ran
        raise
    d.live.append(rec)
    weakref.finalize(graph, d.release, rec)
    # the frames' reads gather the new bodies' counters too; the index is
    # made now, not at a frame's read
    d.counted = None
    _counted(d)


# what reads a card's tensor on the host through Python (`_refusing_reads`)
_HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "cpu", "numpy")


@contextlib.contextmanager
def _refusing_reads():
    """While this thread captures, refuse its host reads of a card's tensor
    made through Python, before they reach the card: one inside a
    conditional body would cut that body's capture short inside a main
    capture that goes on, whose end then fails or crashes. Refused here,
    the read raises, the bodies and the capture end whole and the error
    reaches the caller. Other threads (the loop worker) read as ever."""
    me = threading.get_ident()
    saved = {n: getattr(torch.Tensor, n) for n in _HOST_READS}

    def guard(name, fn):
        def read(self, *a, **kw):
            if self.is_cuda and threading.get_ident() == me:
                raise RuntimeError(f"a host read ({name}) of a card's tensor "
                                   "inside a CUDA graph capture")
            return fn(self, *a, **kw)
        return read

    for n, fn in saved.items():
        setattr(torch.Tensor, n, guard(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


def clone(x):
    """A copy of a tensor, or of a dict, tuple or NamedTuple of them, for
    a body or a loop to write into (it is allocated before its node)."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone(v) for v in x))
    return tuple(clone(v) for v in x)


def copy_into(dst, src) -> None:
    """Write the tensors of `src` into those of `dst` (the same
    structure's leaves, in order), but where a leaf is the same tensor."""
    for d, s_ in zip(dst, src):
        if s_ is not d:
            d.copy_(s_)


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for k in x for t in _leaves(x[k])]
    return [t for v in x for t in _leaves(v)]


def _like(out, v):
    """The leaves of `v` in the order of `out`'s (dict entries by
    `out`'s keys)."""
    if torch.is_tensor(out):
        return [v]
    if isinstance(out, dict):
        return [t for k in out for t in _like(out[k], v[k])]
    return [t for o, w in zip(out, v) for t in _like(o, w)]


def _bool(pred):
    if not (torch.is_tensor(pred) and pred.dtype == torch.bool
            and pred.numel() == 1):
        raise TypeError("a condition is a one-element bool tensor")
    return pred.reshape(()).contiguous()


def cond(pred, true_fn, false_fn=None, out=None, then=None) -> None:
    """`lax.cond(pred, true_fn, false_fn)` into `out`: a tensor, or a
    tuple, list, NamedTuple or dict of them, allocated before. Each branch
    returns a value of `out`'s structure, written into `out` where the
    device bool `pred` holds (true_fn) or not (false_fn; None: `out`
    keeps its value). `then()`, where given, runs at the end of the true
    branch, after its value is written (a `stamp`: the branch's last
    node); the card's plain twin runs it after the select, whatever
    `pred`."""
    cap = _capturing()
    pred = _bool(pred)
    outs = _leaves(out)
    if cap is None and _on_host(pred):
        fn = true_fn if bool(pred) else false_fn
        if fn is not None:
            copy_into(outs, _like(out, fn()))
        if then is not None and fn is true_fn:
            then()
        return
    if cap is None:
        a = _like(out, true_fn())
        b = outs if false_fn is None else _like(out, false_fn())
        copy_into(outs, [torch.where(pred, x, y) for x, y in zip(a, b)])
        if then is not None:
            then()
        return
    branches = [true_fn] if false_fn is None else [true_fn, false_fn]
    slots = [cap.take() for _ in branches]
    runs = cap.d.runs
    h = cap.handle()
    _call("gc_set_if", ctypes.byref(h), _ptr(pred), 0, _at(runs, slots[0]),
          _at(runs, slots[1]) if false_fn is not None else None,
          _sp(cap.stream()))
    for graph, fn, slot in zip(cap.add(h, 0, len(branches)), branches,
                               slots):
        with cap.body(graph, slot, IF):
            copy_into(outs, _like(out, fn()))
            if then is not None and fn is true_fn:
                then()


def while_loop(go_fn, body_fn, cap: int) -> None:
    """`lax.while_loop` with a trip cap: `body_fn()` while the device bool
    `go_fn()` holds, at most `cap` times. The body updates its state in
    place (tensors allocated before) and leaves it as it is where the
    condition fails (the card's plain twin runs it `cap` times). Inside a
    capture, a WHILE node."""
    c = _capturing()
    if c is None:
        for _ in range(cap):
            go = _bool(go_fn())
            if _on_host(go) and not bool(go):
                return
            body_fn()
        return
    slot = c.take()
    d = c.d
    h = c.handle()
    _call("gc_set_while", ctypes.byref(h), _ptr(_bool(go_fn())),
          _at(d.trips, slot), cap, 0, _at(d.entries, slot), _sp(c.stream()))
    (graph,) = c.add(h, 1, 1)
    with c.body(graph, slot, WHILE) as s:
        body_fn()
        go = _bool(go_fn())
        _call("gc_set_while", ctypes.byref(h), _ptr(go), _at(d.trips, slot),
              cap, 1, _at(d.runs, slot), _sp(s))


def _counted(d):
    """The live graphs' bodies that launch counted kernels, and their run
    slots on the device (remade where a capture or `recycle` changed them:
    a host-to-device copy)."""
    if d.counted is None:
        bodies = [b for r in d.live for b in r.bodies if b[2]]
        d.counted = (bodies, torch.tensor([b[0] for b in bodies],
                                          dtype=torch.int64, device=d.dev))
    return d.counted


def _credit_bodies(d, bodies) -> None:
    """Read the run and entry counters of `bodies` (one host read) and
    credit them."""
    if bodies:
        idx = torch.tensor([b[0] for b in bodies], dtype=torch.int64,
                           device=d.dev)
        vals = torch.cat([d.runs.index_select(0, idx),
                          d.entries.index_select(0, idx)]).tolist()
        credit(d, bodies, vals[:len(bodies)], vals[len(bodies):])


def credit(d, bodies, runs, entries) -> None:
    """Add to the launch counters the launches of the runs made since the
    last credit of each of `bodies` (`_Record.bodies`' entries of card
    `d`): `runs` and `entries`, host ints, are their counters as read.
    Adds the runs to `CREDITED["runs"]` and the launches as the profiler
    reports them to `PROFILED`."""
    fns = dict(counters())
    for (slot, kind, per), r, e in zip(bodies, runs, entries):
        n, m = r - d.credited[slot], e - d.entered[slot]
        if n < 0 or m < 0:
            continue    # a staged count older than one credited since
        d.credited[slot], d.entered[slot] = r, e
        CREDITED["runs"] += n
        shown = n if kind == IF else m
        for name, k in per.items():
            fns[name].launches += n * k
            CREDITED[name] += n * k
            PROFILED[name] += shown * k


def read(dev, *flags):
    """The one-element device tensors `flags` as host ints, read in one
    copy with the run counters of the live graphs' bodies that launch
    counted kernels, which are credited: the frame's one host read."""
    dev = torch.device(dev)
    d = _DEVICES.get(_index(dev)) if dev.type == "cuda" else None
    parts = [torch.stack([f.reshape(()).to(torch.int64) for f in flags])] \
        if flags else []
    bodies, idx = _counted(d) if d is not None else ([], None)
    if not bodies:
        return torch.cat(parts).tolist() if parts else []
    vals = torch.cat(parts + [d.runs.index_select(0, idx),
                              d.entries.index_select(0, idx)]).tolist()
    k, m = len(flags), len(bodies)
    credit(d, bodies, vals[k:k + m], vals[k + m:])
    return vals[:k]


def staged(dev):
    """The frame's counts without a host read: the run and entry counters
    of the live graphs' bodies that launch counted kernels, gathered into
    a device int64 tensor in stream order after the replay, with a token
    of the bodies they are (`credit_staged` credits them from the host
    copy of that tensor, which rides the frame's pinned readback). None
    where no body counts (the CPU, no graph yet)."""
    dev = torch.device(dev)
    d = _DEVICES.get(_index(dev)) if dev.type == "cuda" else None
    if d is None:
        return None
    bodies, idx = _counted(d)
    if not bodies:
        return None
    vals = torch.cat([d.runs.index_select(0, idx),
                      d.entries.index_select(0, idx)])
    return (d, bodies, [d.gen[b[0]] for b in bodies]), vals


def credit_staged(token, vals) -> None:
    """Credit the counts that `staged` gathered (`vals`: their host ints)
    at the frame's completion. The counters are cumulative: frames
    complete in the order they were replayed, so each run is credited
    once at any pipeline depth; a frame never completed (dispatched
    again) leaves its runs to the next one's counts, and a body whose
    graph was dropped since (its final counts credited by `recycle`) is
    passed over."""
    d, bodies, gens = token
    m = len(bodies)
    keep = [i for i, b in enumerate(bodies) if d.gen[b[0]] == gens[i]]
    credit(d, [bodies[i] for i in keep], [int(vals[i]) for i in keep],
           [int(vals[m + i]) for i in keep])


def account(dev=None) -> None:
    """Credit the launch counters with every run made so far, the dropped
    graphs' slots cleared for reuse (`_Device.recycle`): one read of each
    card's counters, which waits for the card."""
    for idx, d in list(_DEVICES.items()):
        if dev is not None and _index(dev) != idx:
            continue
        d.recycle()
        _credit_bodies(d, [b for r in d.live for b in r.bodies])


def stamp(buf, i: int) -> None:
    """Write the device's clock (%globaltimer, ns) into the int64 `buf[i]`
    in stream order: a one-thread kernel (csrc/graph_cond.cu), a kernel
    node inside a capture and its bodies, counted in no launch counter.
    On the CPU, `time.perf_counter_ns()` now."""
    if buf.is_cuda:
        _call("gc_stamp", _at(buf, i), _sp(torch.cuda.current_stream(
            buf.device)))
    else:
        buf[i:i + 1].fill_(time.perf_counter_ns())


def clock_pair(buf, i: int):
    """(host ns before, device ns, host ns after): one `stamp` into
    `buf[i]` between two reads of `time.perf_counter_ns()`, the card idle
    before and waited for after (it synchronizes twice)."""
    cuda = buf.is_cuda
    if cuda:
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter_ns()
    stamp(buf, i)
    if cuda:
        torch.cuda.synchronize(buf.device)
    t1 = time.perf_counter_ns()
    return t0, int(buf[i]), t1


def setter_launches(dev) -> int:
    """The setter kernels (csrc/graph_cond.cu) run so far on card `dev`:
    one before each IF node, one before each WHILE node and one after each
    of its trips. Waits for the card."""
    torch.cuda.synchronize(dev)
    out = ctypes.c_uint64()
    with torch.cuda.device(dev):
        _call("gc_launches", ctypes.byref(out))
    return out.value
