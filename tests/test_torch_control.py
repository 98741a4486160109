"""ops/control.py's `cond` and `while_loop` on the CPU, against
`jax.lax.cond` and `jax.lax.while_loop` on the same seeded numpy inputs.

On a card inside a capture they open conditional graph nodes (the card
tests hold those to the eager forms); here they run their plain twins:
the CPU's, which reads the condition (the branch taken, the loop left when
its condition fails, as the nodes do), and, under the host-read guard
(tests/test_torch_helpers.py::no_host_reads), the one a card runs outside
a capture, which reads nothing (every branch selected on the device,
every trip to the cap with the body's masks). Both must give JAX's
values: exact for the selects and the counts, 1e-6 relative where a
float body runs in both frameworks. Also the launch counters' credit
from the nodes' run counts, the run slots' life with their graph, the
node-free checks (a bool condition, a capture's pool) and the plain
twins' trip counts."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.ops import control
from tests.test_torch_helpers import close, no_host_reads

torch.set_num_threads(2)

FORMS = ["cpu", "card_twin"]


def _run(form, fn):
    if form == "card_twin":
        with no_host_reads():
            return fn()
    return fn()


def _x(seed, n=32):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cond_matches_lax_cond(form, seed):
    """An IF with an else: the predicate from the data."""
    x = _x(seed)
    ref = jax.lax.cond(jnp.sum(x) > 0, lambda v: jnp.sin(v) * 2.0,
                       lambda v: jnp.cos(v) - 3.0, jnp.asarray(x))
    t = torch.from_numpy(x)
    out = torch.zeros(32)

    def body():
        control.cond(t.sum() > 0, lambda: torch.sin(t) * 2.0,
                     lambda: torch.cos(t) - 3.0, out=out)
    _run(form, body)
    close(np.asarray(ref), out, tol=1e-6)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("pred", [False, True])
def test_cond_without_else_keeps_out(form, pred):
    """An IF alone: `out` keeps its value where the predicate fails (JAX's
    identity branch); a tuple of outputs of two dtypes."""
    x = _x(7)
    ref = jax.lax.cond(pred, lambda v: (v + 1.0, jnp.int32(5)),
                       lambda v: (v, jnp.int32(-1)), jnp.asarray(x))
    t = torch.from_numpy(x)
    out = (t.clone(), torch.full((), -1, dtype=torch.int32))
    p = torch.tensor(pred)

    def body():
        control.cond(p, lambda: (t + 1.0, torch.full((), 5,
                                                     dtype=torch.int32)),
                     None, out=out)
    _run(form, body)
    close(np.asarray(ref[0]), out[0], tol=1e-6)
    assert int(out[1]) == int(ref[1])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("p1,p2", [(False, False), (True, False),
                                   (True, True), (False, True)])
def test_nested_cond_matches_lax(form, p1, p2):
    """An IF inside an IF, the inner predicate computed inside the outer
    branch, the branches allocating their own tensors."""
    x = _x(11)

    def j_outer(v):
        y = v * 2.0 + 1.0
        z = jax.lax.cond(p2 & (jnp.sum(y) > 0), lambda u: jnp.sqrt(
            jnp.abs(u)) + u, lambda u: u, y)
        return z - 0.5
    ref = jax.lax.cond(p1, j_outer, lambda v: v, jnp.asarray(x))
    t = torch.from_numpy(x)
    out = t.clone()
    q1, q2 = torch.tensor(p1), torch.tensor(p2)

    def outer():
        y = t * 2.0 + 1.0
        z = y.clone()
        control.cond(q2 & (y.sum() > 0), lambda: torch.sqrt(y.abs()) + y,
                     None, out=z)
        return z - 0.5

    def body():
        control.cond(q1, outer, None, out=out)
    _run(form, body)
    close(np.asarray(ref), out, tol=1e-6)


def _lax_loop(x, limit, cap):
    """x <- 1.5 x + 0.25 while the trip count is below `limit`, at most
    `cap` times."""
    def c(s):
        return (s[0] < limit) & (s[0] < cap)

    def b(s):
        return s[0] + 1, s[1] * 1.5 + 0.25
    return jax.lax.while_loop(c, b, (jnp.int32(0), jnp.asarray(x)))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("limit", [0, 3, 100], ids=["no_trip", "three",
                                                    "cap_reached"])
def test_while_matches_lax_while(form, limit):
    """A WHILE of no trip, of three, and one that reaches its cap (7); the
    body masked by its condition, as the bounded forms are."""
    cap = 7
    x = _x(5)
    n_ref, x_ref = _lax_loop(x, limit, cap)
    it = torch.zeros((), dtype=torch.int32)
    v = torch.from_numpy(x).clone()
    lim = torch.tensor(float(limit))

    def go():
        return it.float() < lim

    def step():
        g = go()
        v.copy_(torch.where(g, v * 1.5 + 0.25, v))
        it.copy_(torch.where(g, it + 1, it))

    _run(form, lambda: control.while_loop(go, step, cap))
    assert int(it) == int(n_ref) == min(limit, cap)
    close(np.asarray(x_ref), v, tol=1e-6)


@pytest.mark.parametrize("form", FORMS)
def test_lanes_leave_alone_like_lax(form):
    """Lanes with their own trip counts in one loop (the tracker's K
    hypotheses, the scale solve's seven guesses): the loop runs while any
    lane is active, each lane frozen once done (the vmapped
    lax.while_loop's semantics)."""
    x = _x(9, 8)
    limits = np.array([0, 1, 4, 2, 9, 3, 0, 5], np.int32)
    cap = 6

    def lane(v, lim):
        return jax.lax.while_loop(
            lambda s: (s[0] < lim) & (s[0] < cap),
            lambda s: (s[0] + 1, s[1] * 0.5 - 1.0), (jnp.int32(0), v))
    n_ref, x_ref = jax.vmap(lane)(jnp.asarray(x), jnp.asarray(limits))
    it = torch.zeros(8, dtype=torch.int32)
    v = torch.from_numpy(x).clone()
    lim = torch.from_numpy(limits)

    def active():
        return (it < lim) & (it < cap)

    def step():
        a = active()
        v.copy_(torch.where(a, v * 0.5 - 1.0, v))
        it.copy_(it + a.to(torch.int32))

    _run(form, lambda: control.while_loop(lambda: active().any(), step, cap))
    np.testing.assert_array_equal(np.asarray(n_ref), it.numpy())
    close(np.asarray(x_ref), v, tol=1e-6)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("pred", [False, True])
def test_while_inside_cond(form, pred):
    """A WHILE inside an IF (the tracker's level repeat around its LM
    loop): the loop's state allocated inside the branch, its result
    written into the branch's output."""
    x = _x(13)
    ref = jax.lax.cond(pred, lambda v: _lax_loop(v, 4, 10)[1],
                       lambda v: v, jnp.asarray(x))
    t = torch.from_numpy(x)
    out = t.clone()
    p = torch.tensor(pred)

    def branch():
        it = torch.zeros((), dtype=torch.int32)
        v = t.clone()

        def go():
            return it < 4

        def step():
            g = go()
            v.copy_(torch.where(g, v * 1.5 + 0.25, v))
            it.copy_(torch.where(g, it + 1, it))
        control.while_loop(go, step, 10)
        return v

    _run(form, lambda: control.cond(p, branch, None, out=out))
    close(np.asarray(ref), out, tol=1e-6)


@pytest.mark.parametrize("guarded,trips", [(False, 2), (True, 5)])
def test_plain_twins_trip_counts(guarded, trips):
    """The CPU's twin leaves the loop when its condition fails (2 trips);
    the card's runs every trip to the cap (5) and reads no condition."""
    calls = []
    n = torch.zeros((), dtype=torch.int32)

    def step():
        calls.append(1)
        n.copy_(torch.where(n < 2, n + 1, n))

    def run():
        control.while_loop(lambda: n < 2, step, 5)
    if guarded:
        with no_host_reads():
            run()
    else:
        run()
    assert len(calls) == trips and int(n) == 2


def test_cond_wants_a_bool_condition():
    out = torch.zeros(3)
    with pytest.raises(TypeError):
        control.cond(torch.ones(()), lambda: out + 1, None, out=out)
    with pytest.raises(TypeError):
        control.cond(torch.ones(2, dtype=torch.bool), lambda: out + 1, None,
                     out=out)


def test_capture_needs_its_pool():
    with pytest.raises(ValueError):
        with control.capture(None, None, None):
            pass


def _card(monkeypatch):
    """A card's run-counter bookkeeping with its counters on the CPU (no
    body streams), as device 5, the K1 and K3 counters and the credit
    tallies from 0. Returns (the device record, K1, K3)."""
    d = control._Device(torch.device("cpu"), streams=0)
    monkeypatch.setattr(control, "_DEVICES", {5: d})
    monkeypatch.setattr(control, "CREDITED", collections.Counter())
    monkeypatch.setattr(control, "PROFILED", collections.Counter())
    k1, k3 = control.counters()[0][1], control.counters()[2][1]
    monkeypatch.setattr(k1, "launches", 0)
    monkeypatch.setattr(k3, "launches", 0)
    return d, k1, k3


def _graph(d, kinds, launches):
    """A captured graph's record on `d`: a body of each kind, launching
    `launches` (a dict each) a run."""
    rec = control._Record()
    for kind, per in zip(kinds, launches):
        rec.bodies.append((d.take(rec), kind, per))
    d.live.append(rec)
    d.counted = None
    return rec


def test_credit_adds_launches_times_runs(monkeypatch):
    """The launch counters take each body's launches times the runs made
    since the last credit; `PROFILED` the same launches as the profiler
    reports them (an IF body's each run, a WHILE body's each entry);
    `account` reads every body's counters and counts the runs of all (a
    body that launched no kernel takes no launch)."""
    d, k1, k3 = _card(monkeypatch)
    rec = _graph(d, [control.IF, control.WHILE, control.IF],
                 [{"K1": 2}, {"K3": 1, "K1": 1}, {}])
    (s0, _, _), (s1, _, _), (s2, _, _) = rec.bodies
    control.credit(d, rec.bodies[:2], [4, 3], [0, 1])
    assert (k1.launches, k3.launches) == (4 * 2 + 3, 3)
    control.credit(d, rec.bodies[:2], [5, 3], [0, 1])
    assert (k1.launches, k3.launches) == (4 * 2 + 3 + 2, 3)
    assert (d.credited[s0], d.credited[s1]) == (5, 3)
    assert control.PROFILED == dict(K1=5 * 2 + 1, K3=1)
    d.runs[[s0, s1, s2]] = torch.tensor([6, 4, 9])
    d.entries[s1] = 2
    control.account()
    assert (k1.launches, k3.launches) == (6 * 2 + 4, 4)
    assert control.CREDITED == dict(K1=16, K3=4, runs=19)
    assert control.PROFILED == dict(K1=6 * 2 + 2, K3=2)


def test_dropped_graph_slots_are_credited_cleared_and_reused(monkeypatch):
    """A graph's slots live as long as the graph: once dropped (`release`,
    its finalizer), the next `account` credits its last runs, clears its
    counters and frees its slots for the next capture; the frames' reads
    then gather the live graphs' bodies alone."""
    d, k1, _ = _card(monkeypatch)
    keep = _graph(d, [control.IF], [{"K1": 1}])
    drop = _graph(d, [control.WHILE, control.IF], [{"K1": 3}, {}])
    slots = list(drop.slots)
    d.runs[slots] = torch.tensor([2, 5])
    d.entries[slots[0]] = 1
    d.trips[slots[0]] = 2
    d.release(drop)
    assert len(control._counted(d)[0]) == 2     # gathered until recycled
    control.account()
    assert k1.launches == 6 and control.CREDITED["runs"] == 7
    assert d.live == [keep] and len(control._counted(d)[0]) == 1
    for t in (d.runs, d.entries, d.trips):
        assert int(t[slots].abs().sum()) == 0
    assert all(d.credited[s] == d.entered[s] == 0 for s in slots)
    again = _graph(d, [control.IF, control.IF], [{}, {}])
    assert sorted(again.slots) == sorted(slots)


def test_slots_run_out_with_too_many_bodies_alive(monkeypatch):
    d, _, _ = _card(monkeypatch)
    d.free = d.free[-3:]
    _graph(d, [control.IF] * 3, [{}] * 3)
    with pytest.raises(RuntimeError, match="conditional bodies"):
        _graph(d, [control.IF], [{}])


def test_read_credits_the_counted_bodies(monkeypatch):
    """A frame's read: the flags and the counted bodies' run counters in
    one copy; the flags come back, the runs are credited."""
    d, k1, k3 = _card(monkeypatch)
    rec = _graph(d, [control.IF, control.WHILE, control.IF],
                 [{"K1": 1}, {"K3": 2}, {}])
    d.runs[rec.slots] = torch.tensor([3, 4, 7])
    d.entries[rec.slots[1]] = 1
    flags = (torch.tensor(True), torch.tensor(5))
    assert control.read(torch.device("cuda", 5), *flags) == [1, 5]
    assert (k1.launches, k3.launches) == (3, 8)
    assert control.CREDITED == dict(K1=3, K3=8, runs=7)
    assert control.PROFILED == dict(K1=3, K3=2)


def test_read_without_nodes_is_a_plain_read():
    """On the CPU (no conditional nodes) `read` is the flags' host read."""
    flags = (torch.tensor(True), torch.tensor(False), torch.tensor(3))
    assert control.read(torch.device("cpu"), *flags) == [1, 0, 3]
    assert control.read(torch.device("cpu")) == []
