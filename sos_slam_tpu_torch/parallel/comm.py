"""The collectives of the point-sharded GN step (`models/energy.py`).

Every cross-point reduction of a sharded step goes through `psum` or
`pgather` (`pgather_rows` for several tensors at once) with the process
group of the mesh's "dp" axis; with no group they hand their input back
untouched, so the unsharded step runs exactly
the ops it ran before. Only `all_reduce`, `all_gather` and `broadcast`
are used (gloo has no dependable `reduce_scatter`).

`STATS` counts the collectives and, while `STATS["timed"]` is set, adds
up their wall time with the device synchronized before and after each
(the dry run's measure of the stitch's cost).
"""

from __future__ import annotations

import time

import torch

STATS = {"timed": False, "calls": 0, "seconds": 0.0}


def reset_stats(timed: bool = False) -> None:
    STATS.update(timed=timed, calls=0, seconds=0.0)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _collective(fn, t: torch.Tensor) -> None:
    STATS["calls"] += 1
    if not STATS["timed"]:
        fn()
        return
    _sync(t)
    t0 = time.perf_counter()
    fn()
    _sync(t)
    STATS["seconds"] += time.perf_counter() - t0


def psum(ts, group):
    """The elementwise sums over the group's ranks of the tensors `ts`
    (a list), in one all_reduce of their packed float32 values; with no
    group, `ts` itself. Counts come back as float32 sums (exact below
    2^24)."""
    if group is None:
        return ts
    import torch.distributed as dist
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in ts])
    _collective(lambda: dist.all_reduce(flat, group=group), flat)
    out, at = [], 0
    for t in ts:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def pgather(t: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank's `t`, in rank order, along dim 0 (each rank
    holds as many); with no group, `t` itself."""
    if group is None:
        return t
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _collective(lambda: dist.all_gather(parts, t, group=group), t)
    return torch.cat(parts)


def pgather_rows(ts, group):
    """`pgather` of several tensors with the same leading dim in one
    all_gather: each row's bytes packed side by side, gathered, and cut
    back into the tensors. With no group, `ts` itself."""
    if group is None:
        return ts
    m = ts[0].shape[0]
    parts = [t.contiguous().reshape(m, -1).view(torch.uint8) for t in ts]
    every = pgather(torch.cat(parts, 1), group)
    out, at = [], 0
    for t, p in zip(ts, parts):
        b = every[:, at:at + p.shape[1]].contiguous()
        out.append(b.view(t.dtype).reshape((every.shape[0],) + t.shape[1:]))
        at += p.shape[1]
    return out


def assert_replicated(t: torch.Tensor, group, what: str) -> None:
    """Raise on every rank unless `t` holds the same bits on every rank of
    the group (the replicated solve must not drift apart)."""
    if group is None:
        return
    every = pgather(t.reshape(1, -1).to(torch.float32), group)
    bits = every.view(torch.int32)
    if not bool(torch.all(bits == bits[0:1])):
        raise RuntimeError(f"{what} differs between the ranks of the mesh")
