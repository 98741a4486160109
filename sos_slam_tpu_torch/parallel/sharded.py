"""Data parallelism over the point axis (port of
sos_slam_tpu/parallel/sharded.py).

The reference's only parallelism is a map-reduce over point index ranges
(util/IndexThreadReduce.h). As in the JAX package, the point fields of
the BA window are split over the ranks of a "dp" mesh axis and every
frame field is replicated: linearization, Hessian/Schur accumulation and
the idepth resubstitution run on each rank's rows, and the (D,D) system
is stitched over the ranks. The JAX package gets the stitch from XLA's
SPMD partitioner; here every collective is written out in the GN step
(`models/energy.py` with a process group: `_stitch`, the energy
threshold's gather, the check that the replicated solve agrees).

Ranks are torch.distributed processes (`dryrun.spawn_ranks` starts them):
NCCL with one card a rank, or gloo over CPU tensors, or gloo with every
rank on one card. Every entry point is SPMD: each rank of the mesh calls
it with the same global inputs on its device, and each gets the global
result back, as the JAX functions return global arrays. Rank r holds rows
[r P/n, (r+1) P/n) of the point axis; P must divide by n.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import NamedTuple

import torch

from sos_slam_tpu_torch import resolve_device
from sos_slam_tpu_torch.models import energy as E
from sos_slam_tpu_torch.models import full_system as FSM
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import trace as TR
from sos_slam_tpu_torch.ops import tracker as TK
from sos_slam_tpu_torch.parallel import comm

# a collective that waits longer than this fails the rank (a hung rank
# must end the run, not stall it)
TIMEOUT_S = 60

# BAState fields with a leading point axis (split on "dp"), in the one
# order every rank gathers them (a set's order differs between processes)
_POINT_FIELDS = ("pt_valid", "host", "u", "v", "color", "weight", "idepth",
                 "idepth_zero", "pt_prior", "res_exist", "res_state")


class Mesh(NamedTuple):
    """A 1-D "dp" mesh: this process's place in it and its process group.
    `rank` is -1 on a process outside the mesh."""

    device_mesh: object     # torch.distributed DeviceMesh ("dp",)
    group: object           # its ProcessGroup
    rank: int
    size: int
    device: torch.device


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of `rank`: card `rank` under NCCL (one rank a card),
    else `device` itself (gloo ranks share it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", 0 if device.index is None else device.index)


def default_backend(n_devices: int, device) -> str:
    """NCCL when every rank gets a card of its own, else gloo (CPU
    tensors, or every rank on one card)."""
    device = torch.device(device)
    if device.type == "cuda" and n_devices <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_ranks(rank: int, world: int, backend: str, store_path: str) -> None:
    """Join the default process group through a FileStore at
    `store_path`, with TIMEOUT_S on every collective."""
    import torch.distributed as dist
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def make_mesh(n_devices: int, device=None) -> Mesh:
    """The "dp" mesh over the first `n_devices` ranks of the default
    process group, on `device` (CUDA unless named; a rank's card under
    NCCL). With no process group and n_devices = 1, this process becomes
    a world of one (NCCL on a card, gloo on the CPU; `close_mesh` ends
    it). Every rank of the default group must call it. Raises for more
    ranks than the group has or NCCL can place; never moves to the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available")
    if not dist.is_initialized():
        if n_devices != 1:
            raise RuntimeError(
                f"make_mesh({n_devices}): no process group; start the ranks "
                "with sos_slam_tpu_torch.parallel.dryrun.spawn_ranks")
        fd, store = tempfile.mkstemp(prefix="sos_slam_mesh_")
        os.close(fd)
        os.unlink(store)
        init_ranks(0, 1, default_backend(1, dev), store)
    world = dist.get_world_size()
    backend = dist.get_backend()
    if n_devices < 1 or n_devices > world:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{world} ranks")
    if dev.type == "cuda" and backend == "nccl" \
            and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"make_mesh({n_devices}): NCCL places one rank on each card and "
            f"there are {torch.cuda.device_count()}")
    rank = dist.get_rank()
    dev = rank_device(dev, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if n_devices == world:
        dm = init_device_mesh(dev.type, (n_devices,), mesh_dim_names=("dp",))
        return Mesh(dm, dm.get_group("dp"), rank, n_devices, dev)
    group = dist.new_group(list(range(n_devices)))
    if rank >= n_devices:
        return Mesh(None, None, -1, n_devices, dev)
    dm = DeviceMesh.from_group(group, dev.type, mesh_dim_names=("dp",))
    return Mesh(dm, group, rank, n_devices, dev)


def close_mesh() -> None:
    """End this process's process group (after make_mesh's world of one,
    or at the end of a rank)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _member(mesh: Mesh) -> None:
    if mesh.rank < 0:
        raise RuntimeError("this process is not a rank of the mesh")


def shard_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of `t`'s leading axis (a view)."""
    _member(mesh)
    P = t.shape[0]
    if P % mesh.size:
        raise ValueError(f"the point axis ({P}) does not divide over "
                         f"{mesh.size} ranks")
    m = P // mesh.size
    return t[mesh.rank * m:(mesh.rank + 1) * m]


def shard_ba(ba: B.BAState, mesh: Mesh) -> B.BAState:
    """This rank's BAState: its rows of the point fields, every frame
    field whole."""
    return ba._replace(**{f: shard_rows(getattr(ba, f), mesh)
                          for f in _POINT_FIELDS})


def gather_ba(ba: B.BAState, mesh: Mesh) -> B.BAState:
    """The global BAState from every rank's point rows (`shard_ba`'s
    inverse); the frame fields are this rank's, which are replicated."""
    _member(mesh)
    rows = comm.pgather_rows([getattr(ba, f) for f in _POINT_FIELDS],
                             mesh.group)
    return ba._replace(**dict(zip(_POINT_FIELDS, rows)))


def sharded_gn_step(mesh: Mesh, ba: B.BAState, dI, settings, w: int, h: int):
    """One BA GN step with the point pool split over the mesh. Returns
    (global ba, energy)."""
    ba2, _, energy = E.gn_step(shard_ba(ba, mesh), dI, settings, w, h,
                               group=mesh.group)
    return gather_ba(ba2, mesh), energy


def sharded_vio_gn_step(mesh: Mesh, ba: B.BAState, imu, dI, settings,
                        w: int, h: int):
    """One visual-inertial GN step (vision linearization, IMU Hessian and
    KKT solve) with the point pool split over the mesh and the IMU and
    frame state replicated: the (D,D) vision blocks are stitched over the
    ranks and the (5+29F+C) KKT solve runs on every rank. Returns
    (global ba, imu, energy)."""
    ba2, imu2, _, energy = E.gn_step_vio(shard_ba(ba, mesh), imu, dI,
                                         settings, w, h, group=mesh.group)
    return gather_ba(ba2, mesh), imu2, energy


def sharded_track(mesh: Mesh, pyramid_new, templates, T_inits, aff0, ref_aff,
                  exposures, intrinsics, n_levels: int, **kw):
    """The batched hypothesis track with the hypotheses split over the
    mesh: each rank tracks its hypotheses alone, then the results are
    gathered (the only communication). Returns track_hypotheses' dict."""
    out = TK.track_hypotheses(pyramid_new, templates,
                              shard_rows(T_inits, mesh), aff0, ref_aff,
                              exposures, intrinsics, n_levels, **kw)
    return dict(zip(out, comm.pgather_rows(list(out.values()), mesh.group)))


def shard_imm(imm: TR.ImmatureState, mesh: Mesh) -> TR.ImmatureState:
    """This rank's rows of the immature pool (every field is per point)."""
    return TR.ImmatureState(*(shard_rows(t, mesh) for t in imm))


def sharded_trace(mesh: Mesh, ba: B.BAState, imm, dI0_new, T_cw_new,
                  aff_new, exposure_new, w: int, h: int, settings):
    """The epipolar trace of the immature pool split over the mesh: each
    rank traces its points against the replicated window and new frame,
    with no communication until the pool is gathered back."""
    out = FSM.trace_new(ba, shard_imm(imm, mesh), dI0_new, T_cw_new,
                        aff_new, exposure_new, w, h, settings)
    return TR.ImmatureState(*comm.pgather_rows(list(out), mesh.group))
