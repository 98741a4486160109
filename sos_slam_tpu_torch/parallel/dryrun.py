"""The multi-device dry run (port of __graft_entry__.py).

    python -m sos_slam_tpu_torch.parallel.dryrun N [--device cpu]

`entry()` gives one multi-level coarse track of a frame (the per-frame
hot path) with its example inputs. `dryrun_multichip(n)` spawns n ranks
and runs one sharded step of each core program on tiny shapes: the
windowed-BA GN step (points on "dp"), the visual-inertial KKT step
(points on "dp", IMU replicated), the immature-point trace (points on
"dp") and the multi-hypothesis track (hypotheses on "dp"); then the
scaling line, the BA step at P = 16384 on 1 rank against n ranks.
`tiny_scene` and `tiny_window` build the JAX package's dry-run inputs
(its threefry draws through utils/rng.py).

Ranks are processes started with the spawn method (`spawn_ranks`): they
meet through a FileStore in a temporary directory, take their inputs from
and write their outputs to .npz files there, run one thread each, and
every collective and every join has a time limit, so a rank that hangs
fails the run. On CPU tensors the ranks use gloo and the kernels' plain
twins; on a card NCCL when every rank has a card of its own, else gloo
with every rank on the one card (gloo stages CUDA tensors through host
memory itself). The kernels are built in the parent before the ranks
start.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from sos_slam_tpu_torch import resolve_device
from sos_slam_tpu_torch.utils import rng

W, H = 192, 128
F_SLOTS = 8      # window slots (enough for the 5-KF IMU init)
P_SLOTS = 128    # point slots
P_BIG = 16384    # the scaling line's point pool
JOIN_S = 600     # the longest a dry run's ranks may take


# ---------------------------------------------------------------------------
# the JAX package's dry-run inputs
# ---------------------------------------------------------------------------

def tiny_scene(w=128, h=96, n_track=512, device=None):
    """A textured plane seen from the identity and from a small motion:
    (calib, pyramid of the new frame, one random template per level,
    intrinsics per level, n_levels)."""
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.ops import tracker as TK
    from sos_slam_tpu_torch.utils import lie, synthetic
    dev = resolve_device(device)
    calib = synthetic.default_calib(w, h)
    n_levels = calib.levels
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    img_ref, idepth_ref = synthetic.render_plane(calib, eye)
    T_new = lie.se3_exp(torch.tensor(
        [0.02, 0.01, 0.02, 0.002, 0.004, 0.001], device=dev))
    img_new, _ = synthetic.render_plane(calib, T_new)
    pyr_new, _ = IMG.build_pyramid(img_new, n_levels)
    pyr_ref, _ = IMG.build_pyramid(img_ref, n_levels)
    tmpls = []
    idp = idepth_ref
    for lvl in range(n_levels):
        hl, wl = pyr_ref[lvl].shape[:2]
        n_l = max(n_track >> (2 * lvl), 64)
        key = rng.PRNGKey(lvl)
        u = torch.as_tensor(rng.uniform(key, n_l), device=dev) * (wl - 8) + 4
        v = torch.as_tensor(rng.uniform(rng.fold_in(key, 1), n_l),
                            device=dev) * (hl - 8) + 4
        tmpls.append(TK.LevelTemplate(
            u=u, v=v, idepth=IMG.interp_bilinear(idp, u, v),
            color=IMG.interp_bilinear(pyr_ref[lvl][..., 0], u, v),
            valid=torch.ones_like(u, dtype=torch.bool)))
        if lvl + 1 < n_levels:
            idp = IMG.downsample2x(idp)
    intr = tuple(calib.intrinsics(lv) for lv in range(n_levels))
    return calib, tuple(pyr_new), tuple(tmpls), intr, n_levels


def tiny_window(n_frames=3, n_points=96, pose_noise=0.005, kf_dt=0.25,
                with_imu=False, n_slots=None, device=None):
    """A small BA window on the synthetic textured plane (F_SLOTS frame
    slots, n_slots or P_SLOTS point slots), optionally with a consistent
    synthetic IMU state (spline initialized at 5 keyframes). Returns (ba,
    dI, settings, imu or None)."""
    from sos_slam_tpu_torch.models import imu as IM
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils import lie, synthetic
    from sos_slam_tpu_torch.utils.config import (PATTERN_OFFSETS,
                                                 default_settings)
    dev = resolve_device(device)
    P, F = n_slots or P_SLOTS, F_SLOTS
    f32 = torch.float32
    settings = default_settings(weight_imu_dso=6.0 if with_imu else 0.0)
    calib = synthetic.default_calib(W, H)
    fx, fy, cx, cy = calib.intrinsics(0)
    twist = (0.04, 0.02, 0.03, 0.004, 0.008, 0.004)
    imgs, idepths, poses = synthetic.make_sequence(
        calib, n_frames, twist_per_frame=twist, device=dev)

    dI = torch.zeros((F, H, W, 3), dtype=f32, device=dev)
    for i in range(n_frames):
        dI[i] = IMG.build_pyramid(imgs[i], 1)[0][0]

    gw = int(math.ceil(math.sqrt(n_points)))
    us = torch.linspace(8, W - 9, gw, device=dev)
    vs = torch.linspace(8, H - 9, gw, device=dev)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    pad = P - n_points
    u = torch.nn.functional.pad(uu.reshape(-1)[:n_points], (0, pad))
    v = torch.nn.functional.pad(vv.reshape(-1)[:n_points], (0, pad))
    pt_valid = torch.arange(P, device=dev) < n_points
    idp = IMG.interp_bilinear(idepths[0], u, v)
    pat = torch.as_tensor(PATTERN_OFFSETS, device=dev)
    color = IMG.interp_bilinear(dI[0][..., 0], u[:, None] + pat[None, :, 0],
                                v[:, None] + pat[None, :, 1])

    k1 = rng.PRNGKey(0)
    T_eval = torch.eye(4, dtype=f32, device=dev).repeat(F, 1, 1)
    for i in range(n_frames):
        noise = torch.as_tensor(
            np.float32(pose_noise) * rng.normal(rng.fold_in(k1, i), 6),
            device=dev)
        if i == 0:
            noise = torch.zeros(6, dtype=f32, device=dev)
        T_eval[i] = lie.se3_exp(noise) @ poses[i]

    frame_valid = torch.arange(F, device=dev) < n_frames
    prior = torch.zeros((F, 8), dtype=f32, device=dev)
    prior[0, 0:3] = settings.initial_trans_prior
    prior[0, 3:6] = settings.initial_rot_prior
    prior[0, 6] = settings.initial_aff_a_prior
    prior[0, 7] = settings.initial_aff_b_prior
    prior[1:, 6] = settings.affine_opt_mode_a
    prior[1:, 7] = settings.affine_opt_mode_b
    prior = prior * frame_valid[:, None]
    res_exist = (pt_valid[:, None] & frame_valid[None, :]
                 & (torch.arange(F, device=dev)[None, :] != 0))
    c = torch.tensor([fx, fy, cx, cy], dtype=f32, device=dev) \
        / torch.tensor(B._CALIB_SCALE, dtype=f32, device=dev)
    D = 4 + 8 * F
    ba = B.BAState(
        frame_valid=frame_valid, T_cw_eval=T_eval,
        state=torch.zeros((F, 8), dtype=f32, device=dev),
        state_zero=torch.zeros((F, 8), dtype=f32, device=dev),
        exposure=torch.ones(F, dtype=f32, device=dev),
        energy_th=torch.full((F,), 12.0 * 12.0 * 8.0, dtype=f32, device=dev),
        prior=prior, c=c, c_zero=c.clone(),
        pt_valid=pt_valid, host=torch.zeros(P, dtype=torch.int32, device=dev),
        u=u, v=v, color=color,
        weight=torch.ones((P, 8), dtype=f32, device=dev),
        idepth=idp * pt_valid, idepth_zero=idp * pt_valid,
        pt_prior=settings.idepth_fix_prior
        * torch.ones(P, dtype=f32, device=dev) * pt_valid,
        res_exist=res_exist,
        res_state=torch.zeros((P, F), dtype=torch.int8, device=dev),
        HM=torch.zeros((D, D), dtype=f32, device=dev),
        bM=torch.zeros(D, dtype=f32, device=dev))
    if not with_imu:
        return ba, dI, settings, None

    # synthetic IMU consistent with the constant-twist motion: constant
    # body rates and a gravity-only accelerometer, spline-initialized as
    # the pipeline does at the 5th keyframe
    if n_frames < 5:
        raise ValueError("the IMU initialization needs 5 keyframes")
    gravity = torch.tensor(settings.gravity, dtype=f32, device=dev)
    omega = torch.tensor(twist[3:], dtype=f32, device=dev) / kf_dt
    n_per = 32
    acc = torch.zeros((F, IM.N_IMU, 3), dtype=f32, device=dev)
    gyro = torch.zeros((F, IM.N_IMU, 3), dtype=f32, device=dev)
    ts_rel = torch.zeros((F, IM.N_IMU), dtype=f32, device=dev)
    valid = torch.zeros((F, IM.N_IMU), dtype=torch.bool, device=dev)
    back = torch.arange(n_per, device=dev).flip(0) + 1
    for i in range(1, n_frames):
        t_samples = i * kf_dt - back * (kf_dt / n_per)
        R_w = lie.so3_exp(omega[None, :] * t_samples[:, None])
        acc[i, :n_per] = torch.einsum("nji,j->ni", R_w, gravity)
        gyro[i, :n_per] = omega
        ts_rel[i, :n_per] = t_samples - i * kf_dt
        valid[i, :n_per] = True
    ts = torch.arange(F, device=dev) * kf_dt
    imu = IM.empty_imu(F, dev)._replace(
        timestamps=ts.to(f32), acc=acc, gyro=gyro, ts=ts_rel, imu_valid=valid)
    imu, _ = IM.initialize_imu(ba, imu, settings)
    return ba, dI, settings, imu


def tiny_pool(n_imm: int, device=None):
    """The dry run's immature pool: n_imm points at seeded positions, all
    uninitialized."""
    from sos_slam_tpu_torch.ops import trace as TR
    dev = resolve_device(device)
    key = rng.PRNGKey(7)
    f32 = torch.float32

    def full(shape, val, dtype=f32):
        return torch.full(shape, val, dtype=dtype, device=dev)

    return TR.ImmatureState(
        valid=full((n_imm,), True, torch.bool),
        host=full((n_imm,), 0, torch.int32),
        u=torch.as_tensor(rng.uniform(key, n_imm), device=dev) * (W - 20) + 10,
        v=torch.as_tensor(rng.uniform(rng.fold_in(key, 1), n_imm),
                          device=dev) * (H - 20) + 10,
        color=full((n_imm, 8), 0.5), weights=full((n_imm, 8), 1.0),
        gradH=torch.eye(2, device=dev).repeat(n_imm, 1, 1),
        energy_th=full((n_imm,), 1e4), idepth_min=full((n_imm,), 0.0),
        idepth_max=full((n_imm,), float("inf")),
        status=full((n_imm,), 0, torch.int8),
        quality=full((n_imm,), 10000.0),
        my_type=full((n_imm,), 1, torch.int32))


def hypotheses(n: int, device=None) -> torch.Tensor:
    """The dry run's n motion hypotheses (4,4), one a rank."""
    from sos_slam_tpu_torch.utils import lie
    dev = resolve_device(device)
    xi = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    xi[:, 0] = 0.01 * torch.arange(n, device=dev)
    xi[:, 2] = 0.005 * torch.arange(n, device=dev)
    return lie.se3_exp(xi)


def entry(device=None):
    """(fn, example_args): one full coarse-to-fine track of a frame."""
    from sos_slam_tpu_torch.ops import tracker as TK
    calib, pyr_new, tmpls, intr, n_levels = tiny_scene(device=device)
    dev = pyr_new[0].device

    def fn(pyramid_new, templates, T_init, aff_init):
        return TK.track_newest_coarse(
            pyramid_new, templates, T_init[None], aff_init,
            torch.zeros(2, device=dev), torch.ones(2, device=dev),
            torch.full((6,), float("nan"), device=dev), intr,
            n_levels)["T"][0]

    example_args = (pyr_new, tmpls, torch.eye(4, device=dev),
                    torch.zeros(2, device=dev))
    return fn, example_args


# ---------------------------------------------------------------------------
# jobs: what a rank runs, with its inputs and outputs as flat numpy dicts
# ---------------------------------------------------------------------------

def pack(prefix: str, state) -> dict:
    """A NamedTuple state (or a sequence of them) as {prefix.field: array}."""
    from sos_slam_tpu_torch.utils import convert
    if isinstance(state, (list, tuple)) and not hasattr(state, "_fields"):
        out = {}
        for i, s in enumerate(state):
            out.update(pack(f"{prefix}.{i}", s))
        return out
    if torch.is_tensor(state):
        return {prefix: state.detach().cpu().numpy()}
    return {f"{prefix}.{k}": v for k, v in convert.to_numpy(state).items()}


def unpack(cls, prefix: str, arrays: dict, device):
    from sos_slam_tpu_torch.utils import convert
    return convert.from_numpy(
        cls, {f: arrays[f"{prefix}.{f}"] for f in cls._fields}, device)


def _count(arrays: dict, prefix: str) -> int:
    return len({k[len(prefix) + 1:].split(".")[0] for k in arrays
                if k.startswith(prefix + ".")})


def _run_job(kind: str, a: dict, settings, mesh, meshes) -> dict:
    """Run one job on this rank. `a` holds the job's inputs."""
    from sos_slam_tpu_torch.models import imu as IM
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.ops import trace as TR
    from sos_slam_tpu_torch.ops import tracker as TK
    from sos_slam_tpu_torch.parallel import comm
    from sos_slam_tpu_torch.parallel import sharded as S
    dev = mesh.device
    ts = (lambda k: torch.as_tensor(a[k], device=dev))
    w, h = int(a.get("w", 0)), int(a.get("h", 0))
    out = {}
    if kind in ("gn", "vio"):
        ba = unpack(B.BAState, "ba", a, dev)
        comm.reset_stats(timed=True)
        if kind == "gn":
            ba2, e = S.sharded_gn_step(mesh, ba, ts("dI"), settings, w, h)
        else:
            imu = unpack(IM.ImuState, "imu", a, dev)
            ba2, imu2, e = S.sharded_vio_gn_step(mesh, ba, imu, ts("dI"),
                                                 settings, w, h)
            out.update(pack("imu", imu2))
        out.update(pack("ba", ba2))
        out["energy"] = e.cpu().numpy()
        out["comm_calls"] = np.int64(comm.STATS["calls"])
        out["comm_ms"] = np.float64(comm.STATS["seconds"] * 1e3)
        comm.reset_stats()
    elif kind == "trace":
        ba = unpack(B.BAState, "ba", a, dev)
        imm = unpack(TR.ImmatureState, "imm", a, dev)
        out.update(pack("imm", S.sharded_trace(
            mesh, ba, imm, ts("dI0_new"), ts("T_cw_new"), ts("aff_new"),
            ts("exposure_new"), w, h, settings)))
    elif kind == "track":
        pyr = tuple(ts(f"pyr.{i}") for i in range(_count(a, "pyr")))
        tmpls = tuple(unpack(TK.LevelTemplate, f"tmpl.{i}", a, dev)
                      for i in range(_count(a, "tmpl")))
        intr = tuple(tuple(r) for r in a["intrinsics"].tolist())
        res = S.sharded_track(mesh, pyr, tmpls, ts("T_inits"), ts("aff0"),
                              ts("ref_aff"), ts("exposures"), intr,
                              len(intr))
        out.update({k: v.cpu().numpy() for k, v in res.items()})
    elif kind == "layout":
        ba = unpack(B.BAState, "ba", a, dev)
        out.update(pack("shard", S.shard_ba(ba, mesh)))
        odd = ba._replace(**{f: getattr(ba, f)[:-1]
                             for f in S._POINT_FIELDS})
        try:
            S.shard_ba(odd, mesh)
            out["odd_raised"] = np.bool_(False)
        except ValueError:
            out["odd_raised"] = np.bool_(True)
    elif kind == "scale":
        out.update(_scale_job(a, settings, meshes, dev))
    else:
        raise ValueError(f"unknown job {kind}")
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _scale_job(a: dict, settings, meshes: dict, dev) -> dict:
    """The sharded GN step at the window `a` on 1 rank and on every rank,
    interleaved: 3 windows x 3 steps each, the state nudged every step.
    Rank 0 reports each window's ms a step; the collectives' wall time of
    one more step on every rank is reported apart (with the card
    synchronized around each collective)."""
    import torch.distributed as dist
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.parallel import comm
    from sos_slam_tpu_torch.parallel import sharded as S
    ba = unpack(B.BAState, "ba", a, dev)
    dI = torch.as_tensor(a["dI"], device=dev)
    w, h = int(a["w"]), int(a["h"])
    nds = sorted(meshes)
    out = {}
    for nd in nds:          # warm each variant once
        m = meshes[nd]
        if m.rank >= 0:
            _, e = S.sharded_gn_step(m, ba, dI, settings, w, h)
            out[f"energy_{nd}"] = e.cpu().numpy()
        dist.barrier()
    reps = 3
    for win in range(3):
        for nd in nds:
            m = meshes[nd]
            dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            if m.rank >= 0:
                for r in range(1, reps + 1):
                    bx = ba._replace(state=ba.state + (win * reps + r) * 1e-9)
                    ba2, e = S.sharded_gn_step(m, bx, dI, settings, w, h)
                _sync(dev)
            out[f"ms_{nd}_{win}"] = np.float64(
                (time.perf_counter() - t0) / reps * 1e3)
            dist.barrier()
    m = meshes[max(nds)]
    comm.reset_stats(timed=True)
    S.sharded_gn_step(m, ba, dI, settings, w, h)
    out["comm_calls"] = np.int64(comm.STATS["calls"])
    out["comm_ms"] = np.float64(comm.STATS["seconds"] * 1e3)
    comm.reset_stats()
    return out


def _rank_main(rank: int, world: int, backend: str, device: str, run_dir: str,
               jobs: list) -> None:
    """A spawned rank: join the group, run `jobs` [(name, kind, settings)]
    on the inputs in run_dir, write run_dir/{name}.r{rank}.npz (or
    run_dir/error.r{rank}.txt and exit 1)."""
    try:
        torch.set_num_threads(1)
        from sos_slam_tpu_torch.ops import ba_p as BP
        from sos_slam_tpu_torch.parallel import sharded as S
        dev = S.rank_device(device, rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        S.init_ranks(rank, world, backend, os.path.join(run_dir, "store"))
        mesh = S.make_mesh(world, device)
        meshes = None
        for name, kind, settings in jobs:
            if kind == "scale" and meshes is None:
                meshes = {world: mesh}
                meshes[1] = S.make_mesh(1, device) if world > 1 else mesh
            with np.load(os.path.join(run_dir, f"{name}.in.npz")) as z:
                a = dict(z)
            BP.fused_iteration.launches = 0
            out = _run_job(kind, a, settings, mesh, meshes)
            out["k3_launches"] = np.int64(BP.fused_iteration.launches)
            np.savez(os.path.join(run_dir, f"{name}.r{rank}.npz"), **out)
        S.close_mesh()
    except BaseException:
        with open(os.path.join(run_dir, f"error.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


class Ranks:
    """Spawned ranks running a job list; `join` collects their outputs."""

    def __init__(self, n, run_dir, procs, jobs):
        self.n, self.run_dir, self.procs, self.jobs = n, run_dir, procs, jobs

    def _stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(10)

    def join(self, timeout: float = JOIN_S) -> dict:
        """Wait for every rank (at most `timeout` s; a rank that fails ends
        the others at once). Returns {job name: [rank 0's outputs, ...]}."""
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in self.procs):
                if any(p.exitcode not in (None, 0) for p in self.procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{self.n} ranks did not finish in {timeout} s")
                time.sleep(0.05)
        finally:
            self._stop()
        try:
            errs = []
            for r, p in enumerate(self.procs):
                path = os.path.join(self.run_dir, f"error.r{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
                elif p.exitcode != 0:
                    errs.append(f"rank {r}: exit code {p.exitcode}")
            if errs:
                raise RuntimeError("ranks failed\n" + "\n".join(errs))
            res = {}
            for name, _, _ in self.jobs:
                res[name] = []
                for r in range(self.n):
                    with np.load(os.path.join(
                            self.run_dir, f"{name}.r{r}.npz")) as z:
                        res[name].append(dict(z))
            return res
        finally:
            shutil.rmtree(self.run_dir, ignore_errors=True)


def spawn_ranks(n: int, jobs: list, device=None, backend=None) -> Ranks:
    """Start n ranks on `device` (CUDA unless named) running `jobs`, a
    list of (name, kind, inputs dict, settings) with kind one of gn, vio,
    trace, track, layout, scale; returns at once (`Ranks.join` waits).
    NCCL when every rank gets a card of its own, else gloo. On a card the
    kernels are built here first."""
    import torch.multiprocessing as mp
    from sos_slam_tpu_torch.parallel import sharded as S
    dev = resolve_device(device)
    backend = backend or S.default_backend(n, dev)
    if dev.type == "cuda":
        if backend == "nccl" and n > torch.cuda.device_count():
            raise RuntimeError(f"{n} NCCL ranks need {n} cards, there are "
                               f"{torch.cuda.device_count()}")
        from sos_slam_tpu_torch.utils import cuda_build
        cuda_build.build_all()
    run_dir = tempfile.mkdtemp(prefix="sos_slam_ranks_")
    for name, _, arrays, _ in jobs:
        np.savez(os.path.join(run_dir, f"{name}.in.npz"), **arrays)
    spec = [(name, kind, settings) for name, kind, _, settings in jobs]
    ctx = mp.get_context("spawn")
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_rank_main,
                            args=(r, n, backend, str(dev), run_dir, spec))
            p.start()
            procs.append(p)
    except BaseException:
        Ranks(n, run_dir, procs, spec)._stop()
        shutil.rmtree(run_dir, ignore_errors=True)
        raise
    return Ranks(n, run_dir, procs, spec)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def window_inputs(ba, dI, w: int, h: int, imu=None) -> dict:
    """A gn / vio / layout / scale job's inputs."""
    out = dict(pack("ba", ba), dI=dI.detach().cpu().numpy(), w=w, h=h)
    if imu is not None:
        out.update(pack("imu", imu))
    return out


def trace_inputs(ba, imm, dI0_new, T_cw_new, aff_new, exposure_new, w: int,
                 h: int) -> dict:
    return dict(pack("ba", ba), **pack("imm", imm),
                dI0_new=dI0_new.detach().cpu().numpy(),
                T_cw_new=T_cw_new.detach().cpu().numpy(),
                aff_new=aff_new.detach().cpu().numpy(),
                exposure_new=np.float32(exposure_new), w=w, h=h)


def track_inputs(pyr, tmpls, T_inits, intr) -> dict:
    return dict(pack("pyr", list(pyr)), **pack("tmpl", list(tmpls)),
                T_inits=T_inits.detach().cpu().numpy(),
                aff0=np.zeros(2, np.float32), ref_aff=np.zeros(2, np.float32),
                exposures=np.ones(2, np.float32),
                intrinsics=np.asarray(intr, np.float64))


def dryrun_jobs(n_devices: int) -> list:
    """The dry run's five jobs on its tiny inputs (made on the CPU)."""
    cpu = "cpu"
    ba, dI, settings, _ = tiny_window(n_frames=3, n_points=96, device=cpu)
    ba_v, dI_v, settings_v, imu = tiny_window(n_frames=5, n_points=96,
                                              with_imu=True, device=cpu)
    imm = tiny_pool(16 * n_devices, device=cpu)
    _, pyr, tmpls, intr, _ = tiny_scene(device=cpu)
    ba_b, dI_b, settings_b, _ = tiny_window(n_frames=3, n_points=P_BIG,
                                            n_slots=P_BIG, device=cpu)
    eye = torch.eye(4)
    return [
        ("gn", "gn", window_inputs(ba, dI, W, H), settings),
        ("vio", "vio", window_inputs(ba_v, dI_v, W, H, imu), settings_v),
        ("trace", "trace", trace_inputs(ba, imm, dI[0], eye, torch.zeros(2),
                                        1.0, W, H), settings),
        ("track", "track", track_inputs(pyr, tmpls, hypotheses(n_devices,
                                                               cpu), intr),
         settings),
        ("scale", "scale", window_inputs(ba_b, dI_b, W, H), settings_b),
    ]


def same_on_every_rank(res: dict, names) -> None:
    """Raise unless every rank returned the same bits for each job of
    `names` (their outputs are gathered, so replicated)."""
    for name in names:
        first = res[name][0]
        for r, other in enumerate(res[name][1:], 1):
            for k, v in first.items():
                if k in ("comm_ms", "comm_calls", "k3_launches"):
                    continue
                if v.tobytes() != other[k].tobytes():
                    raise AssertionError(f"{name}: {k} differs between rank "
                                         f"0 and rank {r}")


def dryrun_multichip(n_devices: int, device=None, extra_jobs=()) -> dict:
    """One sharded step of each core program on n_devices spawned ranks
    (on `device`: CUDA unless named), with the JAX package's tiny shapes,
    then the scaling line at P = P_BIG (1 rank against n_devices ranks).
    Prints the JAX dry run's lines. `extra_jobs` (name, kind, inputs,
    settings) run after the five. Returns {job: [outputs by rank]}."""
    dev = resolve_device(device)
    jobs = dryrun_jobs(n_devices) + list(extra_jobs)
    res = spawn_ranks(n_devices, jobs, dev).join()
    same_on_every_rank(res, [j[0] for j in jobs
                             if j[1] not in ("scale", "layout")])
    energy = float(res["gn"][0]["energy"])
    energy_v = float(res["vio"][0]["energy"])
    if not math.isfinite(energy):
        raise AssertionError("sharded BA produced non-finite energy")
    if not math.isfinite(energy_v):
        raise AssertionError("sharded VIO non-finite energy")
    if not np.isfinite(res["vio"][0]["imu.state"]).all():
        raise AssertionError("sharded VIO produced non-finite IMU state")
    good = res["track"][0]["good"]
    if not good.any():
        raise AssertionError("no tracking hypothesis converged")
    sc = res["scale"][0]
    nds = sorted({1, n_devices})
    for nd in nds:
        if not math.isfinite(float(sc[f"energy_{nd}"])):
            raise AssertionError(f"P={P_BIG} nd={nd} non-finite")
    windows = {nd: [float(sc[f"ms_{nd}_{w}"]) for w in range(3)]
               for nd in nds}
    rows = [(nd, float(np.median(windows[nd]))) for nd in nds]
    print(f"scaling: sharded_gn_step P={P_BIG} (points on dp, {dev.type} "
          f"mesh; median of 3 interleaved windows x 3 reps)")
    for nd, ms in rows:
        spread = (max(windows[nd]) - min(windows[nd])) / ms * 100.0
        print(f"  {nd:2d} device(s): {ms:8.1f} ms/step "
              f"(spread {spread:.0f}%)")
    if len(rows) == 2 and rows[1][1] > 0:
        print(f"  speedup x{rows[0][1] / rows[1][1]:.2f} at {rows[1][0]} "
              f"devices")
    print(f"dryrun_multichip({n_devices}): BA energy={energy:.1f}, "
          f"VIO energy={energy_v:.1f}, "
          f"track good={int(good.sum())}/{n_devices} — OK")
    return res


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m sos_slam_tpu_torch.parallel.dryrun",
        description="the multi-device dry run on N spawned ranks")
    ap.add_argument("n", type=int, nargs="?", default=int(
        os.environ.get("N_DEVICES", "8")))
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the default)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry() check OK:", tuple(out.shape))
    return 0


if __name__ == "__main__":
    sys.exit(main())
