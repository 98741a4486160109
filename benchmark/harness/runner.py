"""One run of one cell: set-up, the measured window through
`SlamNode.process` with host uint8 frames, the end-to-end or per-layer
metrics, and the comparison that decides `correct`.

Set-up, in order: import the program, load (the first run of a checkout:
build) its kernels, render the cell's frame ring on the device from the
traffic file (its texture and noise seeds) and copy it to the host as
uint8 (with the IMU, for stereo + VIO),
build the node at the program's defaults, run the bootstrap frames until
the window has held max_frames keyframes and one has been marginalized,
then `fs.prewarm()`, then the frames up to the traffic's
`window_start_frame`. The window opens when that frame is handed in, at
the same point of the flight in every run; frames follow in a closed loop
(the next as soon as `process` returns) for the run's seconds, then
`fs.finish_pending()`, and it closes when the last pose is published.
The run's seed draws the window frames whose intake the check compares.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness import manifest as MF
from benchmark.harness.probes import IntakeTap, PoseStamps
from benchmark.reference import check as CHK
from benchmark.reference import evaluate as EV
from benchmark.reference.camera import CameraModel
from benchmark.scene import ring as RING


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class RunFailed(RuntimeError):
    """The run cannot produce a result (set-up did not reach the window)."""


@dataclass
class View:
    """What the per-layer readers read, after the window."""
    cell: MF.Cell
    device: object
    torch: object
    window: List[int]
    published: List[int]
    latency_ms: List[float]
    window_s: float
    process_ms: List[float]
    add_frame_ms: List[float]
    timers_ms: Dict[str, List[float]]
    eager: Optional[Dict[str, int]]
    n_kf: int
    util: List[float]
    ring: RING.Ring
    cams: List[CameraModel]
    settings: object


def _booted(fs, stamps: PoseStamps, settings) -> bool:
    return (fs.initialized
            and (not settings.enable_imu or fs.imu_initialized)
            and fs.stats["n_kf"] >= settings.max_frames
            and stamps.marginalized >= 1)


def _timers(fs) -> Dict[str, int]:
    return {k: len(v) for k, v in fs.telemetry.timers.items()}


def run(cell: MF.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: Optional[str] = None) -> dict:
    """The result object of one run (the line the command prints). With
    `control="tf32"` the run is the correctness control: the program's
    float32 matmuls in TF32, and the plain remap in TF32 in the intake's
    place."""
    import torch

    import sos_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    back = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        return _run(cell, seed, seconds, trace, device, t_start, control)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = back


def _run(cell, seed, seconds, trace, device, t_start, control):
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    from sos_slam_tpu_torch.io.node import SlamNode
    from sos_slam_tpu_torch.utils import cuda_build
    from sos_slam_tpu_torch.utils.config import default_settings
    if cuda:
        cuda_build.build_all()
        for name in cuda_build.SOURCES:
            cuda_build.load(name)
    t_import = time.perf_counter()

    cams = [CameraModel.load(str(cell.config_dir / f)) for f in cfg["calib"]]
    ring = RING.make_ring(tr, cfg, cams, dev)
    t_ring = time.perf_counter()
    settings = default_settings(**cfg["settings"])
    T_stereo = None
    if len(cams) > 1:
        rig = np.eye(4)
        rig[:3, 3] = cfg["stereo_right_in_left_m"]
        T_stereo = np.linalg.inv(rig).astype(np.float32)
    calib = [str(cell.config_dir / f) for f in cfg["calib"]]
    node = SlamNode(settings, calib[0],
                    calib1=calib[1] if len(calib) > 1 else None,
                    T_stereo=T_stereo, device=dev)
    stamps = PoseStamps()
    node.extra_wrappers.append(stamps)
    node.fs.output_wrappers.append(stamps)
    tap = IntakeTap(set())
    tap.attach(node.fs)
    process_ms: List[float] = []

    def feed(k: int, timed: bool = False) -> None:
        right = ring.frame(k, 1) if ring.right is not None else None
        imu = ring.imu_for(k) if ring.acc is not None else None
        t0 = time.perf_counter()
        node.process(ring.frame(k), ring.frame_time(k), image_right=right,
                     imu_samples=imu)
        if timed:
            process_ms.append((time.perf_counter() - t0) * 1e3)
        tap.attach(node.fs)

    k = 0
    k_open = int(tr["window_start_frame"])
    while not _booted(node.fs, stamps, settings):
        if k >= k_open:
            raise RunFailed(
                f"the bootstrap did not fill the window in {k} frames "
                f"(initialized {node.fs.initialized}, keyframes "
                f"{node.fs.stats['n_kf']}, marginalized "
                f"{stamps.marginalized})")
        feed(k)
        k += 1
    n_boot = k
    t_boot = time.perf_counter()
    node.fs.prewarm()
    t_warm = time.perf_counter()
    while k < k_open:
        feed(k)
        k += 1

    # ---- the window ---------------------------------------------------
    fs = node.fs
    rng = np.random.default_rng([abs(int(seed)) % (1 << 64), 7])
    offsets = rng.choice(int(tr["intake_sample_span"]),
                         int(tr["intake_samples"]), replace=False)
    tap.sample = {k + int(o) for o in offsets}
    tap.timing = trace
    timers0, kf0 = _timers(fs), fs.stats["n_kf"]
    eager0 = dict(fs.fused_graph.eager) if fs.fused_graph else None
    sampler = None
    if trace and cuda:
        from benchmark.harness.utilization import Sampler
        sampler = Sampler(torch, dev)
        sampler.start()
    hand: Dict[int, float] = {}
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    while True:
        now = time.perf_counter()
        if now - t_open >= seconds:
            break
        hand[k] = now
        feed(k, timed=trace)
        k += 1
    node.fs.finish_pending()
    t_end = time.perf_counter()
    util = sampler.stop() if sampler else []
    tap.timing = False
    window = list(hand)
    published = [i for i in window if i in stamps.time]
    t_close = max((stamps.time[i] for i in published), default=t_end)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    same_system = node.fs is fs
    log(f"[run] set-up {setup_s:.3f} s (import + kernels "
        f"{t_import - t_start:.3f}, ring {t_ring - t_import:.3f}, "
        f"bootstrap {n_boot} frames {t_boot - t_ring:.3f}, prewarm "
        f"{t_warm - t_boot:.3f}, frames to {k_open} "
        f"{t_open - t_warm:.3f}); window {len(window)} frames, "
        f"{len(published)} published in {t_close - t_open:.3f} s; "
        f"keyframes {fs.stats['n_kf'] - kf0}; peak {peak} bytes")

    # ---- what the program produced, copied out for the check ---------
    vio = settings.enable_imu
    traj = fs.trajectory(scaled=settings.enable_scale_opt)
    shells = {sh.id: sh for sh in fs.shells}
    ba = fs.ba
    pv = ba.pt_valid.cpu().numpy()
    slot_ids = np.array([fs.shells[i].id for i in fs.frame_shell_idx]
                        + [-1] * (fs.F - len(fs.frame_shell_idx)))
    host = ba.host.cpu().numpy()[pv]
    points = dict(u=ba.u.cpu().numpy()[pv].astype(np.float64),
                  v=ba.v.cpu().numpy()[pv].astype(np.float64),
                  idepth=ba.idepth.cpu().numpy()[pv].astype(np.float64),
                  host_id=slot_ids[host])
    keep = points["host_id"] >= 0
    points = {n: a[keep] for n, a in points.items()}
    outputs = CHK.Outputs(
        window=window, poses=dict(stamps.pose), affs=dict(stamps.aff),
        intake=tap.host_frames(),
        points=points, keyframes=traj if settings.enable_scale_opt else None,
        gyro_bias=(np.array(fs._last_bg) if vio and fs._last_bg is not None
                   else None))

    # ---- end to end ------------------------------------------------------
    metrics: Dict[str, dict] = {}
    failed = len(window) - len(published) + (0 if same_system else 1)
    if not trace:
        values = dict(fps=len(published) / (t_close - t_open),
                      setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m.name] = dict(value=float(values[m.name]), unit=m.unit)

    result = dict(attempted=len(window), failed=failed)
    device_info = dict(
        platform="gpu" if cuda else dev.type,
        kind=torch.cuda.get_device_name(dev) if cuda else dev.type,
        count=1, memory_peak_bytes=peak)

    # ---- per layer -----------------------------------------------------
    if trace:
        timers1 = fs.telemetry.timers
        view = View(
            cell=cell, device=dev, torch=torch, window=window,
            published=published,
            latency_ms=[(stamps.time[i] - hand[i]) * 1e3 for i in published],
            window_s=t_close - t_open,
            process_ms=process_ms, add_frame_ms=list(tap.spans_ms),
            timers_ms={n: v[timers0.get(n, 0):] for n, v in timers1.items()},
            eager=({r: n - eager0.get(r, 0)
                    for r, n in fs.fused_graph.eager.items()}
                   if fs.fused_graph else None),
            n_kf=fs.stats["n_kf"] - kf0, util=util, ring=ring, cams=cams,
            settings=settings)
        for m in cell.per_layer:
            value = MF.reader(m.name)(view)
            if value is not None:
                metrics[m.name] = dict(value=float(value), unit=m.unit)
        if cuda:
            seg = _profiled_segment(torch, dev, node, tap, feed, k,
                                    int(tr["profile_frames"]))
            device_info.update(busy_s=seg["busy_s"],
                               window_s=seg["window_s"])
            result["breakdown"] = dict(device_ops=seg["device_ops"],
                                       idle_gaps=seg["idle_gaps"])

    # ---- the comparison -------------------------------------------------
    del node, fs, ba
    truth = CHK.Truth(ring=ring, cams=cams, plane_z=ring.flight.plane_z,
                      gyro_bias=(np.asarray(cfg.get("imu_bias_g"))
                                 if vio else None))
    got = CHK.numbers(outputs, truth, vio, control=control is not None)
    got["kf_ate_mm"] = _ate_mm(traj, shells, ring, settings.enable_scale_opt)
    limits = dict(cfg["limits"])
    ok, rows = CHK.judge(got, limits)
    # a run must publish every frame of its window
    rows.append(("failed_frames", float(failed), 0.0))
    log("[check] every number: " + ", ".join(
        f"{n} {v:.6g}" for n, v in got.items()))
    result.update(correct=bool(ok and failed == 0),
                  metrics=metrics, device=device_info)
    result["numbers"] = {n: float(v) for n, v in got.items()}
    result["checks"] = {n: dict(value=float(v), limit=float(lim))
                        for n, v, lim in rows}
    return result


def _ate_mm(traj: np.ndarray, shells: dict, ring: RING.Ring,
            metric: bool) -> float:
    """RMSE (mm) of the positions of every keyframe of the run, the
    bootstrap's and the window's: Sim(3)-aligned for mono; for stereo + VIO
    metric and unaligned, the flight put in the system's world through the
    first keyframe (whose pose the system sets from gravity, not
    estimates)."""
    rows = traj
    if len(rows) < 3:
        return float("nan")
    ids = rows[:, 0].astype(int)
    gt = np.stack([ring.gt_pose(i) for i in ids])
    if not metric:
        return 1e3 * EV.ate_rmse(rows[:, 1:4], gt[:, :3, 3], True)
    first = shells[ids[0]]
    E0 = first.cam_to_world_scaled if first.cam_to_world_scaled is not None \
        else first.cam_to_world
    W = np.asarray(E0, np.float64) @ np.linalg.inv(gt[0])
    gt_sys = (W @ gt)[:, :3, 3]
    return 1e3 * EV.rmse(rows[:, 1:4], gt_sys)


def _profiled_segment(torch, dev, node, tap, feed, k0: int, n: int) -> dict:
    """Frames k0.. k0+n-1 and the drain under torch.profiler, with the
    benchmark's spans as record_function ranges."""
    from torch.profiler import record_function

    from benchmark.harness.devtrace import profile_segment

    def body():
        for k in range(k0, k0 + n):
            with record_function("SlamNode.process"):
                feed(k)
        with record_function("FullSystem.finish_pending"):
            node.fs.finish_pending()

    tap.annotate = True
    try:
        return profile_segment(torch, dev, body)
    finally:
        tap.annotate = False
