#!/usr/bin/env python3
"""Drive the PyTorch port (sos_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

In order, failing (exit code != 0, no result line) at the first fault:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every CUDA kernel of csrc/ compiled from the checkout (one
     nvcc per source, all at once); then the process's first-use costs,
     each first call against its second ([prewarm] first use): build_all
     with every library cached, each library's load, the first tensor on
     the card (the CUDA context), numerics.solve and inv (solve_ex,
     inv_ex) at the tracker's shapes;
  3. kernels: a run of the bench main scene (640x480, default settings)
     up to its first point marginalization records each kernel's inputs
     at the main path's shapes;
     each kernel is then held against its plain PyTorch twin on those
     inputs (floats: rtol 2e-4, atol 2e-4 * max(1, max|plain|), K3's
     Hessians also on their diagonal-normalized form; states, masks and
     K2's `idn` and `good`: exact); K1 and K2 at their whole-call entries
     (all levels in one launch), also bit for bit against one launch per
     level, K1 also at 1 and 3 levels and at 328x248 (no whole number of
     tiles, coarse rows off 16 bytes); K3 and K4 also at ragged shapes on
     seeded synthetic inputs (P, N that fill no block, F = 1..16, an empty
     pmask, an all-OOB window, NaN taps in dead frames); every kernel
     launched twice and required to repeat bit for bit;
  4. the slice: the full bench main scene (48 frames, twist
     (0.03, 0.012, 0.02, 0.002, 0.004, 0.001), plane_z 2.0) through the
     port's FullSystem on the card, at its default (the pipelined fused
     path, 3 frames in flight, drained with finish_pending at the end,
     the frame step as CUDA graphs: models/frame_graph.py; every phase
     runs that default unless it says otherwise),
     FullSystem.prewarm() before frame 26 as bench.py calls it (outside
     the frame timers; its launches, taken off the counters, and its wall
     ms are printed), with every launch counter set to 0
     just before and read just after; initialized, not lost, and the
     scale-aligned ATE <= 0.05 * path + 0.02, as bench.py gates it; K1
     launched once per pyramid built (build_pyramid calls and replays of
     the frame graph's (A), each counting its captured launch) and K2
     once per template built; the
     selector rung after each keyframe printed, and gated on staying in
     the prewarmed set from frame 26 on;
  5. the breakdown: 4 more frames through the same FullSystem under
     torch.profiler (the card's busy share and its top device ops);
  5a. the [prewarm] phase on that FullSystem: every tensor of the window,
     the immature pool, the image stack, HdiF, the templates, the key,
     host_out and the rung the same bits before and after prewarm(); its
     second and third call against the first (step 4's) in wall ms, and
     stage by stage: the 5-wide and 78-wide fallback tracks and the dummy
     frame dispatch at each rung;
  5b. the [snapshot] phase: frames 0-23 of the same scene through a new
     FullSystem, save_snapshot; a fresh FullSystem, load_snapshot and
     frames 24-47 with every launch counter from 0 (`launches_snapshot`)
     and a MapViewer and a DebugPlotDumper (mode 0, tracking on) attached:
     gated on the keyframe ids of step 4's uninterrupted run, its
     trajectory bit for bit (what tests/test_torch_snapshot.py finds on
     the CPU) and within 5e-3, K1-K4 launched, one map PNG per render and
     two debug PNGs per window slot and dump, and the last map PNG
     decoded with zlib alone equal to render_array(); it prints the
     snapshot's bytes and the save and load ms. Then the same snapshot
     in the JAX package's layout (its `port.*` entries dropped): the
     template rebuilt on load by one K2 launch, frames 24-47 within
     5e-3;
  6. the flagship scene (bench.py's _bench_full_config: stereo + spline
     VIO, 640x480, 44 frames at 10 Hz on a bounded sinusoidal trajectory,
     200 Hz IMU, right camera at a 0.11 m baseline,
     default_settings(weight_imu_dso=6, scale_opt_thres=12, min_g_imu=10))
     through the port's FullSystem, every launch counter from 0: gated on
     initialized, not lost, the IMU initialized, the stereo scale trapped,
     the fused VIO chain run, the VIO prior finite after the run and
     before every VIO frame marginalization, the stereo scale after every
     keyframe from frame 35 on within 1% of the first one's, the scaled
     trajectory's metric ATE (no alignment) <= 0.15 * path + 0.03, K1-K4
     each
     launched, K1 once per pyramid built (left and right) and K2 once per
     template; it prints
     the keyframe count, ATE, scale, steady fps over frames 30-43 (as
     bench.py measures it) and the median of the frames that dispatch a
     keyframe chain; then K3 on a VIO GN
     step and a VIO point marginalization, K4 on an activation pass and K1
     on a right image of this run against their plain twins; the same
     frames twice more with every VIO frame marginalization folded both by
     the port (`energy.fold_vio_block`, the live subspace of the block
     without an eigendecomposition) and by the float64 fold from an
     eigendecomposition (`live_fold64`), the runs going on with the one
     and with the other: one line a marginalization (the block's zero
     rows, its smallest and largest eigenvalue, the scale row of both
     folds), one a keyframe from frame 35 on (its scale and the scale's
     GN steps, the wall ms of both folds), gated on the port's fold
     within 1e-4 of the reference; the same frames once with the port's
     fold and once with the JAX package's NaN-prior fold (`jax_form=True`),
     the keyframe chain's stages timed, for the cost of the working VIO
     BA; and 2 more frames under torch.profiler;
  6a. the [pipeline] phase: the mono scene at depth 0 (synchronous) and
     depth 3 in turns (the order alternating), twice each, every
     run bit for bit the pipelined slice of step 4, with its steady fps,
     its host stage timers, the frames dispatched again after a rung
     change and the card's busy share under the profiler; the flagship
     scene's first 36 frames (the IMU initialization and two VIO frame
     marginalizations) at depth 0
     and 3, each drained, bit for bit on the trajectories, the window and
     the VIO prior; the most frames seen in flight (at least 2);
  6a'. the [graph] phase: the mono scene in the eager form
     (cuda_graphs=False) and the graph form in turns (the order
     alternating), three times each, every run bit for bit the mono
     slice of step 4, with its steady fps, its median frame with and
     without a keyframe chain, the card's busy share, device ms and device
     ops a frame under the profiler, and for the graph form the capture
     ms, the graph pool's bytes, the replays of each graph, the frames
     tracked again eagerly, the retries and the LM iterations (mean and
     most) of the primary track by
     level; one more run of each form counting the synchronising calls of
     each frame (torch.cuda.set_sync_debug_mode): at most 2 in a steady
     frame that dispatches no keyframe chain in the graph form (gated),
     the eager form's beside it; the primary track on one steady frame's
     inputs as graph (A) in the steady and the full bounded form (device
     ms a replay) and eagerly (wall ms); the flagship's first 36 frames
     in both forms, bit for bit on the trajectories, the window and the
     VIO prior;
  6b. the [loop] phase: (a) the flagship scene's frames through the port's
     SlamNode (pinhole camera files, no rectification, loop closure on
     at a 40 m LiDAR range, the loop handler synchronous so that its
     errors propagate), every launch counter from 0: gated on the
     flagship phase's keyframes (loop closure changes no odometry
     result, and `none` rectification hands the frames on unchanged),
     one handler record per marginalized keyframe,
     an odometry edge with a finite dso_error between each consecutive
     pair, at least one scan, poses.txt rows whose metric ATE passes the
     flagship gate, and K1-K4 launched (`launches_node`), and the loop
     handler's scan timer as a share of the run's wall time; (c)
     estimate_direct on the record of (a) with the most points, against
     its own pyramid from 2 cm and 1 deg off, accepted, card = CPU at the
     tracker's tolerances (1e-4 on T, 1e-3 on the residual); (b)
     LoopHandler alone on tests/test_loop_closure_e2e.py's pillar scene,
     synchronously then asynchronously: a loop edge, ICP-verified, the
     drift corrected (rigid-aligned ate_rmse < 0.6 x the odometry's), both
     modes the same poses; (d) optimize_pose_graph at 1000 keyframes on
     tests/test_loop.py's graph: its loop-error gates, first and warm
     wall times;
  6c. the [multidevice] phase (parallel/sharded.py, parallel/dryrun.py):
     (a) NCCL at world size 1 in this process: sharded_gn_step on the
     window of step 3's last K3 GN call (P = 2048, F = 8, 640x480) and on
     the dry run's tiny window, bit for bit energy.gn_step, K3's two
     kernels by name in a sharded step (profiler); sharded_vio_gn_step on
     the dry run's 5-frame IMU window bit for bit gn_step_vio;
     sharded_trace of the mono scene's immature pool against its next
     frame bit for bit trace_new; every launch counter from 0, K3 once a
     step and no other kernel; gn_step and the one-rank sharded step in
     ms a step (CUDA events) at P = 2048 and 16384, and the collectives'
     wall ms a step; (b) dryrun_multichip(2): two spawned gloo ranks on
     this card (gloo stages the CUDA tensors through host memory), its
     five jobs plus the main window's step and its scaling line; the
     gathered states of the BA, main and VIO steps within 1e-4 of (a)'s
     single-rank steps (relative to max(1, max|x|)), energy rtol 1e-4,
     res_state exact, every rank's outputs the same bits (each step checks
     that x agrees on the ranks), K3 launched on every rank; 1 rank
     against 2 in ms a step at P = 2048 and 16384, and the two ranks'
     collectives' wall ms a step;
  7. kernel times on the inputs of step 3 (after the slices, so that the
     profiler cannot slow them), three measures of each kernel: one
     pair of CUDA events around 200 back-to-back launches queued behind a
     sleeping kernel (device time a launch with the queue full, no
     profiler; three times, SM and memory clocks before and after: the
     `ms` of the kernels line is their median), the card's time per call
     from torch.profiler over 30 calls (every profiler window opens with
     throwaway launches of a spin kernel, because the profiler drops the
     first events of a window), and the CUDA-event wall time of a
     single call; beside them the plain twin's times and the bound worked
     out from the bytes and operations. For K1, K2 and K3 also each
     launch's device time by kernel name (K1 and K2: one launch a call,
     K3: two), and for the whole wrappers (build_pyramid,
     build_track_template, fused_iteration, act_pass) the device ops a
     call and the host-device copies among them (K3: none allowed);
     then the launch counts of the four runs and the kernels line (one
     JSON object; `launches` counts the mono slice, `launches_flagship`
     the flagship scene, `launches_node` the SlamNode run,
     `launches_snapshot` the resumed half of step 5b,
     `launches_multidevice` the calls of step 6c: (a)'s and the ranks');
  8. last line: {"ok": true, "device": {...}}.

Needs one card; exits with code 2 when CUDA is unavailable or the port is
not importable beside this script.
"""

from __future__ import annotations

import collections
import gc
import json
import subprocess
import sys
import time
import traceback
import zlib

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # fp32 without tensor cores, data sheet
W, H, N_FRAMES, WARMUP = 640, 480, 48, 26
PROF_FRAMES = 4   # frames after the slice run under the profiler
FLAG_PROF_FRAMES = 2   # the same after the flagship scene
TWIST = (0.03, 0.012, 0.02, 0.002, 0.004, 0.001)
TOL = 2e-4
REPS = 30
PROFILE_TRIES = 3  # windows of the profiler before a cut one is an error
# torch.profiler on the H100's machine (torch 2.11, CUDA 12.8) drops the
# first device events of every window, more the longer the process has run
# (255 by 370 s of this script): every window opens with PRELUDE[0] launches
# of the spin kernel, which no measured function launches, and counts as
# whole only if the profiler kept at least one of them; the prelude doubles
# for later windows once a window drops half of it
PRELUDE = [1000]
QUEUED = 200      # back-to-back launches under one pair of events
# device ops a call of the whole K3 wrapper in the first Hopper design
# (five launches, float copies of the masks; scripts/torch_kernel_times.py
# on that commit, NVIDIA H100 80GB HBM3)
K3_WRAPPER_OPS_FIRST_DESIGN = 150
# the same for build_pyramid (4 levels) and build_track_template when K1
# and K2 took one launch per level (same script on that commit, same card)
K1_WRAPPER_OPS_FIRST_DESIGN = 4
K2_WRAPPER_OPS_FIRST_DESIGN = 427
RAGGED_HW = (248, 328)   # divisible by 8, fills no whole number of K1 tiles
JAX_REFERENCE = "JAX package on the same scene: 22 keyframes, ATE 0.0103 m " \
                "over 1.786 m (BENCH_r05.json, not asserted)"
# the flagship scene (bench.py's _bench_full_config): stereo + spline VIO
# on the bounded sinusoidal trajectory, 10 Hz frames, 200 Hz IMU
FLAG_FRAMES, FLAG_WARMUP, FLAG_DT = 44, 30, 0.1
FLAG_SCALE_FROM = 35   # the flagship's stereo scale holds within 1% from here
# the [pipeline] phase: depth 0 and 3 in turns, steady fps over frames
# WARMUP..PIPE_PROF_FROM-1 and the busy share over the rest; the flagship
# frames up to two VIO frame marginalizations after the IMU initialization
PIPE_PAIRS, PIPE_PROF_FROM, PIPE_FLAG_FRAMES = 3, 46, 36
GRAPH_PAIRS = 3   # the [graph] phase: eager and graph form in turns
# K1-K4 launches of the eager form (cuda_graphs=False) over the mono scene's
# frames: the mono slice's count before the keyframe chain ran as graphs
MONO_EAGER_LAUNCHES = [73, 22, 134, 88]
JAX_FLAGSHIP = "JAX package on the same scene: 11 keyframes in 44 frames " \
               "(BENCH_r05.json, a TPU v5e run; history, not asserted)"
# the loop phase: the flagship scene through SlamNode at this LiDAR range,
# and tests/test_loop_closure_e2e.py's pillar scene for the handler alone
LOOP_LIDAR = 40.0
LOOP_KFS, LOOP_RANGE = 20, 30.0
PILLAR_INTR = ((300.0, 300.0, 128.0, 96.0),)


def log(msg):
    print(msg, flush=True)


T_START = time.perf_counter()


def phase_done(name):
    log(f"[time] {name} done {time.perf_counter() - T_START:.1f} s into the "
        "run")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Wraps a module-level kernel wrapper and keeps its last `keep` calls'
    arguments, and the last call of each kind that `kind(args, kw)` names.
    The wrapper counts its launches through its module-level name, which
    now names the recorder: `launches` forwards to it."""

    def __init__(self, module, name, keep, kind=lambda a, kw: None):
        self.module, self.name, self.kind = module, name, kind
        self.orig = getattr(module, name)
        self.calls = collections.deque(maxlen=keep)
        self.last_of = {}
        self.n_of = collections.Counter()
        self.n_calls = 0
        setattr(module, name, self)

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, n):
        self.orig.launches = n

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        self.n_calls += 1
        kind = self.kind(args, kw)
        self.last_of[kind] = (args, kw)
        self.n_of[kind] += 1
        return self.orig(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.orig)


class StageTimer:
    """Wraps a module-level function (or an instance's method) and adds up
    its wall ms a call, the card synchronized before and after: the host
    dispatch and the device work of the stage."""

    def __init__(self, torch, owner, name):
        self.torch, self.owner, self.name = torch, owner, name
        self.orig = getattr(owner, name)
        self.ms = []
        setattr(owner, name, self)

    def __call__(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.orig(*args, **kw)
        self.torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def restore(self):
        setattr(self.owner, self.name, self.orig)


def gram_form(k, p):
    """Both Hessians divided by sqrt(p_ii p_jj) over their last two axes
    (where that is > 0): each entry of a Gram matrix J^T J then lies in
    [-1, 1], so rows of small scale (the exposure rows) are held to the
    same tolerance as the largest instead of vanishing under it."""
    k = k.detach().double().cpu().numpy()
    p = p.detach().double().cpu().numpy()
    d = np.abs(np.diagonal(p, axis1=-2, axis2=-1))
    dd = np.sqrt(d[..., :, None] * d[..., None, :])
    dd = np.where(dd > 0, dd, 1.0)
    return k / dd, p / dd


def compare(name, pairs, exact_pairs, gram_pairs=()):
    """(max |kernel - plain|, the largest share of its tolerance that any
    entry uses) over float outputs (NaN where both are NaN) and over the
    Gram-normalized forms of `gram_pairs`; raises when a float pair leaves
    the tolerance or an exact pair differs."""
    worst = used = 0.0
    pairs = list(pairs) + [gram_form(k, p) for k, p in gram_pairs]
    for i, (k, p) in enumerate(pairs):
        if not isinstance(k, np.ndarray):
            k = k.detach().float().cpu().numpy()
            p = p.detach().float().cpu().numpy()
        both_nan = np.isnan(k) & np.isnan(p)
        if (np.isnan(k) != np.isnan(p)).any():
            raise AssertionError(f"{name}: output {i} NaN pattern differs")
        k, p = np.where(both_nan, 0, k), np.where(both_nan, 0, p)
        scale = max(1.0, float(np.max(np.abs(p)))) if p.size else 1.0
        err = np.abs(k - p)
        lim = TOL * np.abs(p) + TOL * scale
        bad = err > lim
        if bad.any():
            raise AssertionError(
                f"{name}: output {i} off by up to {err.max():.3e} "
                f"(scale {scale:.3e}) at {int(bad.sum())} entries")
        if err.size:
            worst = max(worst, float(err.max()))
            used = max(used, float((err / lim).max()))
    for i, (k, p) in enumerate(exact_pairs):
        if not bool((k.cpu() == p.cpu()).all()):
            raise AssertionError(f"{name}: exact output {i} differs at "
                                 f"{int((k.cpu() != p.cpu()).sum())} entries")
    return worst, used


def worse(a, b):
    return max(a[0], b[0]), max(a[1], b[1])


def gpu_clocks() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def queued_ms(torch, fn, n=QUEUED, repeats=3):
    """Device ms a call of `fn` with the queue full, `repeats` times: one
    pair of CUDA events around `n` back-to-back calls that were enqueued
    while a sleeping kernel held the stream, so the host's launch cost is
    hidden and the card runs them without a gap. The queue held only if
    the sleep had not ended when the host enqueued the last call (the
    first event not yet reached, `Event.query`); a repeat whose queue ran
    dry is taken again with twice the sleep, up to four times, then an
    error. No profiler. Returns (the ms of each repeat, clocks before,
    clocks after)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0       # the host's time to enqueue n
    torch.cuda.synchronize()
    khz = torch.cuda.get_device_properties(0).clock_rate
    cycles = int((1.5 * host_s + 0.005) * khz * 1e3)
    before = gpu_clocks()
    out = []
    for _ in range(repeats):
        for _ in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            for _ in range(n):
                fn()
            held = not a.query()
            b.record()
            b.synchronize()
            if held:
                out.append(a.elapsed_time(b) / n)
                break
            cycles *= 2
        else:
            raise AssertionError("the queue ran dry behind four sleeps")
    return out, before, gpu_clocks()


def time_ms(torch, fn):
    """(device ms, wall ms) of one call of `fn`: the device time is the sum
    of the card's kernel time over REPS calls (torch.profiler, CUPTI) per
    call; the wall time is the median of CUDA events around each call,
    host launch overhead included (the card idles while tiny kernels are
    enqueued)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ev = profiled(torch, fn)
    dev_us = sum(e.self_device_time_total for e in ev)
    if dev_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return dev_us / REPS / 1e3, float(np.median(times))


# the most device events a profiler window dropped (all of them from its
# prelude), logged with the kernel times
PROFILER_DROPPED = [0]


def prof_window(torch, body, tries=PROFILE_TRIES):
    """Runs body() under torch.profiler behind PRELUDE[0] launches of the
    spin kernel: (what body returned, the device events of body). The
    profiler drops events only from the start of a window, so a window that
    kept one of the prelude's launches kept all of body's; a window cut
    into body is taken again with twice the prelude, `tries` windows in
    all, then an error."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        n = PRELUDE[0]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            out = body()
            torch.cuda.synchronize()
        ev = device_events(prof)
        kept = sum(e.count for e in ev if "spin_kernel" in e.key)
        PROFILER_DROPPED[0] = max(PROFILER_DROPPED[0], n - kept)
        if 2 * (n - kept) > n:
            PRELUDE[0] = 2 * n
        if kept:
            return out, [e for e in ev if "spin_kernel" not in e.key]
        log(f"[profiler] a window dropped all {n} launches of its prelude; "
            "taken again")
    raise AssertionError(f"{tries} profiler window(s) in a row dropped "
                         "every launch of their prelude")


def profiled(torch, fn):
    """The device events of REPS calls of `fn` under torch.profiler, every
    one of them kept (`prof_window`)."""
    return prof_window(torch, lambda: [fn() for _ in range(REPS)])[1]


def device_ops(torch, fn):
    """(device ops a call of `fn`, the names of the copies among them that
    cross between host and device)."""
    ev = profiled(torch, fn)
    crossing = sorted({e.key for e in ev if "Memcpy" in e.key
                       and "DtoD" not in e.key})
    return sum(e.count for e in ev) / REPS, crossing


def device_events(prof):
    """The profile's events that ran on the card (kernels, copies, sets).
    A PyTorch operator's own event carries its kernels' time as well, so
    summing every event would count each kernel twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def bound(nbytes, flops):
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_f = flops / H100_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def k1_bytes(w, h, n_levels):
    """Bytes K1 must move for n_levels of a w x h frame in one call: the
    frame read once (the coarser levels are formed from it and never cross
    device memory) and, per pixel of every level, [I, dx, dy] and |grad|^2
    written once. No `down` is counted: the frame path asks for none."""
    px = sum((w >> lv) * (h >> lv) for lv in range(n_levels))
    return 4 * (w * h + px * (3 + 1))


def k3_kind(args, kw):
    """A K3 call's mode: a GN linearization, or a point marginalization
    (use_rz) on a non-empty or an empty set of points."""
    if not kw.get("use_rz", False):
        return "gn"
    return "rz" if bool(kw["pmask"].any()) else "rz-empty"


def k3_caller(args, kw):
    """What a K3 call serves on the flagship path: the function that called
    K3's caller (gn_step_vio, optimize_vio, marginalize_points_vio, ...),
    marked "-empty" for a point marginalization without points."""
    name = sys._getframe(3).f_code.co_name
    if kw.get("use_rz", False) and not bool(kw["pmask"].any()):
        return name + "-empty"
    return name


def pyramid_side(args, kw):
    """"right" for the stereo scale solve's pyramid of the right image,
    "left" for every other pyramid FullSystem builds."""
    return "right" if sys._getframe(2).f_code.co_name == "_scale_solve" \
        else "left"


def k3_bytes(P, F, D):
    """Bytes K3 must move at P points, F frames (each input read once, each
    output written once; the projection and tap gather are not K3's):
    in: taps [I,dx,dy] + ok (P,F,8,4) f32; 24 f32 per point (u, v,
    idepth, idepth_zero, prior, valid, pmask, 8 colors, 8 weights, host);
    res_exist + OOB (P,F); 150 f32 per (host, target) (R0 9, t0 3, affine
    2, adHTdelta 8, adHost 64, adTarget 64); b0, energy_th, frame_valid;
    out: v (D,P), srows (4,P), energy + energy_raw (F,P) f32, state (F,P)
    int8, acc (F,F,13,13) and [H_sc | b_sc] (D,D+1) f32."""
    n_in = P * F * 8 * 4 + P * 24 + 2 * P * F + F * F * 150 + 3 * F
    n_out = D * P + 4 * P + 2 * F * P + F * F * 169 + D * (D + 1)
    return 4 * (n_in + n_out) + F * P


def k3_flops(P, F, D):
    """Floating-point operations K3 must do at P points, F frames, in GN
    mode, counted from csrc/ba_fused.cu (a multiply, add, divide or square
    root is one; each distinct entry of a symmetric sum is counted once).
    The residual pass, per (point, frame): projection 18; 1/z, pixel, idepth 8;
    d(pixel)/d(idepth) 8; the four FEJ coefficients 16; the 2x10 X rows 34;
    per tap 30 (residual 3, d/dA 1, |g|^2 3, gradient weight 3, weight 2,
    Huber 2, energy 7, weighted rows 6, |J|^2 3) x 8 = 240; the 9 tap sums
    (2 each) x 8 = 144; Hdd, bd, Hcd, JpJd 54; the gram rows Y (10 x 3)
    x 8 = 240; the adjoint stitch of v 272 (host 8x8x2, target 8x8x2, sum
    16): 1034. The cell sums, per (point, frame): 8 taps x the 91 distinct
    (a, b) of a symmetric 13x13 cell x 2 = 1456. The Schur sums, per point:
    v_i HdiF for
    each of D rows, 2 for each of the D(D+1)/2 distinct H_sc entries and
    the D of b_sc, and 6 for the prior and HdiF."""
    return P * F * (1034 + 1456) + P * (D + 2 * (D * (D + 1) // 2 + D) + 6)


def checked(kernels, timings, name, source, replaces, err, kernel_fn,
            plain_fn, nbytes, flops, what, wrapper_fn=None,
            launches_a_call=None):
    """Record a kernel that matched its plain twin: log its error now,
    queue its timing (run after the slice, so the profiler cannot slow the
    slice down). `launches_a_call`, where given, is the number of kernels
    (and no other device op) the profiler must see in a call of
    `kernel_fn`."""
    log(f"[{name.split()[0]}] {what}: matches its plain twin, "
        f"max_abs_err {err[0]:.3e} ({err[1]:.3f} of the tolerance)")
    b_ms, b_by = bound(nbytes, flops)
    kernels.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, max_abs_err=err[0], bound_ms=b_ms,
                        bound_by=b_by, library_ms=None))
    timings.append((kernel_fn, plain_fn, nbytes, flops, wrapper_fn,
                    launches_a_call))


def time_kernels(torch, kernels, timings):
    """Times every checked kernel; returns, per kernel tag that has a whole
    wrapper, (its device ops a call, its host-device copies)."""
    wrappers = {}
    for k, (kernel_fn, plain_fn, nbytes, flops, wrapper_fn,
            launches_a_call) in zip(kernels, timings):
        tag = f"[{k['name'].split()[0]}]"
        q, before, after = queued_ms(torch, kernel_fn)
        prof_ms, wall = time_ms(torch, kernel_fn)
        pms, pwall = time_ms(torch, plain_fn)
        k.update(ms=float(np.median(q)), plain_ms=pms)
        log(f"{tag} device ms a call, {QUEUED} queued launches under one "
            f"pair of events, three times: "
            + ", ".join(f"{x:.5f}" for x in q)
            + f" (clocks sm, mem before {before}; after {after})")
        log(f"{tag} device ms kernel {k['ms']:.5f} (profiler {prof_ms:.5f}) "
            f"plain {pms:.4f}; wall ms of a single call kernel {wall:.4f} "
            f"plain {pwall:.4f}; bound {k['bound_ms']:.5f} ms "
            f"({k['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e6:.2f} "
            f"MFLOP), {100 * k['bound_ms'] / k['ms']:.2f}% of the bound")
        if launches_a_call is not None:
            ev = profiled(torch, kernel_fn)
            log(f"{tag} its launches by kernel name, device ms a call "
                "(launches a call): " + "; ".join(
                    f"{e.key.split('(')[0][:40]} "
                    f"{e.self_device_time_total / 1e3 / REPS:.5f} "
                    f"({e.count / REPS:.0f})" for e in ev))
            if len(ev) != launches_a_call or any(e.count != REPS
                                                 for e in ev):
                raise AssertionError(
                    f"{tag} a call is not {launches_a_call} launch(es): "
                    f"the profiler saw {[(e.key, e.count) for e in ev]} in "
                    f"{REPS} calls")
        if wrapper_fn is not None:
            wms, wwall = time_ms(torch, wrapper_fn)
            n_ops, crossing = device_ops(torch, wrapper_fn)
            log(f"{tag} whole wrapper (PyTorch side included): device ms "
                f"{wms:.4f}, wall ms {wwall:.4f}, {n_ops:.1f} device ops a "
                f"call, host-device copies: {crossing or 'none'}")
            wrappers[tag] = (n_ops, crossing)
    return wrappers


# each kernel's launch counter and the name of the kernel a launch runs
# (K3 runs two: ba_block_kernel, then block_sum_kernel)
def kernel_counters():
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    return (("K1", IMG.pyramid_levels, "pyramid_kernel"),
            ("K2", WIN.template_levels, "template_kernel"),
            ("K3", BP.fused_iteration, "ba_block_kernel"),
            ("K4", BP.act_pass, "act_pass_kernel"))


def chain_replays(fs) -> int:
    """The replays of the keyframe chain's graphs (models/chain_graph.py)
    so far."""
    g = fs.chain_graph
    return 0 if g is None else sum(g.replays[k] for k in g.graphs)


def busy_window(torch, fs, feed, first, n):
    """n frames of the scene from `first` (`feed(i)` hands frame i to the
    same FullSystem) under torch.profiler, the frames in flight completed
    inside the window: (wall ms a frame, device ms a frame, device ops a
    frame, the window's device events, the launches). The profiler slows
    the host, so the busy share dev / wall is a lower bound. The launches
    are (the K1 kernels the profiler saw, the replays of graph (A) in the
    window, {kernel: the K2-K4 kernels seen}, the replays of the keyframe
    chain's graphs); each kernel's launch counter, to which a replay adds
    the launches it captured, must have moved by the kernels of its name
    seen, or this raises."""
    counters = kernel_counters()
    before = [fn.launches for _, fn, _ in counters]
    replays, chains = graph_pyramids(fs), chain_replays(fs)

    def body():
        t0 = time.perf_counter()
        for i in range(first, first + n):
            feed(i)
        fs.finish_pending()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n
    wall, ev = prof_window(torch, body, tries=1)   # body feeds the frames
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    replays = graph_pyramids(fs) - replays
    chains = chain_replays(fs) - chains
    seen = {}
    for (name, fn, kernel), b in zip(counters, before):
        seen[name] = sum(e.count for e in ev if kernel in e.key)
        if seen[name] != fn.launches - b:
            raise AssertionError(
                f"frames {first}-{first + n - 1}: the profiler saw "
                f"{seen[name]} {name} launches ({kernel}), the launch "
                f"counter counted {fn.launches - b} ({replays} replays of "
                f"graph (A), {chains} of the keyframe chain's graphs)")
    return wall, dev_ms, sum(e.count for e in ev) / n, ev, (
        seen.pop("K1"), replays, seen, chains)


def profile_frames(torch, fs, feed, first, n, tag="profile"):
    """Where a frame's time goes: n more frames of the scene through the
    same FullSystem under torch.profiler (`busy_window`). Logs the wall
    and device time per frame, the card's busy share, its launches per
    frame and the device ops that take the most time."""
    n_kf = fs.stats["n_kf"]
    wall, dev_ms, ops, ev, k1 = busy_window(torch, fs, feed, first, n)
    log(f"[{tag}] frames {first}-{first + n - 1} ({fs.stats['n_kf'] - n_kf} "
        f"keyframes), profiler on: wall {wall:.1f} ms/frame, device "
        f"{dev_ms:.2f} ms/frame, card busy {100 * dev_ms / wall:.1f}%, "
        f"{ops:.0f} device ops/frame; K1 kernels the profiler saw {k1[0]} "
        f"(replays of graph (A) {k1[1]}), K2-K4 {k1[2]} (replays of the "
        f"keyframe chain's graphs {k1[3]}), as counted")
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[{tag}] top device ops, ms/frame (count/frame): " + "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.3f} "
        f"({e.count / n:.0f})" for e in top))


def k3_against_plain(BP, a, kw):
    """K3 on the call (a, kw) against its plain twin: every float output,
    the Hessians and the kernel's own cells also Gram-normalized, states,
    masks and has_res exact; and a second launch must repeat every bit."""
    fk = BP.fused_iteration(*a, **kw)
    fp = BP.fused_iteration_plain(*a, **kw)
    prep = BP.k3_prepare(*a, **kw)
    BP.k3_launch(prep)
    cH, cb = BP.fused_cells_plain(*a[:6], pmask=kw.get("pmask"),
                                  use_rz=kw.get("use_rz", False))
    acc = prep["out"]["acc"]
    err = compare(
        "K3", [(fk.H_top, fp.H_top), (fk.b_top, fp.b_top),
               (fk.H_sc, fp.H_sc), (fk.b_sc, fp.b_sc),
               (fk.sc.Hdd, fp.sc.Hdd), (fk.sc.HdiF, fp.sc.HdiF),
               (fk.sc.bd, fp.sc.bd), (fk.sc.vcross, fp.sc.vcross),
               (fk.energy, fp.energy), (fk.energy_raw, fp.energy_raw),
               (acc[..., :12, 12], cb)],
        [(fk.new_state, fp.new_state), (fk.active, fp.active),
         (fk.sc.has_res, fp.sc.has_res)],
        [(fk.H_top, fp.H_top), (fk.H_sc, fp.H_sc),
         (acc[..., :12, :12], cH)])
    again = BP.fused_iteration(*a, **kw)
    same_bits("K3", fk[:4] + tuple(fk.sc) + fk[5:],
              again[:4] + tuple(again.sc) + again[5:])
    return err


def same_bits(name, first, second):
    import torch
    for i, (x, y) in enumerate(zip(first, second)):
        if not torch.equal(x.contiguous().view(torch.uint8),
                           y.contiguous().view(torch.uint8)):
            raise AssertionError(f"{name}: output {i} of a second launch on "
                                 "the same inputs differs in its bits")


def ragged_cases(torch, dev, settings):
    """K3 and K4 against their plain twins where no block is full: the
    shapes of utils/synthetic.py on seeded windows (GN mode and a
    marginalization of every third point), an empty pmask, a window whose
    residuals are all OOB, and activation passes with NaN taps in dead
    frames, clamp off and on."""
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.utils import convert, synthetic
    marg = dict(use_rz=True, shift_prior_to_zero=False,
                prior_fac=settings.idepth_fix_prior_marg_fac)

    def window(P, F, **override):
        fields, dI = synthetic.make_window(P, F, seed=3)
        fields.update(override)
        ba = convert.from_numpy(B.BAState, fields, dev)
        dI = torch.as_tensor(dI, device=dev)
        return (ba, B.make_precalc(ba), dI, settings, dI.shape[2],
                dI.shape[1])

    err = (0.0, 0.0)
    for P, F in synthetic.K3_RAGGED_SHAPES:
        a = window(P, F)
        third = a[0].pt_valid & (torch.arange(P, device=dev) % 3 == 0)
        for kw in ({}, dict(marg, pmask=third)):
            err = worse(err, k3_against_plain(BP, a, kw))
    a = window(512, 5)
    err = worse(err, k3_against_plain(BP, a, dict(
        marg, pmask=torch.zeros(512, dtype=torch.bool, device=dev))))
    a = window(100, 3, res_state=np.full((100, 3), B.RES_OOB, np.int8))
    err = worse(err, k3_against_plain(BP, a, {}))
    if bool(BP.fused_iteration(*a).active.any()):
        raise AssertionError("K3: an all-OOB window has active residuals")
    log(f"[K3] {len(synthetic.K3_RAGGED_SHAPES)} ragged shapes x (GN, marg), "
        f"an empty pmask and an all-OOB window: matches its plain twin, "
        f"max_abs_err {err[0]:.3e} ({err[1]:.3f} of the tolerance), every "
        "second launch bitwise equal")

    err4 = (0.0, 0.0)
    for N, F in synthetic.K4_RAGGED_SHAPES:
        ins = [torch.as_tensor(x, device=dev)
               for x in synthetic.make_act_inputs(N, F, seed=5)]
        for clamp in (False, True):
            err4 = worse(err4, k4_against_plain(BP, ins, dict(
                clamp=clamp, huber_th=settings.huber_th)))
    log(f"[K4] {len(synthetic.K4_RAGGED_SHAPES)} ragged shapes x clamp off "
        f"and on, NaN taps in dead frames: matches its plain twin, "
        f"max_abs_err {err4[0]:.3e} ({err4[1]:.3f} of the tolerance), every "
        "second launch bitwise equal")
    return err, err4


def k4_against_plain(BP, a, kw):
    """K4 against its plain twin: OOB flags exact, the energies (NaN in
    both where a dead frame's taps are NaN) and the live-masked sums within
    the tolerance, the sums finite, and a second launch repeats every
    bit."""
    ok_ = BP.act_pass(*a, **kw)
    op_ = BP.act_pass_plain(*a, **kw)
    err = compare("K4", [(ok_[0], op_[0])] + list(zip(ok_[2:], op_[2:])),
                  [(ok_[1], op_[1])])
    for x in ok_[2:]:
        if not bool(x.isfinite().all()):
            raise AssertionError("K4: a live-masked sum is not finite")
    same_bits("K4", ok_, BP.act_pass(*a, **kw))
    return err


def k1_against_plain(torch, IMG, img, n_levels):
    """K1's whole-call entry on `img`: one launch; every level within the
    tolerance of the plain twin; every bit that of one launch per level
    chained through `down`; and a second launch repeats every bit."""
    before = IMG.pyramid_levels.launches
    lv, ag = IMG.pyramid_levels(img, n_levels)
    if IMG.pyramid_levels.launches - before != 1:
        raise AssertionError("K1: a call is not one launch")
    plv, pag = IMG.pyramid_levels_plain(img, n_levels)
    err = compare("K1", list(zip(lv + ag, plv + pag)), [])
    chained, cur = [], img
    for _ in range(n_levels - 1):
        dI, asg, cur = IMG.pyramid_level(cur)
        chained.append((dI, asg))
    (dI,), (asg,) = IMG.pyramid_levels(cur, 1)   # the last may have odd sides
    chained.append((dI, asg))
    same_bits("K1 against one launch per level", lv + ag,
              tuple(c[0] for c in chained) + tuple(c[1] for c in chained))
    again = IMG.pyramid_levels(img, n_levels)
    same_bits("K1", lv + ag, again[0] + again[1])
    return err


def k2_against_plain(WIN, maps, colors, diags):
    """K2's whole-call entry: one launch; idn and good exactly the plain
    twin's; every bit that of one launch per level; and a second launch
    repeats every bit."""
    before = WIN.template_levels.launches
    out = WIN.template_levels(maps, colors, diags)
    if WIN.template_levels.launches - before != 1:
        raise AssertionError("K2: a call is not one launch")
    plain = WIN.template_levels_plain(maps, colors, diags)
    flat = [x for pair in out for x in pair]
    err = compare("K2", [(k[0], p[0]) for k, p in zip(out, plain)],
                  [(k[1], p[1]) for k, p in zip(out, plain)])
    if err[0] != 0.0:
        raise AssertionError(f"K2: idn is off its plain twin by {err[0]:.3e}")
    per_level = [WIN.template_level(idm, wm, color.contiguous(), diag)
                 for (idm, wm), color, diag in zip(maps, colors, diags)]
    same_bits("K2 against one launch per level", flat,
              [x for pair in per_level for x in pair])
    same_bits("K2", flat, [x for pair in WIN.template_levels(
        maps, colors, diags) for x in pair])
    return err


def capture(torch, calib, settings, imgs, dev, k2_entry="template_levels"):
    """Runs the scene through a FullSystem until the main path has
    marginalized a point (so that K3's use_rz mode is met on the main
    path's own inputs) with recorders on K2 (the entry `k2_entry` of
    models/window.py), its caller build_track_template, K3 and K4. Returns
    (the recorders by kernel, the frames it took)."""
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.ops import ba_p as BP
    recs = dict(k2=Recorder(WIN, k2_entry, 4),
                tmpl=Recorder(WIN, "build_track_template", 1),
                k3=Recorder(BP, "fused_iteration", 1, kind=k3_kind),
                k4=Recorder(BP, "act_pass", 8))
    fs = FullSystem(calib, settings, device=dev)
    # the recorders keep eager calls' inputs: a call captured into the
    # keyframe chain's graph holds the graph's own buffers
    fs.chain_graph = None
    n_pre = 0
    while n_pre < N_FRAMES and "rz" not in recs["k3"].last_of:
        fs.add_active_frame(imgs[n_pre], timestamp=n_pre * 0.05,
                            frame_id=n_pre)
        n_pre += 1
    for r in recs.values():
        r.restore()
    if not fs.initialized or fs.is_lost or fs.init_failed:
        raise AssertionError("the capture run did not initialize")
    log(f"[capture] {n_pre} frames, {fs.stats['n_kf']} keyframes")
    return recs, n_pre


def png_pixels(path):
    """The (H, W, 3) uint8 pixels of an RGB8 PNG whose rows all use filter
    type 0 (what the port's writer, io/png.py, writes), decoded with the
    standard library's zlib alone."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    at, idat, hdr = 8, b"", None
    while at < len(data):
        n = int.from_bytes(data[at:at + 4], "big")
        tag, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        if zlib.crc32(tag + body) != int.from_bytes(
                data[at + 8 + n:at + 12 + n], "big"):
            raise AssertionError(f"{path}: bad CRC in {tag}")
        if tag == b"IHDR":
            hdr = body
        elif tag == b"IDAT":
            idat += body
        at += 12 + n
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    if hdr[8:10] != bytes([8, 2]):
        raise AssertionError(f"{path}: not RGB8")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row is filtered")
    return rows[:, 1:].reshape(h, w, 3)


def snapshot_phase(torch, dev, card, kernels, imgs, mono):
    """Phase [snapshot]: the mono scene's frames 0-23 through a FullSystem
    on the card and save_snapshot; a fresh FullSystem on the card
    load_snapshot and frames 24-47 with every launch counter from 0 and a
    MapViewer and a DebugPlotDumper (mode 0, tracking on, after each
    keyframe) attached; against the mono phase's uninterrupted run. Then
    the same snapshot in the JAX package's layout (its `port.*` entries
    dropped): the template rebuilt on load (one K2 launch), frames 24-47
    within 5e-3. The snapshots and PNGs go to a temporary directory that
    is removed afterwards."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as tmp:
        snapshot_checks(torch, dev, card, kernels, imgs, mono, tmp)


def snapshot_checks(torch, dev, card, kernels, imgs, mono, tmp):
    import os

    from sos_slam_tpu_torch.io.debug_plot import DebugPlotDumper
    from sos_slam_tpu_torch.io.viewer import MapViewer
    from sos_slam_tpu_torch.models import snapshot as SNAP
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils.config import default_settings

    tag = f"[snapshot] ({card})"
    calib, half = mono["calib"], N_FRAMES // 2
    wrappers = (IMG.pyramid_levels, WIN.template_levels, BP.fused_iteration,
                BP.act_pass)

    def feed(fs, frames, after_kf=None):
        for i in frames:
            n_kf = fs.stats["n_kf"]
            fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
            if after_kf is not None and fs.stats["n_kf"] > n_kf:
                after_kf()
        fs.finish_pending()
        torch.cuda.synchronize()

    path = os.path.join(tmp, "state.npz")
    fs = FullSystem(calib, default_settings(), device=dev)
    feed(fs, range(half))
    t0 = time.perf_counter()
    SNAP.save_snapshot(fs, path)
    save_ms = (time.perf_counter() - t0) * 1e3
    with np.load(path) as data:
        raw = sum(data[k].nbytes for k in data.files)
        n_entries = len(data.files)
        jax_layout = {k: data[k] for k in data.files
                      if not k.startswith(SNAP.PORT)}
    size = os.path.getsize(path)
    del fs

    for w_ in wrappers:
        w_.launches = 0
    fs2 = FullSystem(calib, default_settings(), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    SNAP.load_snapshot(fs2, path)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    viewer = MapViewer(out_dir=os.path.join(tmp, "map"), size=480)
    fs2.output_wrappers.append(viewer)
    dumper = DebugPlotDumper(os.path.join(tmp, "debug"), mode=0,
                             tracking=True)
    n_want = []

    def dump():
        n_want.append(2 * int(fs2.ba.frame_valid.sum()))
        dumper.dump(fs2)

    t0 = time.perf_counter()
    feed(fs2, range(half, N_FRAMES), after_kf=dump)
    resumed_s = time.perf_counter() - t0
    counts = [w_.launches for w_ in wrappers]
    traj = fs2.trajectory()
    bitwise = np.array_equal(traj, mono["traj"]) and all(
        torch.equal(v, getattr(fs2.ba, k)) for k, v in mono["ba"].items())
    dev_err = float(np.abs(traj - mono["traj"]).max()) \
        if traj.shape == mono["traj"].shape else float("inf")
    log(f"{tag} mono scene {W}x{H}: frames 0-{half - 1}, save_snapshot "
        f"{save_ms:.1f} ms, {size} bytes compressed ({raw} bytes of "
        f"arrays, {n_entries} entries); load_snapshot into a fresh "
        f"FullSystem {load_ms:.1f} ms; frames {half}-{N_FRAMES - 1} in "
        f"{resumed_s:.2f} s: keyframes {fs2.kf_shell_ids}, the "
        f"uninterrupted run's {mono['kf_ids']}; trajectory max |diff| "
        f"{dev_err:.3e}, bitwise {bitwise}; launches K1-K4 of the resumed "
        f"half {counts}")
    if fs2.is_lost or fs2.kf_shell_ids != mono["kf_ids"]:
        raise AssertionError(f"resumed keyframes {fs2.kf_shell_ids} differ "
                             f"from the uninterrupted {mono['kf_ids']}")
    if not dev_err <= 5e-3:
        raise AssertionError(f"resumed trajectory off by {dev_err}")
    if not bitwise:
        raise AssertionError("the resumed run is not bit for bit the "
                             "uninterrupted one (it is on the CPU: "
                             "tests/test_torch_snapshot.py)")
    for name, c in zip(("K1", "K2", "K3", "K4"), counts):
        if c <= 0:
            raise AssertionError(f"{name} was not launched in the resumed "
                                 "half")
    for k, c in zip(kernels, counts):
        k["launches_snapshot"] = c

    # the PNGs: one map per final keyframe, window + tracking per dump
    last = viewer.render()
    maps = sorted(os.listdir(os.path.join(tmp, "map")))
    debug = os.listdir(os.path.join(tmp, "debug"))
    n_map = sum(1 for f in maps if f.startswith("map_"))
    same_png = np.array_equal(png_pixels(last), viewer.render_array())
    log(f"{tag} MapViewer: {len(viewer.keyframes)} final keyframes, {n_map} "
        f"map PNGs; DebugPlotDumper: {len(n_want)} dumps, {len(debug)} "
        f"PNGs (want {sum(n_want)}); the last map PNG decoded with zlib "
        f"equals render_array(): {same_png}")
    if n_map != viewer.n_rendered or n_map < 2 or not viewer.keyframes:
        raise AssertionError(f"{n_map} map PNGs for {viewer.n_rendered} "
                             "renders")
    if len(debug) != sum(n_want) or not n_want:
        raise AssertionError(f"{len(debug)} debug PNGs, {sum(n_want)} "
                             "wanted")
    if not same_png:
        raise AssertionError("the map PNG does not decode to its array")
    del fs2, viewer, dumper

    # the JAX package's layout: the template rebuilt from the window
    jpath = os.path.join(tmp, "jax_layout.npz")
    np.savez_compressed(jpath, **jax_layout)
    fs3 = FullSystem(calib, default_settings(), device=dev)
    before = WIN.template_levels.launches
    SNAP.load_snapshot(fs3, jpath)
    rebuilt = WIN.template_levels.launches - before
    feed(fs3, range(half, N_FRAMES))
    traj3 = fs3.trajectory()
    err3 = float(np.abs(traj3 - mono["traj"]).max()) \
        if traj3.shape == mono["traj"].shape else float("inf")
    log(f"{tag} the same snapshot in the JAX package's layout: template "
        f"rebuilt on load in {rebuilt} K2 launch(es); keyframes "
        f"{fs3.kf_shell_ids}; trajectory max |diff| {err3:.3e} (5e-3 "
        "allowed)")
    if rebuilt != 1 or fs3.is_lost or not err3 <= 5e-3:
        raise AssertionError(f"JAX-layout resume: {rebuilt} K2 launches, "
                             f"lost {fs3.is_lost}, off by {err3}")
    del fs3


def median(v):
    return float(np.median(v)) if len(v) else float("nan")


def split_by_keyframe(frame_ms, kf_ids, first):
    """Frame times from `first` on, split into the frames that dispatched
    a keyframe chain (a frame's id is its index) and the others."""
    kf = set(kf_ids)
    steady = range(first, len(frame_ms))
    return ([frame_ms[i] for i in steady if i in kf],
            [frame_ms[i] for i in steady if i not in kf])


def ate_of(fs, poses):
    traj = fs.trajectory()
    ids = traj[:, 0].astype(int)
    est, gt = traj[:, 1:4], poses[ids, :3, 3]
    en, gn = np.linalg.norm(est, axis=1), np.linalg.norm(gt, axis=1)
    nz = gn > 1e-6
    scale = np.median(en[nz] / gn[nz]) if nz.any() else 1.0
    ate = float(np.sqrt(np.mean(
        np.linalg.norm(est / max(scale, 1e-9) - gt, axis=1) ** 2)))
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return ate, path


def live_fold64(torch, Hs, bs, sl, in_marg, cut):
    """The reference of energy.fold_vio_block: the Schur fold in float64
    over the live subspace of the scaled 29x29 block from an
    eigendecomposition (eigenvalues above `cut` times the largest)."""
    H, b = Hs.double(), bs.double()
    blk = H[sl:sl + 29, sl:sl + 29]
    w, V = torch.linalg.eigh(0.5 * (blk + blk.T))
    live = w > cut * w.abs().max()
    blk_inv = (V[:, live] / w[live]) @ V[:, live].T
    keep = (~in_marg).double()
    Hxm = H[:, sl:sl + 29] * keep[:, None]
    bli = Hxm @ blk_inv
    H_new = (H - bli @ Hxm.T) * keep[:, None] * keep[None, :]
    b_new = (b - bli @ b[sl:sl + 29]) * keep
    return H_new.float(), b_new.float()


class FoldProbe:
    """Stands in for energy.fold_vio_block and models/imu.solve_vio. At
    every VIO frame marginalization it records the block's exactly-zero
    rows, the smallest and largest eigenvalue of the scaled 29x29 block
    (float64, the zero rows left out), and the norm of the folded prior's
    scale row (scaled form) under the port's fold and under
    `live_fold64`; the run goes on with the fold `use` names ("port" or
    "f64"). With `f32=True` the port's fold is the f32 inverse of the
    whole block with its exactly-zero rows patched (the fold before the
    live-subspace one). `plant` (a share of the block's largest
    diagonal) replaces each exactly-zero row, before either fold, by a
    rank-one term with that diagonal and couplings of a tenth of the
    others' scale. At every VIO GN step it records the frame (`frame`,
    which the caller sets), the scale the step starts from and the
    scale's GN step."""

    def __init__(self, torch, E, IM, use="port", plant=0.0, f32=False):
        self.torch, self.E, self.IM = torch, E, IM
        self.use, self.plant, self.f32 = use, plant, f32
        self.fold_orig, self.solve_orig = E.fold_vio_block, IM.solve_vio
        E.fold_vio_block, IM.solve_vio = self.fold, self.solve
        self.frame = -1
        self.margs, self.steps = [], []

    def restore(self):
        self.E.fold_vio_block = self.fold_orig
        self.IM.solve_vio = self.solve_orig

    def f32_fold(self, Hs, bs, sl, in_marg):
        """The fold before the live-subspace one: the f32 inverse of the
        whole block, a 1 on the diagonal of each exactly-zero row."""
        torch = self.torch
        Hmm = Hs[sl:sl + 29, sl:sl + 29]
        Hmm = 0.5 * (Hmm + Hmm.T)
        zero = torch.diag((Hs[sl:sl + 29] == 0).all(1))
        Hmm_inv = torch.linalg.inv(torch.where(zero, torch.ones_like(Hmm),
                                               Hmm))
        Hmm_inv = 0.5 * (Hmm_inv + Hmm_inv.T)
        keep = (~in_marg).float()
        Hxm = Hs[:, sl:sl + 29] * keep[:, None]
        bli = Hxm @ Hmm_inv
        return ((Hs - bli @ Hxm.T) * keep[:, None] * keep[None, :],
                (bs - bli @ bs[sl:sl + 29]) * keep)

    def fold(self, Hs, bs, sl, in_marg, jax_form=False):
        torch = self.torch
        zero = (Hs[sl:sl + 29] == 0).all(1)
        if self.plant and bool(zero.any()):
            big = float(torch.diagonal(Hs)[sl:sl + 29].max())
            g = torch.Generator(device="cpu").manual_seed(len(self.margs))
            cpl = torch.randn(Hs.shape[0], generator=g).to(Hs.device)
            cpl = cpl * torch.sqrt(torch.diagonal(Hs).abs()) * 0.1
            for i in torch.nonzero(zero)[:, 0].tolist():
                v = cpl.clone()
                v[sl + i] = (self.plant * big) ** 0.5
                Hs = Hs + v[:, None] * v[None, :]
        ms = {}
        for name, fn in (
                ("port", lambda: self.f32_fold(Hs, bs, sl, in_marg)
                 if self.f32 else self.fold_orig(Hs, bs, sl, in_marg,
                                                 jax_form)),
                ("f64", lambda: live_fold64(torch, Hs, bs, sl, in_marg,
                                            self.E.LIVE_CUT))):
            # the second of two calls, the card synchronized around it
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                ms[name] = (time.perf_counter() - t0) * 1e3
            if name == "port":
                port = out
            else:
                ref = out
        blk = Hs[sl:sl + 29, sl:sl + 29].double()
        live_rows = ~(Hs[sl:sl + 29] == 0).all(1)
        w = torch.linalg.eigvalsh(0.5 * (blk + blk.T)[live_rows][:, live_rows])
        cp = self.IM.CPARS
        self.margs.append(dict(
            frame=self.frame, slot=(sl - cp - 1) // 29,
            zero_rows=torch.nonzero(~live_rows)[:, 0].tolist(),
            eig_min=float(w.min()), eig_max=float(w.max()),
            n_cut=int((w <= self.E.LIVE_CUT * w.abs().max()).sum()
                      + (~live_rows).sum()),
            scale_row=float(torch.linalg.norm(port[0][cp])),
            scale_row_ref=float(torch.linalg.norm(ref[0][cp])),
            finite=bool(torch.isfinite(port[0]).all()),
            ms=ms["port"], ms_f64=ms["f64"],
            dH=float((port[0] - ref[0]).abs().max()
                     / ref[0].abs().max().clamp(min=1e-30))))
        return port if self.use == "port" else ref

    def solve(self, ba, imu, *a, **kw):
        x8, x_scale, x_imu = self.solve_orig(ba, imu, *a, **kw)
        self.steps.append((self.frame, float(imu.scale) * self.IM.SCALE_SCALE,
                           float(x_scale) * self.IM.SCALE_SCALE))
        return x8, x_scale, x_imu

    def lines(self, tag, from_frame):
        """One line a VIO frame marginalization, then one a keyframe from
        `from_frame` on."""
        out = [f"{tag} VIO frame marginalization at frame {m['frame']} "
               f"(slot {m['slot']}): zero rows {m['zero_rows']}, scaled "
               f"block eigenvalues {m['eig_min']:.3e} .. {m['eig_max']:.3e} "
               f"({m['n_cut']} of 29 under the live cut), scale row |port| "
               f"{m['scale_row']:.6e} |f64 live| {m['scale_row_ref']:.6e}, "
               f"max |port - f64 live| / max |f64 live| {m['dH']:.3e}, port "
               f"finite {m['finite']}; wall ms of the port's fold "
               f"{m['ms']:.3f}, of the float64 eigh fold {m['ms_f64']:.3f}"
               for m in self.margs]
        by = collections.defaultdict(list)
        for f, sc, dx in self.steps:
            if f >= from_frame:
                by[f].append((sc, dx))
        for f, st in sorted(by.items()):
            out.append(f"{tag} keyframe at frame {f}: scale {st[0][0]:.6f} "
                       f"at its first VIO GN step, GN steps of the scale "
                       + ", ".join(f"{dx:+.3e}" for _, dx in st))
        return out


def flagship(torch, dev, card, kernels):
    """Phase 5: the flagship scene (stereo + spline VIO, bench.py's
    _bench_full_config) through the port at 640x480 with every launch
    counter from 0; the gates, the numbers, and K1 (a right image), K3 (a
    VIO GN step and a VIO point marginalization) and K4 (an activation
    pass) of this run held against their plain twins. Adds each kernel's
    launches on this path to `kernels` (`launches_flagship`) and widens
    its max_abs_err by what these checks found."""
    from sos_slam_tpu_torch.models import energy as E
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.models import imu as IM
    from sos_slam_tpu_torch.models import initializer as INIT
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils import synthetic
    from sos_slam_tpu_torch.utils.config import default_settings

    def prior_in(args, kw):
        """Whether the VIO prior a frame marginalization starts from is
        finite (the JAX package's fold of a slot without a valid spline
        leaves it NaN; the port's does not)."""
        return "finite" if bool(torch.isfinite(args[1].HM).all()) else "NaN"

    calib = synthetic.default_calib(W, H)
    settings = default_settings(weight_imu_dso=6.0, scale_opt_thres=12.0,
                                min_g_imu=10)
    scene = synthetic.stereo_vio_scene(
        calib, FLAG_FRAMES + FLAG_PROF_FRAMES, FLAG_DT, synthetic.sine_pose,
        synthetic.sine_acc, device=dev)
    left, right, imu = scene["left"], scene["right"], scene["imu"]
    stereo = FSM.StereoCalib(T_lr=scene["T_lr"], calib_right=calib)

    def feed(fs, i):
        fs.add_active_frame(left[i], timestamp=i * FLAG_DT, frame_id=i,
                            image_right=right[i], imu_samples=imu[i])

    wrappers = (IMG.pyramid_levels, WIN.template_levels, BP.fused_iteration,
                BP.act_pass)
    recs = [Recorder(FSM, "build_pyramid", 1, kind=pyramid_side),
            Recorder(INIT, "build_pyramid", 1),
            Recorder(WIN, "build_track_template", 1),
            Recorder(BP, "fused_iteration", 1, kind=k3_caller),
            Recorder(BP, "act_pass", 1),
            Recorder(E, "marginalize_frame_vio", 1, kind=prior_in)]
    for w_ in wrappers:
        w_.launches = 0
    fs = FSM.FullSystem(calib, settings, stereo=stereo, device=dev)
    kf_scale = {}       # the stereo scale after each fused keyframe
    finish_kf = fs._finish_kf

    def scale_of(rec, got, classic):
        finish_kf(rec, got, classic)
        kf_scale[rec["shell"].id] = fs.current_scale

    fs._finish_kf = scale_of
    frame_ms, t_steady = [], None
    for i in range(FLAG_FRAMES):
        if i == FLAG_WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        t0 = time.perf_counter()
        feed(fs, i)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    torch.cuda.synchronize()
    kf_ms, nonkf = split_by_keyframe(frame_ms, fs.kf_shell_ids, FLAG_WARMUP)
    steady_s = time.perf_counter() - t_steady if t_steady else float("nan")
    counts = [w_.launches for w_ in wrappers]
    for r in recs:
        r.restore()
    pyr_l, pyr_i, tmpl, k3, k4, mfv = recs

    tag = f"[flagship] ({card})"
    if not fs.initialized or fs.is_lost or fs.init_failed:
        raise AssertionError(f"flagship failed: initialized={fs.initialized}"
                             f" lost={fs.is_lost} "
                             f"init_failed={fs.init_failed}")
    ate, path = synthetic.metric_ate(fs.trajectory(scaled=True),
                                     scene["poses"])
    n_kf = len(fs.kf_shell_ids)
    fps = (FLAG_FRAMES - FLAG_WARMUP) / steady_s
    log(f"{tag} {W}x{H} {FLAG_FRAMES} frames, stereo + VIO on {card}: n_kf "
        f"{n_kf}, metric ATE of the scaled trajectory (no alignment) "
        f"{ate:.4f} m over {path:.3f} m, stereo scale {fs.current_scale:.4f}"
        f", IMU scale {float(fs.imu.scale) * IM.SCALE_SCALE:.4f}, steady fps "
        f"{fps:.2f} (frames {FLAG_WARMUP}-{FLAG_FRAMES - 1}, {steady_s:.3f} "
        f"s), frames dispatching a keyframe chain: median "
        f"{median(kf_ms):.1f} ms ({len(kf_ms)} in the window), the other "
        f"frames: median {median(nonkf):.1f} ms, first frame "
        f"{frame_ms[0]:.0f} ms")
    log(f"{tag} reference: {JAX_FLAGSHIP}")
    log(f"{tag} VIO frame marginalizations by the prior they started from: "
        + (", ".join(f"{k} {v}" for k, v in sorted(mfv.n_of.items()))
           or "none")
        + "; the VIO prior after the run is "
        + ("finite" if bool(torch.isfinite(fs.imu.HM).all()) else "NaN")
        + f"; {n_kf} keyframes, scaled ATE {ate:.4f} m")
    rep = fs.telemetry.report()["timers_ms"]
    log(f"{tag} host stage timers: " + ", ".join(
        f"{k} n={v['n']} median {v['median']:.1f} ms"
        for k, v in sorted(rep.items())))
    if not bool(torch.isfinite(fs.imu.HM).all() & torch.isfinite(
            fs.imu.bM).all()) or mfv.n_of["NaN"]:
        raise AssertionError(
            "flagship: the VIO prior is not finite after the run "
            f"(frame marginalizations by prior: {dict(mfv.n_of)})")
    if not (fs.imu_initialized and fs.scale_trapped):
        raise AssertionError(f"flagship: imu_initialized="
                             f"{fs.imu_initialized} scale_trapped="
                             f"{fs.scale_trapped}")
    if fs._last_bg is None:
        raise AssertionError("flagship: the fused VIO chain never ran")
    if not ate <= 0.15 * path + 0.03:
        raise AssertionError(f"flagship ATE gate: {ate} > 0.15 * {path} "
                             "+ 0.03")
    late = sorted(f for f in kf_scale if f >= FLAG_SCALE_FROM)
    drift = max((abs(kf_scale[f] / kf_scale[late[0]] - 1.0) for f in late),
                default=float("inf"))
    log(f"{tag} the stereo scale after each keyframe from frame "
        f"{FLAG_SCALE_FROM} on: " + ", ".join(
            f"{f} {kf_scale[f]:.6f}" for f in late)
        + f"; the most it moves from the first: {100 * drift:.3f}% (1% "
        "allowed)")
    if not drift <= 0.01:
        raise AssertionError(f"flagship: the stereo scale moves {drift} "
                             f"from frame {FLAG_SCALE_FROM}'s: {kf_scale}")
    for name, c in zip(("K1", "K2", "K3", "K4"), counts):
        if c <= 0:
            raise AssertionError(f"{name} was not launched on the flagship "
                                 "path")
    n_right = pyr_l.n_of["right"]
    n_pyr = pyr_l.n_calls + pyr_i.n_calls + graph_pyramids(fs)
    if counts[0] != n_pyr or counts[1] != tmpl.n_calls:
        raise AssertionError(
            f"flagship: K1 launched {counts[0]} times for {n_pyr} pyramids "
            f"({n_right} right), K2 {counts[1]} times for {tmpl.n_calls} "
            "templates: a call is not one launch")
    log(f"{tag} {n_pyr} pyramids built ({n_pyr - n_right} left, {n_right} "
        f"right) in {counts[0]} K1 launches, {tmpl.n_calls} templates in "
        f"{counts[1]} K2 launches; K3 {counts[2]} launches "
        + ", ".join(f"{k} {v}" for k, v in sorted(k3.n_of.items()))
        + f"; K4 {counts[3]} launches")

    # the kernels on this run's own inputs
    for need in ("gn_step_vio", "marginalize_points_vio"):
        if need not in k3.last_of:
            raise AssertionError(f"flagship: no K3 call from {need}")
    err3 = (0.0, 0.0)
    for need in ("gn_step_vio", "marginalize_points_vio"):
        a, kw = k3.last_of[need]
        err3 = worse(err3, k3_against_plain(BP, a, kw))
    a4, kw4 = k4.calls[-1]
    err4 = (0.0, 0.0)
    for clamp in (False, True):
        err4 = worse(err4, k4_against_plain(BP, a4, dict(kw4, clamp=clamp)))
    err1 = k1_against_plain(torch, IMG, right[FLAG_FRAMES - 1].contiguous(),
                            calib.levels)
    a, kw = k3.last_of["marginalize_points_vio"]
    log(f"{tag} K3 on a VIO GN step and a VIO point marginalization "
        f"({int(kw['pmask'].sum())} points): max_abs_err {err3[0]:.3e} "
        f"({err3[1]:.3f} of the tolerance); K4 on an activation pass: "
        f"{err4[0]:.3e} ({err4[1]:.3f}); K1 on a right image: {err1[0]:.3e} "
        f"({err1[1]:.3f}); each matches its plain twin, second launches "
        "bitwise equal")
    for k, c, e in zip(kernels, counts, (err1, (0.0, 0.0), err3, err4)):
        k["launches_flagship"] = c
        k["max_abs_err"] = max(k["max_abs_err"], e[0])
    del recs, pyr_l, pyr_i, tmpl, k4, mfv, a, kw, a4, kw4
    phase_done("flagship run and checks")

    # the VIO fold at every frame marginalization, the port's against the
    # float64 fold from an eigendecomposition, then the run on each
    for use in ("port", "f64"):
        probe = FoldProbe(torch, E, IM, use=use)
        fp = FSM.FullSystem(calib, settings, stereo=stereo, device=dev)
        for i in range(FLAG_FRAMES):
            probe.frame = i
            feed(fp, i)
        fp.finish_pending()
        probe.restore()
        ptag = f"{tag} [{use} fold]"
        for line in probe.lines(ptag, FLAG_SCALE_FROM):
            log(line)
        ate_p, _ = synthetic.metric_ate(fp.trajectory(scaled=True),
                                        scene["poses"])
        log(f"{ptag} keyframes {fp.kf_shell_ids}, stereo scale "
            f"{fp.current_scale:.6f}, scaled ATE {ate_p:.5f} m")
        worst = max((m["dH"] for m in probe.margs), default=float("inf"))
        if use == "port" and not (probe.margs and worst <= 1e-4 and all(
                m["finite"] for m in probe.margs)):
            raise AssertionError(f"flagship: the port's VIO fold is off its "
                                 f"float64 reference by {worst}")
    del probe, fp
    phase_done("flagship VIO folds")

    # the JAX package's fold (a NaN prior from the first VIO frame
    # marginalization on) against the port's over the same frames: what
    # the working VIO BA costs a keyframe chain, stage by stage (each stage
    # timed with the card synchronized around it)
    chains = {}
    for form in ("port", "jax"):
        k3j = Recorder(BP, "fused_iteration", 1, kind=k3_caller)
        fj = FSM.FullSystem(calib, settings, stereo=stereo, device=dev,
                            jax_form=form == "jax")
        stages = [StageTimer(torch, *o) for o in (
            (E, "optimize_vio"), (WIN, "build_track_template"),
            (E, "marginalize_points_vio"), (E, "marginalize_frame_vio"),
            (E, "fold_vio_block"), (fj, "_activate"), (fj, "_scale_solve"),
            (fj, "_select_insert"))]
        for i in range(FLAG_FRAMES):
            feed(fj, i)
        fj.finish_pending()
        for st_ in stages:
            st_.restore()
        k3j.restore()
        ate_j, _ = synthetic.metric_ate(fj.trajectory(scaled=True),
                                        scene["poses"])
        kc = fj.telemetry.timers["kf_chain"]
        chains[form] = (sum(kc), len(kc))
        log(f"{tag} [{form} fold, stages timed] keyframes "
            f"{fj.kf_shell_ids}, scaled ATE {ate_j:.4f} m, scale "
            f"{fj.current_scale:.4f}, VIO prior after the run "
            + ("finite" if bool(torch.isfinite(fj.imu.HM).all()) else "NaN")
            + f", {k3j.n_of['gn_step_vio']} VIO GN steps; {len(kc)} fused "
            f"keyframe chains: {sum(kc):.1f} ms in all (median "
            f"{median(kc):.1f}); of which, in all: " + ", ".join(
                f"{st_.name} {sum(st_.ms):.1f} ms (n={len(st_.ms)})"
                for st_ in stages)
            + " (the classic bootstrap's calls included; the fold within "
            "marginalize_frame_vio)")
        del fj, k3j, stages
    log(f"{tag} fused keyframe chains, the port's fold against the JAX "
        f"package's: {chains['port'][0] - chains['jax'][0]:.1f} ms more in "
        f"all over {chains['port'][1]} and {chains['jax'][1]} chains")
    del k3
    kf_ids = list(fs.kf_shell_ids)
    profile_frames(torch, fs, lambda i: feed(fs, i), FLAG_FRAMES,
                   FLAG_PROF_FRAMES, tag="flagship profile")
    return dict(kf_ids=kf_ids, scene=scene, calib=calib, settings=settings)


def pipeline_phase(torch, dev, card, mono, flag):
    """Phase [pipeline]: the mono scene's 48 frames at depth 0 (the
    synchronous driver) and depth 3, in turns, PIPE_PAIRS times each, every
    run bit for bit the pipelined mono slice (keyframes, trajectory, the
    whole window); each prints its steady fps (frames WARMUP to
    PIPE_PROF_FROM - 1) and the card's busy share under the profiler over
    the rest. Then the flagship scene's first PIPE_FLAG_FRAMES frames (the
    IMU initialization and two VIO frame marginalizations) at depth 0 and
    3, each drained, bit for bit on the trajectories, the window and the
    VIO prior. Gated on at least two frames seen in flight."""
    from sos_slam_tpu_torch.models import energy as E
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.utils.config import default_settings

    tag = f"[pipeline] ({card})"
    imgs, most = mono["imgs"], mono["in_flight"]
    fps = {0: [], 3: []}
    busy = {0: [], 3: []}
    redo = []           # each depth-3 run's rung re-dispatches: (n, ms)
    window = {0: [], 3: []}     # ms of the fps window
    stages = {0: [], 3: []}     # host stage timers summed over the window
    names = ("frame", "step", "kf_chain", "complete", "redispatch")
    for p in range(PIPE_PAIRS):
        # the order alternates (0, 3), (3, 0), ...: neither depth always
        # runs second
        for depth in ((0, 3), (3, 0))[p % 2]:
            gc.collect()
            fs = FSM.FullSystem(mono["calib"], default_settings(), device=dev)
            fs.pipeline, fs.pipeline_depth = depth > 0, depth

            def feed(i, fs=fs):
                fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)

            for i in range(WARMUP):
                feed(i)
            torch.cuda.synchronize()
            timers = fs.telemetry.timers
            at = {k: len(timers[k]) for k in names}
            t0 = time.perf_counter()
            for i in range(WARMUP, PIPE_PROF_FROM):
                feed(i)
                most = max(most, len(fs._pending_fused))
            torch.cuda.synchronize()
            window[depth].append((time.perf_counter() - t0) * 1e3)
            stages[depth].append({k: (len(timers[k]) - at[k],
                                      sum(timers[k][at[k]:]))
                                  for k in names})
            fps[depth].append((PIPE_PROF_FROM - WARMUP) * 1e3
                              / window[depth][-1])
            rd = fs.telemetry.timers.get("redispatch", [])
            if depth:
                redo.append((len(rd), sum(rd)))
            wall, dev_ms, _, _, _ = busy_window(
                torch, fs, feed, PIPE_PROF_FROM, N_FRAMES - PIPE_PROF_FROM)
            busy[depth].append(dev_ms / wall)
            same = (fs.kf_shell_ids == mono["kf_ids"]
                    and np.array_equal(fs.trajectory(), mono["traj"])
                    and all(torch.equal(v, getattr(fs.ba, k))
                            for k, v in mono["ba"].items()))
            log(f"{tag} mono {W}x{H} depth {depth}: steady fps "
                f"{fps[depth][-1]:.2f} (frames {WARMUP}-"
                f"{PIPE_PROF_FROM - 1}), frames {PIPE_PROF_FROM}-"
                f"{N_FRAMES - 1} under the profiler: wall {wall:.1f} "
                f"ms/frame, device {dev_ms:.2f} ms/frame, card busy "
                f"{100 * busy[depth][-1]:.1f}%; host stage timers over "
                f"the fps window: " + ", ".join(
                    f"{k} n={n} {ms:.1f} ms"
                    for k, (n, ms) in stages[depth][-1].items())
                + "; frames dispatched again "
                f"after a rung change: {len(rd)} in {sum(rd):.1f} ms (the "
                f"whole run); bit for bit the pipelined mono slice: {same}")
            if not same:
                raise AssertionError(f"mono at depth {depth} is not bit for "
                                     "bit the pipelined mono slice")
            del fs, feed
    log(f"{tag} mono, {PIPE_PAIRS} pairs in turns: steady fps depth 0 "
        + ", ".join(f"{v:.2f}" for v in fps[0]) + "; depth 3 "
        + ", ".join(f"{v:.2f}" for v in fps[3]) + "; busy depth 0 "
        + ", ".join(f"{100 * v:.1f}%" for v in busy[0]) + "; depth 3 "
        + ", ".join(f"{100 * v:.1f}%" for v in busy[3])
        + f"; depth 3 / depth 0 fps, pair by pair: "
        + ", ".join(f"{b / a:.3f}" for a, b in zip(fps[0], fps[3]))
        + "; depth 3 - depth 0 ms of the fps window, pair by pair: "
        + ", ".join(f"{b - a:+.1f}" for a, b in zip(window[0], window[3]))
        + "; the depth-3 runs' rung re-dispatches (whole run): "
        + ", ".join(f"{n} frames {ms:.1f} ms" for n, ms in redo))
    phase_done("[pipeline] mono pairs")

    scene, calib = flag["scene"], flag["calib"]
    stereo = FSM.StereoCalib(T_lr=scene["T_lr"], calib_right=calib)
    runs = {}
    for depth in (0, 3):
        margs = Recorder(E, "marginalize_frame_vio", 1)
        fs = FSM.FullSystem(calib, flag["settings"], stereo=stereo,
                            device=dev)
        fs.pipeline, fs.pipeline_depth = depth > 0, depth
        for i in range(PIPE_FLAG_FRAMES):
            fs.add_active_frame(scene["left"][i], timestamp=i * FLAG_DT,
                                frame_id=i, image_right=scene["right"][i],
                                imu_samples=scene["imu"][i])
            most = max(most, len(fs._pending_fused))
        fs.finish_pending()
        margs.restore()
        runs[depth] = fs
        if not fs.imu_initialized or margs.n_calls < 2 or fs.is_lost:
            raise AssertionError(f"flagship at depth {depth}: IMU "
                                 f"initialized {fs.imu_initialized}, "
                                 f"{margs.n_calls} VIO frame "
                                 "marginalizations")
    a, b = runs[0], runs[3]
    same = (a.kf_shell_ids == b.kf_shell_ids
            and np.array_equal(a.trajectory(), b.trajectory())
            and np.array_equal(a.trajectory(scaled=True),
                               b.trajectory(scaled=True))
            and torch.equal(a.ba.state, b.ba.state)
            and torch.equal(a.ba.pt_valid, b.ba.pt_valid)
            and torch.equal(a.imu.HM, b.imu.HM)
            and torch.equal(a.imu.bM, b.imu.bM))
    log(f"{tag} flagship frames 0-{PIPE_FLAG_FRAMES - 1} at depth 0 and 3, "
        f"each drained: keyframes {a.kf_shell_ids}, bit for bit (both "
        f"trajectories, ba.state, pt_valid, imu.HM, imu.bM): {same}; the "
        f"most frames in flight seen in this run's pipelined phases: {most}")
    if not same:
        raise AssertionError("the pipelined flagship run is not bit for bit "
                             "the synchronous one")
    if most < 2:
        raise AssertionError(f"at most {most} frames were in flight")


def se3(lie, torch, xi):
    """exp of a float32 twist, as float64 numpy (the scenes' convention)."""
    return lie.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy() \
        .astype(np.float64)


def pillar_scene(lie, torch):
    """tests/test_loop_closure_e2e.py's scene: 30 pillars and ground in a
    60 m square, a closed 16-gon continued three segments, 20 keyframes
    with odometry drift; each keyframe's points seen from the TRUE pose
    as pinhole [u, v, idepth] rows. Returns (gt, odo, [pts_uvdi])."""
    rng = np.random.RandomState(0)
    env = []
    for _ in range(30):
        cx, cz = rng.uniform(-25, 25, 2)
        h = rng.uniform(4, 15)
        for _ in range(30):
            env.append([cx + rng.randn() * 0.4, -rng.uniform(0, h),
                        cz + rng.randn() * 0.4])
    while len(env) < 1500:
        env.append([rng.uniform(-28, 28), 0.0, rng.uniform(-28, 28)])
    env = np.asarray(env)
    seg = se3(lie, torch, [2.0, 0.0, 0.0, 0.0, 2 * np.pi / 16, 0.0])
    drift = se3(lie, torch, [0.06, 0.03, -0.04, 0.004, 0.006, 0.0])
    gt, odo = [np.eye(4)], [np.eye(4)]
    for i in range(1, LOOP_KFS):
        gt.append(gt[-1] @ seg)
        odo.append(odo[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ drift)
    rng = np.random.RandomState(42)
    fx, fy, cx, cy = PILLAR_INTR[0]
    recs = []
    for T_wc in gt:
        T_cw = np.linalg.inv(T_wc)
        pc = (T_cw[:3, :3] @ env.T).T + T_cw[:3, 3]
        pc = pc[np.linalg.norm(pc, axis=1) < LOOP_RANGE]
        pc = pc[rng.choice(len(pc), size=min(1000, len(pc)), replace=False)]
        pc = pc[pc[:, 2] > 0.5]
        recs.append(np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                              pc[:, 1] / pc[:, 2] * fy + cy,
                              1.0 / pc[:, 2]], -1))
    return np.stack(gt), np.stack(odo), recs


def pose_graph_scene(lie, torch):
    """tests/test_loop.py's 1000-keyframe graph: a drifted chain, four
    loop edges, padded to N=1024, Ec=1024, El=16, the newest vertex fixed.
    Returns (gt, odo, pairs, the 13 inputs as numpy)."""
    n, N = 1000, 1024
    rng = np.random.RandomState(0)
    gt = [np.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ se3(lie, torch, np.array(
            [1.0, 0, 0, 0, 2 * np.pi / 360, 0]) + rng.randn(6) * 0.01))
    drift = se3(lie, torch, [0.01, 0.004, -0.006, 0.0008, 0.0012, 0.0])
    odo = [np.eye(4)]
    for i in range(1, n):
        odo.append(odo[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ drift)
    pairs = [(5, 360), (200, 560), (400, 760), (30, 930)]

    def pack(edges, E):
        ef, et = np.zeros(E, np.int32), np.zeros(E, np.int32)
        em = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
        ei = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
        ev = np.zeros(E, bool)
        for i, (a, b, m, info) in enumerate(edges):
            ef[i], et[i], em[i], ei[i], ev[i] = a, b, m, info, True
        return ef, et, em, ei, ev

    chain = [(i, i + 1, np.linalg.inv(gt[i]) @ gt[i + 1] @ drift, np.eye(6))
             for i in range(n - 1)]
    loops = [(a, b, np.linalg.inv(gt[a]) @ gt[b], np.eye(6) * 100.0)
             for a, b in pairs]
    T = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    T[:n] = np.stack(odo)
    v_valid = np.arange(N) < n
    fixed = ~v_valid
    fixed[n - 1] = True
    return (np.stack(gt), np.stack(odo), pairs,
            (T, v_valid, fixed, *pack(chain, 1024), *pack(loops, 16)))


def loop_error(lie, T, gt, a, b):
    rel = np.linalg.inv(gt[a]) @ gt[b]
    return float(np.linalg.norm(lie.np_se3_log(
        np.linalg.inv(rel) @ np.linalg.inv(T[a]) @ T[b])))


def loop_phase(torch, dev, card, kernels, flag):
    """Phase [loop]: (a) the flagship scene through SlamNode with loop
    closure on, every launch counter from 0; (b) LoopHandler alone on the
    pillar scene, synchronously then asynchronously; (c) estimate_direct
    on a keyframe record of (a), on the card and on the CPU; (d)
    optimize_pose_graph at 1000 keyframes, first and warm call."""
    import tempfile

    from sos_slam_tpu_torch.io.node import SlamNode
    from sos_slam_tpu_torch.loop import handler as LH
    from sos_slam_tpu_torch.loop import pose_estimator as PE
    from sos_slam_tpu_torch.loop import pose_graph as PG
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.models.full_system import FrameShell
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils import evaluate as EV
    from sos_slam_tpu_torch.utils import lie, synthetic
    from sos_slam_tpu_torch.utils.config import default_settings

    tag = f"[loop] ({card})"
    scene, calib = flag["scene"], flag["calib"]
    # (a) ---- the flagship scene through SlamNode, loop closure on ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    cam = f"{tmp}/camera.txt"
    fx, fy, cx, cy = calib.intrinsics(0)
    with open(cam, "w") as f:
        f.write(f"Pinhole {fx} {fy} {cx} {cy} 0\n{W} {H}\nnone\n{W} {H}\n")
    settings = default_settings(weight_imu_dso=6.0, scale_opt_thres=12.0,
                                min_g_imu=10, loop_lidar_range=LOOP_LIDAR)
    reader = [dict(image=scene["left"][i], t=i * FLAG_DT,
                   image_right=scene["right"][i], imu=scene["imu"][i])
              for i in range(FLAG_FRAMES)]
    wrappers = (IMG.pyramid_levels, WIN.template_levels, BP.fused_iteration,
                BP.act_pass)
    for w_ in wrappers:
        w_.launches = 0
    node = SlamNode(settings, cam, calib1=cam, T_stereo=scene["T_lr"],
                    device=dev, async_loop=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_run = node.run(reader)
    torch.cuda.synchronize()
    node_s = time.perf_counter() - t0
    counts = [w_.launches for w_ in wrappers]
    fs, loop = node.fs, node.loop
    poses_txt = f"{tmp}/poses.txt"
    node.save_poses(poses_txt)
    rows = np.loadtxt(poses_txt, ndmin=2)
    n_marg = sum(1 for sh in fs.shells if sh.is_kf and sh.marginalized_at >= 0)
    n_edges = sum(len(f["edges"]) for f in loop.frames)
    n_scans = sum(1 for f in loop.frames if len(f["pts_sc"]))
    n_pts = [0 if f["pts_cam"] is None else len(f["pts_cam"])
             for f in loop.frames]
    ate, path = synthetic.metric_ate(rows, scene["poses"]) \
        if len(rows) >= 2 else (float("nan"), 0.0)
    log(f"{tag} (a) SlamNode over the flagship scene ({n_run} frames, "
        f"{W}x{H}, loop_lidar_range {LOOP_LIDAR}): keyframes "
        f"{fs.kf_shell_ids}, {n_marg} marginalized, {len(loop.frames)} "
        f"records in the loop handler with {n_pts} points, {n_edges} "
        f"odometry edges, {n_scans} scans, {loop.n_loop_edges} loop edges; "
        f"poses.txt {rows.shape[0]} rows, metric ATE {ate:.4f} m over "
        f"{path:.3f} m; {node_s:.2f} s for the run "
        f"({n_run / node_s:.2f} frames/s); launches K1-K4 {counts}; the "
        f"flagship phase's keyframes {flag['kf_ids']}")
    scan_s = sum(loop.timing["scan"])
    log(f"{tag} (a) the loop handler's scan timer (Scan Context's numpy "
        f"voxel filter and scan assembly): {len(loop.timing['scan'])} "
        f"calls, {scan_s * 1e3:.1f} ms, {100 * scan_s / node_s:.3f}% of the "
        "node run's wall time")
    if not fs.initialized or fs.is_lost or fs.init_failed:
        raise AssertionError("node run failed: initialized="
                             f"{fs.initialized} lost={fs.is_lost}")
    # loop closure changes no odometry result, and `none` hands the frames
    # on unchanged: the node gives the keyframes of the flagship phase's
    # FullSystem (no loop closure, the same frames)
    if fs.kf_shell_ids != flag["kf_ids"]:
        raise AssertionError(f"node keyframes {fs.kf_shell_ids} differ from "
                             f"the flagship phase's {flag['kf_ids']}")
    if len(loop.frames) != n_marg or n_marg == 0:
        raise AssertionError(f"{len(loop.frames)} records reached the loop "
                             f"handler for {n_marg} marginalized keyframes")
    if n_edges != len(loop.frames) - 1 or not all(
            np.isfinite(f["dso_error"]) for f in loop.frames):
        raise AssertionError(f"{n_edges} odometry edges for "
                             f"{len(loop.frames)} keyframes, dso_error "
                             f"{[f['dso_error'] for f in loop.frames]}")
    if n_scans < 1:
        raise AssertionError("no scan was assembled")
    if rows.shape != (n_marg, 4) or not ate <= 0.15 * path + 0.03:
        raise AssertionError(f"poses.txt {rows.shape}: ATE {ate} over "
                             f"{path}")
    for name, c in zip(("K1", "K2", "K3", "K4"), counts):
        if c <= 0:
            raise AssertionError(f"{name} was not launched on the node path")
    for k, c in zip(kernels, counts):
        k["launches_node"] = c
    phase_done("[loop] (a) node run")

    # (c) ---- estimate_direct on a record of (a): its own pyramid ----
    rec = max(loop.frames, key=lambda f: 0 if f["pts_cam"] is None
              else len(f["pts_cam"]))
    pts, inten, valid = LH._pad_points(rec["pts_cam"], rec["intensities"])
    T0 = se3(lie, torch, [0.02, 0.0, 0.0, 0.0, np.deg2rad(1.0), 0.0]) \
        .astype(np.float32)
    intr = tuple(calib.intrinsics(lvl) for lvl in range(calib.levels))

    def direct(device):
        return PE.estimate_direct(
            tuple(p.to(device) for p in rec["pyramid"]),
            *(torch.as_tensor(a, device=device) for a in (pts, inten, valid,
                                                          T0)),
            intr, calib.levels, settings.loop_direct_thres)

    direct(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Tg, okg, rg = direct(dev)
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) * 1e3
    Tc, okc, rc = direct("cpu")
    dT = float((Tg.cpu() - Tc).abs().max())
    drms = abs(float(rg) - float(rc))
    log(f"{tag} (c) estimate_direct on record {rec['incoming_id']} "
        f"({int(valid.sum())} points, its own pyramid, from 2 cm and 1 "
        f"deg off): ok {bool(okg)} rms {float(rg):.4f} on the card, ok "
        f"{bool(okc)} rms {float(rc):.4f} on the CPU; |T_card - T_cpu| "
        f"{dT:.2e}; {direct_ms:.1f} ms on the card")
    if not (bool(okg) and bool(okc) == bool(okg)):
        raise AssertionError("estimate_direct refused its own pyramid")
    if dT > 1e-4 * max(1.0, float(Tc.abs().max())) + 1e-4 * float(
            Tc.abs().max()) or drms > 1e-3 * max(1.0, abs(float(rc))):
        raise AssertionError(f"estimate_direct card vs CPU: |dT| {dT}, "
                             f"|drms| {drms}")
    phase_done("[loop] (c) estimate_direct")

    # (b) ---- LoopHandler alone on the pillar scene ----
    gt, odo, recs = pillar_scene(lie, torch)
    hs = {"sync": None, "async": None}
    for mode in hs:
        lh = LH.LoopHandler(
            default_settings(scale_opt_thres=12.0,
                             loop_lidar_range=LOOP_RANGE, loop_icp_thres=1.0,
                             scan_context_thres=0.42),
            PILLAR_INTR, 1, ringkey_margin=6, async_mode=(mode == "async"),
            device=dev)
        t0 = time.perf_counter()
        for i, pts_uvdi in enumerate(recs):
            sh = FrameShell(id=i, timestamp=i * 0.5,
                            cam_to_world=odo[i].copy(), aff=np.zeros(2))
            sh.cam_to_world_scaled = odo[i].copy()
            lh.on_keyframe(dict(shell=sh, pts_uvdi=pts_uvdi,
                                intensities=np.zeros((len(pts_uvdi), 1),
                                                     np.float32),
                                pyramid=None, dso_error=1.0,
                                scale_error=2.0))
        lh.join()
        hs[mode] = (lh, time.perf_counter() - t0)
    lh, sync_s = hs["sync"]
    traj = lh.trajectory()
    ids = traj[:, 0].astype(int)
    r_odo = EV.ate_rmse(odo[ids, :3, 3], gt[ids, :3, 3])["rmse"]
    r_opt = EV.ate_rmse(traj[:, 1:4], gt[ids, :3, 3])["rmse"]
    same = np.array_equal(traj, hs["async"][0].trajectory())
    log(f"{tag} (b) LoopHandler, pillar scene ({LOOP_KFS} keyframes): "
        f"{lh.n_loop_edges} loop edges, {lh.n_icp} verified by ICP, "
        f"{lh.n_direct} by direct alignment; rigid-aligned ATE {r_odo:.3f} m"
        f" -> {r_opt:.3f} m; sync {sync_s:.2f} s, async "
        f"{hs['async'][1]:.2f} s, same poses: {same}; graph solves "
        + ", ".join(f"{1e3 * x:.0f} ms" for x in lh.timing["graph"]))
    if not (lh.n_loop_edges >= 1 and lh.n_icp >= 1):
        raise AssertionError("no loop closure fired on the pillar scene")
    if not r_opt < 0.6 * r_odo:
        raise AssertionError(f"drift not corrected: {r_odo} -> {r_opt}")
    if not same:
        raise AssertionError("the async handler's poses differ from sync")
    phase_done("[loop] (b) handler")

    # (d) ---- the pose graph at 1000 keyframes ----
    gt, odo, pairs, args = pose_graph_scene(lie, torch)
    targs = tuple(torch.as_tensor(a, device=dev) for a in args)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T_opt = PG.optimize_pose_graph(*targs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    T_opt = T_opt.cpu().numpy().astype(np.float64)
    errs = [(loop_error(lie, odo, gt, a, b), loop_error(lie, T_opt, gt, a, b))
            for a, b in pairs]
    log(f"{tag} (d) optimize_pose_graph, 1000 keyframes (N=1024, Ec=1024, "
        f"El=16, 4 loop edges, 25 LM iterations): first call "
        f"{walls[0]:.2f} s, warm {walls[1]:.2f} s wall; loop errors "
        + ", ".join(f"{e0:.3f} -> {e1:.4f}" for e0, e1 in errs))
    for (a, b), (e0, e1) in zip(pairs[:3], errs[:3]):
        if not e1 < 0.5 * e0:
            raise AssertionError(f"pose graph: loop ({a}, {b}) {e0} -> {e1}")
    if not np.isfinite(T_opt).all():
        raise AssertionError("pose graph: non-finite poses")
    phase_done("[loop] (d) pose graph")


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def differing(first, second):
    """The fields of two NamedTuple states whose bits differ."""
    return [f for f in first._fields
            if not bits_equal(getattr(first, f), getattr(second, f))]


def held_to(tag, got, ref, fields, tol=1e-4):
    """Gate the gathered multi-rank state `got` (numpy, by "ba.<field>")
    on the single-rank step `ref` (a BAState): floats within
    tol * max(1, max|ref|) (tests/test_parallel.py's atol on the state),
    the residual states exact. Returns the largest float difference over
    its allowance."""
    worst = 0.0
    for f in fields:
        a = getattr(ref, f).cpu().numpy()
        b = got[f"ba.{f}"]
        if a.dtype.kind in "biu":
            if not np.array_equal(a, b):
                raise AssertionError(f"{tag}: {f} differs from the single-"
                                     "rank step")
            continue
        allow = tol * max(1.0, float(np.max(np.abs(a)))) if a.size else tol
        d = float(np.max(np.abs(a.astype(np.float64) - b))) if a.size else 0.
        if not d <= allow:
            raise AssertionError(f"{tag}: {f} off the single-rank step by "
                                 f"{d} > {allow}")
        worst = max(worst, d / allow)
    return worst


def multidevice_phase(torch, dev, card, kernels, md):
    """Phase [multidevice]: (a) NCCL at world size 1 in this process: the
    sharded BA step on the main scene's captured window bit for bit
    energy.gn_step (K3's two kernels by name a step), the sharded VIO step
    on the dry run's 5-frame IMU window bit for bit gn_step_vio, the
    sharded trace of the mono scene's immature pool bit for bit trace_new;
    (b) dryrun_multichip(2): two gloo ranks on this card, K3 on each
    rank's half, the gathered states held to (a)'s single-rank steps
    (atol 1e-4, energy rtol 1e-4, res_state exact; x bit-identical on the
    ranks, which each step checks); (c) ms a step of gn_step and the
    one-rank sharded step at P = 2048 and 16384, the two-rank step's, and
    the collectives' wall time a step. Launch counters from 0 before (a)
    and before (b); (b)'s are the ranks'."""
    from sos_slam_tpu_torch.models import energy as E
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.parallel import comm
    from sos_slam_tpu_torch.parallel import dryrun as DR
    from sos_slam_tpu_torch.parallel import sharded as S
    tag = f"[multidevice] ({card})"
    ba_m, dI_m, settings_m, w_m, h_m = md["window"]
    ba_t, dI_t, settings_t, _ = DR.tiny_window(device=dev)
    ba_v, dI_v, settings_v, imu_v = DR.tiny_window(n_frames=5, with_imu=True,
                                                  device=dev)
    ba_b, dI_b, settings_b, _ = DR.tiny_window(n_points=DR.P_BIG,
                                              n_slots=DR.P_BIG, device=dev)
    imm, ba_tr, tr = md["trace"]
    wrappers = (IMG.pyramid_levels, WIN.template_levels, BP.fused_iteration,
                BP.act_pass)

    # ---- (a) NCCL, world size 1: the sharded path with the launch
    # counters from 0, then the unsharded steps it is held to ----
    import torch.distributed as dist
    mesh = S.make_mesh(1, dev)
    try:
        log(f"{tag} (a) mesh: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}, device {mesh.device}")
        gn_in = dict(main=(ba_m, dI_m, settings_m, w_m, h_m),
                     tiny=(ba_t, dI_t, settings_t, DR.W, DR.H))
        trace_in = (ba_tr, imm, *tr, W, H, md["settings"])
        for w_ in wrappers:
            w_.launches = 0
        one = {k: S.sharded_gn_step(mesh, *v) for k, v in gn_in.items()}
        one["vio"] = S.sharded_vio_gn_step(mesh, ba_v, imu_v, dI_v,
                                           settings_v, DR.W, DR.H)
        traced = S.sharded_trace(mesh, *trace_in)
        counts_a = [w_.launches for w_ in wrappers]
        if counts_a[2] != 3 or any(counts_a[k] for k in (0, 1, 3)):
            raise AssertionError(f"{tag} (a) launches {counts_a} in three "
                                 "sharded steps and a trace: K3 once a "
                                 "step, no other kernel")
        for name, (ba, dI, st, w, h) in gn_in.items():
            b1, e1 = one[name]
            b0, _, e0 = E.gn_step(ba, dI, st, w, h)
            bad = differing(b1, b0) + ([] if bits_equal(e1, e0)
                                       else ["energy"])
            if bad:
                raise AssertionError(f"{tag} (a) {name}: the one-rank "
                                     f"sharded step differs from gn_step "
                                     f"in {bad}")
            log(f"{tag} (a) sharded_gn_step on the {name} window "
                f"(P={ba.P}, F={ba.F}, {w}x{h}): bit for bit "
                f"energy.gn_step, energy {float(e1):.6g}")
        bv1, iv1, ev1 = one["vio"]
        bv0, iv0, _, ev0 = E.gn_step_vio(ba_v, imu_v, dI_v, settings_v,
                                         DR.W, DR.H)
        bad = differing(bv1, bv0) + differing(iv1, iv0) \
            + ([] if bits_equal(ev1, ev0) else ["energy"])
        if bad:
            raise AssertionError(f"{tag} (a) the one-rank sharded VIO step "
                                 f"differs from gn_step_vio in {bad}")
        one["vio"] = (bv1, ev1)
        log(f"{tag} (a) sharded_vio_gn_step on the dry run's 5-frame IMU "
            f"window: bit for bit gn_step_vio, energy {float(ev1):.6g}")
        bad = differing(traced, FSM.trace_new(*trace_in))
        if bad:
            raise AssertionError(f"{tag} (a) sharded_trace differs from "
                                 f"trace_new in {bad}")
        statuses = torch.bincount(traced.status.long()).tolist()
        log(f"{tag} (a) sharded_trace of the mono scene's immature pool "
            f"({imm.u.shape[0]} points, {int(imm.valid.sum())} valid): bit "
            f"for bit trace_new, statuses {statuses}")
        _, ev = prof_window(torch, lambda: S.sharded_gn_step(
            mesh, ba_m, dI_m, settings_m, w_m, h_m))
        k3_ev = [e for e in ev if "ba_block_kernel" in e.key
                 or "block_sum_kernel" in e.key]
        nccl = [e for e in ev if "nccl" in e.key.lower()]
        log(f"{tag} (a) one sharded step, K3 by kernel name: " + "; ".join(
            f"{e.key.split('(')[0][:40]} x{e.count}" for e in k3_ev)
            + f"; NCCL kernels {sum(e.count for e in nccl)}")
        if sum(e.count for e in k3_ev) != 2 or len(k3_ev) != 2:
            raise AssertionError(f"{tag} (a) K3 is not 2 launches a sharded "
                                 f"step: {[(e.key, e.count) for e in k3_ev]}")

        # ---- (c) one rank: ms a step against gn_step ----
        for name, (ba, dI, st, w, h) in (
                ("P=2048", (ba_m, dI_m, settings_m, w_m, h_m)),
                ("P=16384", (ba_b, dI_b, settings_b, DR.W, DR.H))):
            g_dev, g_wall = time_ms(torch, lambda: E.gn_step(ba, dI, st, w, h))
            s_dev, s_wall = time_ms(torch, lambda: S.sharded_gn_step(
                mesh, ba, dI, st, w, h))
            comm.reset_stats(timed=True)
            S.sharded_gn_step(mesh, ba, dI, st, w, h)
            calls, c_ms = comm.STATS["calls"], comm.STATS["seconds"] * 1e3
            comm.reset_stats()
            log(f"{tag} (c) {name} ({int(ba.pt_valid.sum())} valid, "
                f"{w}x{h}), one rank (NCCL): gn_step {g_wall:.3f} ms a "
                f"step (device {g_dev:.3f}), sharded_gn_step {s_wall:.3f} "
                f"ms (device {s_dev:.3f}); its {calls} collectives "
                f"{c_ms:.3f} ms wall a step (card synchronized around "
                f"each); CUDA events, median of {REPS}")
    finally:
        S.close_mesh()
    phase_done("[multidevice] (a)")

    # ---- (b) two gloo ranks on this card ----
    extra = [("main", "gn", DR.window_inputs(ba_m, dI_m, w_m, h_m),
              settings_m),
             ("main_scale", "scale", DR.window_inputs(ba_m, dI_m, w_m, h_m),
              settings_m)]
    for w_ in wrappers:
        w_.launches = 0
    t0 = time.perf_counter()
    res = DR.dryrun_multichip(2, dev, extra_jobs=extra)
    wall_b = time.perf_counter() - t0
    if any(w_.launches for w_ in wrappers):
        raise AssertionError(f"{tag} (b) the parent launched a kernel")
    for name, job in (("tiny", "gn"), ("main", "main"), ("vio", "vio")):
        ref_ba, ref_e = one[name]
        got = res[job][0]
        fields = ("state", "c", "idepth", "idepth_zero", "energy_th",
                  "res_state")
        d = held_to(f"{tag} (b) {job}", got, ref_ba, fields)
        e_ref, e_got = float(ref_e), float(got["energy"])
        rel = abs(e_got - e_ref) / abs(e_ref)
        if not rel <= 1e-4:
            raise AssertionError(f"{tag} (b) {job}: energy {e_got} against "
                                 f"the single rank's {e_ref}")
        log(f"{tag} (b) {job}: the two ranks' gathered state off (a)'s "
            f"single-rank step by at most {d:.3f} of the tolerance, energy "
            f"{e_got:.6g} against {e_ref:.6g} (rel {rel:.2e}), res_state "
            "exact, the same bits on both ranks")
    k3_b = [sum(int(res[j][r]["k3_launches"]) for j in res)
            for r in range(2)]
    if min(int(res[j][r]["k3_launches"]) for j in ("gn", "main", "vio")
           for r in range(2)) < 1:
        raise AssertionError(f"{tag} (b) a rank ran a step without K3")
    for job, P in (("main_scale", ba_m.P), ("scale", DR.P_BIG)):
        sc = res[job][0]
        ms = {nd: [float(sc[f"ms_{nd}_{w}"]) for w in range(3)]
              for nd in (1, 2)}
        log(f"{tag} (c) P={P}, gloo ranks on one card: 1 rank "
            f"{np.median(ms[1]):.3f} ms a step {ms[1]}, 2 ranks "
            f"{np.median(ms[2]):.3f} ms {ms[2]} (median of 3 interleaved "
            f"windows x 3 steps, wall with the card synchronized); the two "
            f"ranks' {int(sc['comm_calls'])} collectives "
            f"{float(sc['comm_ms']):.3f} ms wall a step")
    log(f"{tag} (b) dryrun_multichip(2) {wall_b:.1f} s wall (ranks spawned, "
        f"kernels loaded, 7 jobs); K3 calls by rank {k3_b}")
    for k, c in zip(kernels, counts_a):
        k["launches_multidevice"] = c
    kernels[2]["launches_multidevice"] += sum(k3_b)


def wall_ms(torch, fn):
    """fn()'s wall ms, the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def first_use_costs(torch, dev, report):
    """The first calls of the process against their second, logged under
    [prewarm] before anything else runs on the card: build_all (the
    [build] phase's report, then a call with every library cached), each
    library's load, the first tensor on the card (the CUDA context), and
    numerics.solve / inv at the tracker's shapes (the linear-algebra
    libraries set up at their first call)."""
    from sos_slam_tpu_torch.ops import numerics as NUM
    from sos_slam_tpu_torch.utils import cuda_build
    tag = "[prewarm] first use"
    log(f"{tag}: build_all in the [build] phase: " + ", ".join(
        f"{n}.cu " + ("cached" if r["ptxas"] == "cached"
                      else f"{r['seconds']:.2f} s")
        for n, r in report.items()) + "; again: " + ", ".join(
        f"{wall_ms(torch, cuda_build.build_all):.2f} ms" for _ in range(2)))
    log(f"{tag}: load (ctypes), first and second call: " + ", ".join(
        f"{n} " + "/".join(f"{wall_ms(torch, lambda: cuda_build.load(n)):.3f}"
                           for _ in range(2)) + " ms"
        for n in cuda_build.SOURCES))
    ctx = [wall_ms(torch, lambda: torch.zeros(1, device=dev))
           for _ in range(2)]
    # inputs made on the host: no library runs on the card before the calls
    g = torch.Generator(device="cpu").manual_seed(5)
    J = torch.rand(5, 16, 8, generator=g)
    A = (J.transpose(1, 2) @ J + torch.eye(8)).to(dev)
    b = torch.rand(5, 8, generator=g).to(dev)
    T = (torch.eye(4) + 0.01 * torch.rand(4, 4, generator=g)).to(dev)
    sol = [wall_ms(torch, lambda: NUM.solve(A, b)) for _ in range(2)]
    inv = [wall_ms(torch, lambda: NUM.inv(T)) for _ in range(2)]
    log(f"{tag}: first and second call, ms: the first tensor on the card "
        f"(the CUDA context) {ctx[0]:.1f} / "
        f"{ctx[1]:.3f}, numerics.solve (solve_ex, 5 x 8x8) {sol[0]:.1f} / "
        f"{sol[1]:.3f}, numerics.inv (inv_ex, 4x4) {inv[0]:.1f} / "
        f"{inv[1]:.3f}")


def graph_pyramids(fs) -> int:
    """The pyramids the frame graph built: one a replay of its graph (A),
    whose K1 launch the replay counts (build_pyramid runs only while the
    graph is captured; `busy_window` holds that count to the K1 kernels
    the profiler sees)."""
    return 0 if fs.frame_graph is None else fs.frame_graph.replays["A"]


def timed_prewarm(torch, fs, wrappers, callers=()):
    """fs.prewarm() as bench.py calls it, the card synchronized around it:
    its wall ms, its launches by kernel (taken off the launch counters and
    the callers' call counts, which then count frames alone), the ms of
    its two fallback tracks (5 wide, 78 wide) and of its dummy frame
    dispatch at each rung (stage-timed)."""
    from sos_slam_tpu_torch.ops import tracker as TK
    # the frames in flight are frames: their completions count as such
    fs.finish_pending()
    launches = [w_.launches for w_ in wrappers]
    calls = [r.n_calls for r in callers]
    replays = graph_pyramids(fs)
    captured = chain_captured(fs)
    track = StageTimer(torch, TK, "track_hypotheses")
    dispatch = StageTimer(torch, fs, "_dispatch_fused")
    try:
        ms = wall_ms(torch, fs.prewarm)
    finally:
        track.restore()
        dispatch.restore()
        del fs._dispatch_fused        # the instance's method again
    launched = [w_.launches - n for w_, n in zip(wrappers, launches)]
    for w_, n in zip(wrappers, launched):
        w_.launches -= n
    for r, n in zip(callers, calls):
        r.n_calls = n
    g = fs.chain_graph
    return dict(ms=ms, launches=launched, tracks=track.ms[:2],
                dispatch=dispatch.ms, pyramids=graph_pyramids(fs) - replays,
                chain_captured={c: n - captured[c] for c, n in
                                chain_captured(fs).items()},
                chain_capture_ms=dict(g.capture_ms) if g else {})


def chain_captured(fs) -> dict:
    """{K1, K2}: the calls of build_pyramid and build_track_template made
    while the keyframe chain's graphs were captured (Python calls that
    launched nothing)."""
    g = fs.chain_graph
    return {c: 0 if g is None else sum(p[c] for p in g.per_replay.values())
            for c in ("K1", "K2")}


def chain_launched(fs) -> dict:
    """{K1, K2}: the launches of the keyframe chain's graph replays (a
    replay launches what its capture called, without a Python call)."""
    g = fs.chain_graph
    return {c: 0 if g is None else sum(n * g.per_replay[k][c]
                                       for k, n in g.replays.items()
                                       if k in g.per_replay)
            for c in ("K1", "K2")}


def prewarm_state(fs) -> dict:
    """Everything prewarm() must leave as it is, as tensors."""
    import torch
    out = {f"ba.{k}": v for k, v in fs.ba._asdict().items()}
    out.update({f"imm.{k}": v for k, v in fs.imm._asdict().items()})
    for lvl, tp in enumerate(fs.templates):
        out.update({f"tmpl.{lvl}.{k}": v for k, v in tp._asdict().items()})
    out.update(dI=fs.dI, HdiF=fs.HdiF,
               key=torch.as_tensor(np.array(fs.key)),
               host_out=torch.as_tensor(np.array(fs.host_out)),
               sel_pot=torch.tensor(fs._sel_pot))
    return {k: v.clone() for k, v in out.items()}


def prewarm_phase(torch, card, fs, first, wrappers):
    """Phase [prewarm]: on the mono slice's FullSystem after its last
    frame, every tensor of the window, the immature pool, the image stack,
    HdiF, the templates, the key, host_out and the rung has the same bits
    before and after prewarm(); the first call (the slice's, at frame
    WARMUP) against the second and third, stage by stage."""
    tag = f"[prewarm] ({card})"
    before = prewarm_state(fs)
    second = timed_prewarm(torch, fs, wrappers)
    after = prewarm_state(fs)
    changed = [k for k in before if not bits_equal(before[k], after[k])]
    third = timed_prewarm(torch, fs, wrappers)
    log(f"{tag} prewarm() wall ms: first {first['ms']:.1f} (the mono slice's, "
        f"frame {WARMUP}), second {second['ms']:.1f}, third "
        f"{third['ms']:.1f}; launches K1-K4 a call {second['launches']}")
    for name, i in (("5-wide track (min_level 0)", 0),
                    ("78-wide track (coarsest level)", 1)):
        log(f"{tag} {name}: first {first['tracks'][i]:.2f} ms, second "
            f"{second['tracks'][i]:.2f} ms, third {third['tracks'][i]:.2f} ms")
    pots = sorted(fs._prewarmed_pots)
    log(f"{tag} dummy frame dispatch (zero image) at rungs {pots}, ms: "
        "first " + ", ".join(f"{v:.2f}" for v in first["dispatch"])
        + "; second " + ", ".join(f"{v:.2f}" for v in second["dispatch"])
        + "; third " + ", ".join(f"{v:.2f}" for v in third["dispatch"]))
    log(f"{tag} state bits unchanged by prewarm(): {not changed} "
        f"({len(before)} tensors)")
    if changed:
        raise AssertionError(f"prewarm() changed the state: {changed}")


def synced_frames(torch, fs, feed, frames):
    """Feed `frames` with torch.cuda.set_sync_debug_mode("warn") and count
    the synchronising calls of each add_active_frame call; returns {frame:
    (count, whether the call dispatched frames again after a rung change,
    the calls by file:line, whether it replayed the keyframe chain's
    graphs once with no retry and no overrun of the frame step and no
    graph captured)}."""
    import warnings
    out = {}
    redo = fs.telemetry.timers["redispatch"]
    fg, cg = fs.frame_graph, fs.chain_graph

    def marks():
        return (chain_replays(fs), fg.retries if fg else 0,
                fg.overruns if fg else 0, len(cg.capture_ms) if cg else 0)

    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i in frames:
            n_redo = len(redo)
            m0 = marks()
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                feed(i)
            m1 = marks()
            syncs = [w for w in got if "synchroniz" in str(w.message)]
            out[i] = (len(syncs), len(redo) > n_redo,
                      [f"{w.filename.split('/')[-1]}:{w.lineno}"
                       for w in syncs],
                      m1[0] == m0[0] + 1 and m1[1:] == m0[1:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out


def replay_ms(torch, fn, n=20):
    """Device ms a call of fn (a graph replay) by a pair of CUDA events
    around n calls, after one call."""
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def graph_forms(torch, fs, args):
    """The primary track three ways on one steady frame's inputs (`args`
    of FrameGraph.step): graph (A) in the cut form (at most
    CUT_LM_TRIPS LM trips a level, no doubling) and in the full
    bounded form (every loop to its bound, the re-pass and the level
    repeat always), device ms a replay; and the eager early-exit track,
    wall ms a call (it reads the host every trip). Returns (cut ms, full
    ms, eager ms, the cut form's overrun)."""
    from sos_slam_tpu_torch.models import frame_graph as FG
    from sos_slam_tpu_torch.ops import tracker as TK
    g = fs.frame_graph
    full = FG.FrameGraph(fs, cut=False)
    full.step(*args)
    g.step(*args)
    over = bool(g.a["flags"][1])
    steady_ms = replay_ms(torch, g.graphs["A"].replay)
    full_ms = replay_ms(torch, full.graphs["A"].replay)
    s, i = fs.settings, g.inp

    def eager():
        TK.track_newest_coarse(
            g.a["pyr"], g.templates, i["T_primary"][None], i["aff"],
            i["ref_aff"], g.a["exposures"],
            torch.full((6,), float("nan"), device=fs.device), fs._intr,
            fs.n_levels, coarse_cutoff_th=s.coarse_cutoff_th,
            huber=s.huber_th)

    eager_ms = median([wall_ms(torch, eager) for _ in range(5)])
    del full
    return steady_ms, full_ms, eager_ms, over


def graph_phase(torch, dev, card, mono, flag):
    """Phase [graph]: the frame step's CUDA graphs (models/frame_graph.py)
    against its eager dispatch (cuda_graphs=False). The mono scene's 48
    frames in both forms, in turns, GRAPH_PAIRS times each (the order
    alternating), every run bit for bit the mono slice (keyframes,
    trajectory, the whole window); each prints its steady fps (frames
    WARMUP to PIPE_PROF_FROM - 1), the median frame with and without a
    keyframe chain, the card's busy share, device ms and device ops a
    frame under the profiler over the rest (with K1's launches there, seen
    by the profiler against the counter: `busy_window`), and for the graph
    form the capture ms, the graph pool's bytes, the replays of each
    graph, the frames that tracked again eagerly (overrun), the retries
    and the LM iterations of the primary track a frame by level; and the
    keyframe chain's graphs (models/chain_graph.py): K1-K4 launches of
    each run (the eager form's gated at MONO_EAGER_LAUNCHES), replays,
    eager chains by reason, capture ms, pool bytes, GN steps a keyframe,
    the selection keys' host ms; the K2-K4 kernels the profiler sees held
    to the counters. Then one more run of each form counting the synchronising
    calls of every frame (a steady frame that dispatches no keyframe chain, and
    a frame that replays the keyframe chain's graphs: at most 2 in the graph
    form, gated, each call named), the primary track three ways on one steady
    frame (`graph_forms`), and the flagship's first PIPE_FLAG_FRAMES frames in
    both forms, bit for bit."""
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.ops import tracker as TK
    from sos_slam_tpu_torch.utils.config import default_settings

    tag = f"[graph] ({card})"
    imgs = mono["imgs"]
    fps = {False: [], True: []}
    busy = {False: [], True: []}
    name = {False: "eager", True: "graph"}

    def mono_fs(graphs):
        fs = FSM.FullSystem(mono["calib"], default_settings(), device=dev,
                            cuda_graphs=graphs)

        def feed(i):
            fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        return fs, feed

    launched = {False: [], True: []}
    counters = kernel_counters()
    for p in range(GRAPH_PAIRS):
        for graphs in ((False, True), (True, False))[p % 2]:
            gc.collect()
            fs, feed = mono_fs(graphs)
            before = [fn.launches for _, fn, _ in counters]
            frame_ms = []
            for i in range(PIPE_PROF_FROM):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                feed(i)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            steady = frame_ms[WARMUP:]
            fps[graphs].append(len(steady) * 1e3 / sum(steady))
            wall, dev_ms, ops, _, k1 = busy_window(
                torch, fs, feed, PIPE_PROF_FROM, N_FRAMES - PIPE_PROF_FROM)
            # every keyframe completed (busy_window drains the queue)
            kf_ms, nonkf = split_by_keyframe(frame_ms, fs.kf_shell_ids,
                                             WARMUP)
            busy[graphs].append(dev_ms / wall)
            launched[graphs].append([fn.launches - b for (_, fn, _), b
                                     in zip(counters, before)])
            ate, path = ate_of(fs, mono["poses"])
            same = (fs.kf_shell_ids == mono["kf_ids"]
                    and np.array_equal(fs.trajectory(), mono["traj"])
                    and all(torch.equal(v, getattr(fs.ba, k))
                            for k, v in mono["ba"].items()))
            extra = ""
            g = fs.frame_graph
            if g is not None:
                it = (g.lm_iters[0].cpu().numpy()
                      / max(g.replays["A"], 1))
                most = g.lm_iters_max[0].tolist()
                extra = (f"; K1 kernels the profiler saw {k1[0]} in "
                         f"{k1[1]} replays of graph (A), as counted; "
                         f"capture {g.capture_ms:.1f} ms, graph pool "
                         f"{g.pool_bytes} bytes, replays {g.replays}, "
                         f"frames tracked again eagerly (overrun) "
                         f"{g.overruns}, retries (eager) {g.retries}, the "
                         f"state copied in {g.copy_ins}, LM iterations of "
                         "the primary track a frame by level (0 = finest), "
                         "mean / most (trips in the graph): " + ", ".join(
                             f"{lv}: {v:.2f} / {m} ({t})" for lv, (v, m, t)
                             in enumerate(zip(it, most, TK.CUT_LM_TRIPS))))
            cg = fs.chain_graph
            if cg is not None:
                extra += (
                    f"; the keyframe chain's graphs: replays "
                    f"{dict(cg.replays)}, eager chains by reason "
                    f"{dict(cg.eager)}, capture ms "
                    + ", ".join(f"rung {k}: {v:.1f}"
                                for k, v in cg.capture_ms.items())
                    + f", pool {cg.pool_bytes} bytes (apart from the "
                    f"frame graphs'), K2-K4 kernels the profiler saw "
                    f"{k1[2]} in {k1[3]} replays, as counted, the "
                    f"selection keys' host ms median "
                    f"{median(cg.draw_ms):.3f}")
            log(f"{tag} mono {W}x{H} {name[graphs]} form: steady fps "
                f"{fps[graphs][-1]:.2f} (frames {WARMUP}-"
                f"{PIPE_PROF_FROM - 1}), frames dispatching a keyframe "
                f"chain median {median(kf_ms):.1f} ms, the others median "
                f"{median(nonkf):.1f} ms; frames {PIPE_PROF_FROM}-"
                f"{N_FRAMES - 1} under the profiler: wall {wall:.1f} ms/"
                f"frame, device {dev_ms:.2f} ms/frame in {ops:.0f} device "
                f"ops, card busy {100 * busy[graphs][-1]:.1f}%; n_kf "
                f"{len(fs.kf_shell_ids)}, ATE {ate:.4f} m over {path:.3f} "
                f"m; launches K1-K4 {launched[graphs][-1]}; GN steps a "
                f"keyframe (n_its), keyframes by count "
                f"{dict(sorted(fs.kf_n_its.items()))}; bit for bit the mono "
                f"slice: {same}" + extra)
            if not same:
                raise AssertionError(f"mono in the {name[graphs]} form is "
                                     "not bit for bit the mono slice")
            if not graphs and launched[False][-1] != MONO_EAGER_LAUNCHES:
                raise AssertionError(
                    f"the eager form launched K1-K4 {launched[False][-1]} "
                    f"times, not {MONO_EAGER_LAUNCHES}")
            if graphs and (cg is None or chain_replays(fs) == 0):
                raise AssertionError("the graph form replayed no keyframe "
                                     "chain graph")
            if graphs:
                n_its = fs.kf_n_its
            del fs, feed
    log(f"{tag} mono, {GRAPH_PAIRS} pairs in turns: steady fps eager "
        + ", ".join(f"{v:.2f}" for v in fps[False]) + "; graph "
        + ", ".join(f"{v:.2f}" for v in fps[True]) + "; busy eager "
        + ", ".join(f"{100 * v:.1f}%" for v in busy[False]) + "; graph "
        + ", ".join(f"{100 * v:.1f}%" for v in busy[True])
        + "; graph / eager fps, pair by pair: "
        + ", ".join(f"{b / a:.3f}" for a, b in zip(fps[False], fps[True])))
    log(f"{tag} GN steps of the keyframe chain's BA (n_its) on the mono "
        f"scene, keyframes by count: {dict(sorted(n_its.items()))} (the "
        f"graph form's bound: {default_settings().max_opt_iterations}, the "
        "bootstrap's 20 and 15 eagerly)")
    phase_done("[graph] mono pairs")

    syncs, kf_syncs, last_args = {}, {}, None
    for graphs in (False, True):
        gc.collect()
        fs, feed = mono_fs(graphs)
        if graphs:
            step = fs.frame_graph.step

            def recorded(*a):
                nonlocal last_args
                last_args = a
                return step(*a)
            fs.frame_graph.step = recorded
        for i in range(WARMUP):
            feed(i)
        got = synced_frames(torch, fs, feed, range(WARMUP, N_FRAMES))
        fs.finish_pending()
        kf = set(fs.kf_shell_ids)
        syncs[graphs] = {i: n for i, (n, redo, _, _) in got.items()
                         if i not in kf and not redo}
        kf_syncs[graphs] = got
        if graphs:
            chained = [i for i, (_, redo, _, clean) in got.items()
                       if clean and not redo]
        if graphs:
            del fs.frame_graph.step
            forms = graph_forms(torch, fs, last_args)
        del fs, feed
    steady = sorted(syncs[True])
    log(f"{tag} synchronising calls (torch.cuda.set_sync_debug_mode) of "
        f"each add_active_frame call that dispatches no keyframe chain, "
        f"frames {steady}: graph form "
        + ", ".join(str(syncs[True][i]) for i in steady) + "; eager form "
        + ", ".join(str(syncs[False].get(i, "-")) for i in steady))
    if not steady or max(syncs[True].values()) > 2:
        raise AssertionError(f"the graph form syncs more than twice in a "
                             f"steady frame: {syncs[True]}")
    kg, ke = kf_syncs[True], kf_syncs[False]
    log(f"{tag} synchronising calls of each add_active_frame call that "
        f"replays the keyframe chain's graphs (no retry, no overrun, no "
        f"dispatch again), frames {chained}: graph form "
        + ", ".join(str(kg[i][0]) for i in chained) + "; eager form "
        + ", ".join(str(ke[i][0]) for i in chained)
        + (f"; the calls, frame {chained[-1]}: graph form "
           f"{kg[chained[-1]][2]}, eager form {ke[chained[-1]][2]}"
           if chained else ""))
    if not chained or max(kg[i][0] for i in chained) > 2:
        raise AssertionError(
            "the graph form syncs more than twice in a frame that replays "
            "the keyframe chain: " + str({i: kg[i][2] for i in chained}))
    log(f"{tag} the primary track on one steady frame's inputs: graph (A) "
        f"in the cut form (LM trips by level at most {TK.CUT_LM_TRIPS}) "
        f"{forms[0]:.3f} ms a replay (overrun {forms[3]}), in the full "
        f"bounded form {forms[1]:.3f} ms a replay, the eager early-exit "
        f"track {forms[2]:.3f} ms wall a call")
    phase_done("[graph] syncs and forms")

    scene, calib = flag["scene"], flag["calib"]
    stereo = FSM.StereoCalib(T_lr=scene["T_lr"], calib_right=calib)
    runs = {}
    for graphs in (False, True):
        gc.collect()
        fs = FSM.FullSystem(calib, flag["settings"], stereo=stereo,
                            device=dev, cuda_graphs=graphs)
        torch.cuda.synchronize()
        t0 = None
        for i in range(PIPE_FLAG_FRAMES):
            if i == FLAG_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            fs.add_active_frame(scene["left"][i], timestamp=i * FLAG_DT,
                                frame_id=i, image_right=scene["right"][i],
                                imu_samples=scene["imu"][i])
        torch.cuda.synchronize()
        f_fps = (PIPE_FLAG_FRAMES - FLAG_WARMUP) / (time.perf_counter() - t0)
        fs.finish_pending()
        runs[graphs] = fs
        g = fs.frame_graph
        log(f"{tag} flagship frames 0-{PIPE_FLAG_FRAMES - 1}, "
            f"{name[graphs]} form: fps over frames {FLAG_WARMUP}-"
            f"{PIPE_FLAG_FRAMES - 1} {f_fps:.2f}"
            + (f"; capture {g.capture_ms:.1f} ms, graph pool "
               f"{g.pool_bytes} bytes, replays {g.replays}, overrun "
               f"{g.overruns}, retries {g.retries}" if g is not None
               else ""))
    a, b = runs[False], runs[True]
    same = (a.kf_shell_ids == b.kf_shell_ids
            and np.array_equal(a.trajectory(), b.trajectory())
            and np.array_equal(a.trajectory(scaled=True),
                               b.trajectory(scaled=True))
            and torch.equal(a.ba.state, b.ba.state)
            and torch.equal(a.ba.pt_valid, b.ba.pt_valid)
            and torch.equal(a.imu.HM, b.imu.HM)
            and torch.equal(a.imu.bM, b.imu.bM))
    log(f"{tag} flagship: keyframes {b.kf_shell_ids}, graph form bit for "
        f"bit the eager form (both trajectories, ba.state, pt_valid, "
        f"imu.HM, imu.bM): {same}")
    if not same:
        raise AssertionError("the flagship's graph form is not bit for bit "
                             "its eager form")
    if b.frame_graph.replays["A"] == 0:
        raise AssertionError("the flagship's graph form replayed no graph")


def run(torch):
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.models import initializer as INIT
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils import cuda_build, synthetic
    from sos_slam_tpu_torch.utils import evaluate as EV
    from sos_slam_tpu_torch.utils.config import default_settings

    dev = torch.device("cuda")
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"kind {kind} count {torch.cuda.device_count()}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    report = cuda_build.build_all()
    log(f"[build] {len(report)} kernels in {time.perf_counter() - t0:.2f} s")
    phase_done("build")
    for name, r in report.items():
        regs = [ln.strip().replace("ptxas info    : ", "")
                for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln or "entry" in ln]
        log(f"[build] {name}.cu {r['seconds']:.2f} s " + " | ".join(regs[:9]))
    first_use_costs(torch, dev, report)

    calib = synthetic.default_calib(W, H)
    settings = default_settings()
    imgs, _, poses_t = synthetic.make_sequence(
        calib, N_FRAMES + PROF_FRAMES, TWIST, plane_z=2.0, device=dev)
    poses = poses_t.cpu().numpy().astype(np.float64)

    # ---- 3. kernels against their plain twins ----
    recs, n_pre = capture(torch, calib, settings, imgs, dev)
    kernels, timings = [], []

    # K1: all levels of one 640x480 frame in one launch
    frame = imgs[n_pre].contiguous()
    err = k1_against_plain(torch, IMG, frame, calib.levels)
    for n in (1, 3):
        err = worse(err, k1_against_plain(torch, IMG, frame, n))
    g = torch.Generator(device="cpu").manual_seed(1)
    ragged_img = (torch.rand(*RAGGED_HW, generator=g) * 255).to(dev)
    err = worse(err, k1_against_plain(torch, IMG, ragged_img, 4))
    px = sum((W >> lv) * (H >> lv) for lv in range(calib.levels))
    checked(kernels, timings,
            f"K1 pyramid_levels ({calib.levels} levels of one frame, one "
            "launch)", "sos_slam_tpu_torch/csrc/pyramid.cu",
            "sos_slam_tpu/ops/pallas_kernels.py:92", err,
            lambda: IMG.pyramid_levels(frame, calib.levels),
            lambda: IMG.pyramid_levels_plain(frame, calib.levels),
            k1_bytes(W, H, calib.levels), px * 12,
            f"{calib.levels} levels {W}x{H}..{W >> 3}x{H >> 3}, also 1 and 3 "
            f"levels and {RAGGED_HW[1]}x{RAGGED_HW[0]}; bitwise equal to one "
            "launch per level and to a second launch",
            wrapper_fn=lambda: IMG.build_pyramid(frame, calib.levels),
            launches_a_call=1)

    # K2: the template levels of the last keyframe in one launch, the
    # main path's neighbourhoods and the swapped ones
    if not recs["k2"].calls:
        raise AssertionError("K2 capture incomplete")
    (maps, colors, diags), _ = recs["k2"].calls[-1]
    if len(maps) != calib.levels or any(c.is_contiguous() for c in colors):
        raise AssertionError("K2 was not given the interleaved levels of "
                             "the keyframe")
    err = k2_against_plain(WIN, maps, colors, diags)
    err = worse(err, k2_against_plain(WIN, maps, colors,
                                      [not d for d in diags]))
    px = sum(idm.numel() for idm, _ in maps)
    tmpl_a, tmpl_kw = recs["tmpl"].calls[-1]
    checked(kernels, timings,
            f"K2 template_levels ({len(maps)} levels of one keyframe, one "
            "launch)", "sos_slam_tpu_torch/csrc/template.cu",
            "sos_slam_tpu/ops/pallas_kernels.py:171", err,
            lambda: WIN.template_levels(maps, colors, diags),
            lambda: WIN.template_levels_plain(maps, colors, diags),
            px * (3 * 4 + 4 + 1), px * 40,
            f"{len(maps)} levels x 2 neighbourhoods, colour read in place at "
            f"stride {colors[0].stride(1)}; idn and good exact, bitwise equal "
            "to one launch per level and to a second launch",
            wrapper_fn=lambda: WIN.build_track_template(*tmpl_a, **tmpl_kw),
            launches_a_call=1)

    # K3: the last GN call and the last point marginalization (use_rz on
    # the points it marginalized) of the capture run
    last = recs["k3"].last_of
    if "rz" not in last:
        raise AssertionError(
            f"the {n_pre}-frame capture marginalized no point: K3's use_rz "
            "mode has no main-path input")
    err = (0.0, 0.0)
    for a, kw in (last["gn"], last["rz"]):
        err = worse(err, k3_against_plain(BP, a, kw))
    a, kw = last["gn"]
    ba = a[0]
    P, F = ba.P, ba.F
    # the [multidevice] phase's main-scene window: this GN call's inputs
    md = dict(window=(type(ba)(*(t.clone() for t in ba)), a[2].clone(),
                      a[3], a[4], a[5]))
    D = 4 + 8 * F
    prep = BP.k3_prepare(*a, **kw)
    checked(kernels, timings, "K3 fused_iteration",
            "sos_slam_tpu_torch/csrc/ba_fused.cu",
            "sos_slam_tpu/ops/ba_p.py:350", err,
            lambda: BP.k3_launch(prep),
            lambda a=a, kw=kw: BP.fused_iteration_plain(*a, **kw),
            k3_bytes(P, F, D), k3_flops(P, F, D),
            f"P={P} F={F} D={D} ({int(ba.pt_valid.sum())} live points), "
            f"GN mode and use_rz mode ({int(last['rz'][1]['pmask'].sum())} "
            "marginalized points) checked, GN mode timed",
            wrapper_fn=lambda a=a, kw=kw: BP.fused_iteration(*a, **kw),
            launches_a_call=2)

    # K4: one activation pass, clamp off and on
    a4, kw4 = recs["k4"].calls[-1]
    err = (0.0, 0.0)
    for clamp in (False, True):
        err = worse(err, k4_against_plain(BP, a4, dict(kw4, clamp=clamp)))
    N4, F4 = a4[0].shape[0], a4[0].shape[1]
    nbytes = 4 * (N4 * F4 * 8 * 6 + N4 * 16 + N4 * F4 * 3 + N4) \
        + 4 * (2 * N4 * F4 + 3 * N4)
    checked(kernels, timings, "K4 act_pass",
            "sos_slam_tpu_torch/csrc/act_pass.cu",
            "sos_slam_tpu/ops/ba_p.py:541", err,
            lambda: BP.act_pass(*a4, **kw4),
            lambda: BP.act_pass_plain(*a4, **kw4), nbytes,
            N4 * F4 * (8 * 20 + 6), f"N={N4} F={F4}, clamp off + on",
            wrapper_fn=lambda: BP.act_pass(*a4, **kw4))
    ragged = ragged_cases(torch, dev, settings)
    phase_done("capture and kernel checks")
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], ragged[0][0])
    kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], ragged[1][0])
    del recs
    torch.cuda.synchronize()

    # ---- 4. the slice, every launch counter from 0 ----
    wrappers = (IMG.pyramid_levels, WIN.template_levels, BP.fused_iteration,
                BP.act_pass)
    # the callers of K1 and K2, counted: a call of theirs is one launch
    callers = [Recorder(FSM, "build_pyramid", 1),
               Recorder(INIT, "build_pyramid", 1),
               Recorder(WIN, "build_track_template", 1)]
    for w_ in wrappers:
        w_.launches = 0
    fs = FullSystem(calib, settings, device=dev)
    frame_ms, in_flight, rungs, pw = [], 0, [], None

    def rung_after_keyframe(i):
        while len(rungs) < fs.stats["n_kf"]:
            rungs.append((i, fs._sel_pot, pw is not None))

    for i in range(N_FRAMES):
        if i == WARMUP:
            # as bench.py does, outside the frame timers
            pw = timed_prewarm(torch, fs, wrappers, callers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        rung_after_keyframe(i)
        in_flight = max(in_flight, len(fs._pending_fused))
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    torch.cuda.synchronize()
    rung_after_keyframe(N_FRAMES)
    # a keyframe's time is that of the frame that dispatched its chain (the
    # frame id is the frame's index); its completion lands pipeline_depth
    # frames later
    kf_ms, nonkf = split_by_keyframe(frame_ms, fs.kf_shell_ids, WARMUP)
    counts = [w_.launches for w_ in wrappers]
    for r in callers:
        r.restore()
    # the chain graphs' replays launch without a Python call; their
    # captures called without a launch (those in prewarm are not counted)
    rep_c, cap_c = chain_launched(fs), chain_captured(fs)
    cap_pw = pw["chain_captured"] if pw else dict(K1=0, K2=0)
    n_pyramids = callers[0].n_calls + callers[1].n_calls \
        + graph_pyramids(fs) - (pw["pyramids"] if pw else 0) \
        + rep_c["K1"] - (cap_c["K1"] - cap_pw["K1"])
    n_templates = callers[2].n_calls + rep_c["K2"] \
        - (cap_c["K2"] - cap_pw["K2"])
    del callers
    if not fs.initialized or fs.is_lost or fs.init_failed:
        raise AssertionError(f"slice failed: initialized={fs.initialized} "
                             f"lost={fs.is_lost} init_failed={fs.init_failed}")
    ate, path = ate_of(fs, poses)
    traj = fs.trajectory()
    sim3 = EV.ate_rmse(traj[:, 1:4], poses[traj[:, 0].astype(int), :3, 3],
                       align_scale=True)
    steady = frame_ms[WARMUP:]
    fps = len(steady) / (sum(steady) / 1e3)
    n_kf = len(fs.kf_shell_ids)
    log(f"[slice] {W}x{H} {N_FRAMES} frames on {kind}, pipelined at depth "
        f"{fs.pipeline_depth} ({in_flight} frames in flight at most): n_kf "
        f"{n_kf} ATE {ate:.4f} m over {path:.3f} m (Sim(3)-aligned ate_rmse "
        f"{sim3['rmse']:.4f} m, scale {sim3['scale']:.4f}), steady fps "
        f"{fps:.2f} "
        f"(frames {WARMUP}-{N_FRAMES - 1}), frames dispatching a keyframe "
        f"chain: median {median(kf_ms):.1f} ms, first frame "
        f"{frame_ms[0]:.0f} ms")
    log(f"[slice] reference: {JAX_REFERENCE}")
    if pw is None:
        raise AssertionError(f"the slice ended before frame {WARMUP}: no "
                             "prewarm")
    warm = sorted(fs._prewarmed_pots)
    log(f"[slice] prewarm() at frame {WARMUP} (outside the frame timers): "
        f"{pw['ms']:.1f} ms wall, launches K1-K4 {pw['launches']} (not in "
        f"the slice's counts), rungs {warm}; the keyframe chain's graphs "
        f"captured by then, ms each (warm-up and capture): "
        + ", ".join(f"rung {k}: {v:.1f}" for k, v in
                    pw["chain_capture_ms"].items()))
    cg = fs.chain_graph
    log(f"[slice] the keyframe chain's graphs (models/chain_graph.py): "
        f"replays {dict(cg.replays)}, eager chains by reason "
        f"{dict(cg.eager)}, private pool {cg.pool_bytes} bytes, GN steps a "
        f"keyframe (n_its), keyframes by count "
        f"{dict(sorted(fs.kf_n_its.items()))}, the selection keys' host ms a "
        f"keyframe: median {median(cg.draw_ms):.3f}, most "
        f"{max(cg.draw_ms):.3f}")
    log("[slice] selector rung after each keyframe's completion (frame "
        "reached, rung): " + ", ".join(f"{i}:{p}" for i, p, _ in rungs))
    left = [(i, p) for i, p, after in rungs if after and p not in warm]
    if left:
        raise AssertionError(f"the rung left the prewarmed set {warm}: "
                             f"{left}")
    rep = fs.telemetry.report()["timers_ms"]
    log("[slice] host stage timers (each stage ends in a host read): "
        + ", ".join(f"{k} n={v['n']} median {v['median']:.1f} ms"
                    for k, v in sorted(rep.items()))
        + f"; steady frames dispatching no keyframe: median "
        f"{median(nonkf):.1f} ms")
    if not ate <= 0.05 * path + 0.02:
        raise AssertionError(f"ATE gate: {ate} > 0.05 * {path} + 0.02")
    for (name, c) in zip(("K1", "K2", "K3", "K4"), counts):
        if c <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if counts[0] != n_pyramids or counts[1] != n_templates:
        raise AssertionError(
            f"K1 launched {counts[0]} times for {n_pyramids} pyramids, K2 "
            f"{counts[1]} times for {n_templates} templates: a call is not "
            "one launch")
    log(f"[slice] {n_pyramids} pyramids built in {counts[0]} K1 launches, "
        f"{n_templates} templates ({n_kf} keyframes) in {counts[1]} K2 "
        "launches")
    for k, c in zip(kernels, counts):
        k["launches"] = c
    # the [multidevice] phase's trace: the pool and window at the end of the
    # slice against the next frame, its pose extrapolated at constant motion
    T1, T0 = fs.shells[-1].cam_to_world, fs.shells[-2].cam_to_world
    md["settings"] = settings
    md["trace"] = (
        type(fs.imm)(*(t.clone() for t in fs.imm)),
        type(fs.ba)(*(t.clone() for t in fs.ba)),
        (IMG.build_pyramid(imgs[N_FRAMES], 1)[0][0],
         torch.as_tensor((T1 @ np.linalg.inv(T0) @ T1).astype(np.float32),
                         device=dev),
         torch.zeros(2, device=dev),
         torch.tensor(1.0, device=dev)))
    mono = dict(calib=calib, traj=traj, kf_ids=list(fs.kf_shell_ids),
                ba={k: v.clone() for k, v in fs.ba._asdict().items()},
                imgs=imgs, poses=poses, in_flight=in_flight)
    phase_done("mono slice")
    profile_frames(torch, fs, lambda i: fs.add_active_frame(
        imgs[i], timestamp=i * 0.05, frame_id=i), N_FRAMES, PROF_FRAMES)
    phase_done("mono profile")
    prewarm_phase(torch, card, fs, pw, wrappers)
    phase_done("[prewarm] phase")
    del fs
    snapshot_phase(torch, dev, card, kernels, imgs, mono)
    phase_done("[snapshot] phase")
    flag = flagship(torch, dev, card, kernels)
    phase_done("flagship scene")
    pipeline_phase(torch, dev, card, mono, flag)
    phase_done("[pipeline] phase")
    graph_phase(torch, dev, card, mono, flag)
    del mono
    phase_done("[graph] phase")
    loop_phase(torch, dev, card, kernels, flag)
    del flag
    phase_done("loop phase")
    multidevice_phase(torch, dev, card, kernels, md)
    del md
    phase_done("[multidevice] phase")
    wrapper_stats = time_kernels(torch, kernels, timings)
    phase_done("kernel times")
    log(f"[profiler] every window opened with launches of the spin kernel, "
        f"{PRELUDE[0]} in the last; the profiler dropped up to "
        f"{PROFILER_DROPPED[0]} of them and none of the measured events")
    n_ops, crossing = wrapper_stats["[K3]"]
    log(f"[K3] whole wrapper: {n_ops:.1f} device ops a call; the first "
        f"Hopper design ran {K3_WRAPPER_OPS_FIRST_DESIGN}")
    if crossing:
        raise AssertionError("K3's wrapper copies between host and device: "
                             f"{crossing}")
    if not n_ops < K3_WRAPPER_OPS_FIRST_DESIGN:
        raise AssertionError("K3's wrapper runs no fewer device ops than "
                             "the first design")
    for tag, what, first in (
            ("[K1]", "build_pyramid", K1_WRAPPER_OPS_FIRST_DESIGN),
            ("[K2]", "build_track_template", K2_WRAPPER_OPS_FIRST_DESIGN)):
        n_ops, _ = wrapper_stats[tag]
        log(f"{tag} whole {what}: {n_ops:.1f} device ops a call; with one "
            f"launch per level it ran {first}")
        if not n_ops < first:
            raise AssertionError(f"{what} runs no fewer device ops than "
                                 "with one launch per level")
    log("kernels, launches on the mono slice: " + ", ".join(
        f"K{i + 1}={k['launches']}" for i, k in enumerate(kernels))
        + "; on the flagship scene: " + ", ".join(
        f"K{i + 1}={k['launches_flagship']}" for i, k in enumerate(kernels))
        + "; through SlamNode with loop closure: " + ", ".join(
        f"K{i + 1}={k['launches_node']}" for i, k in enumerate(kernels))
        + "; the resumed half of the snapshot phase: " + ", ".join(
        f"K{i + 1}={k['launches_snapshot']}" for i, k in enumerate(kernels))
        + "; the [multidevice] phase (K3: (a)'s calls and the ranks'): "
        + ", ".join(f"K{i + 1}={k['launches_multidevice']}"
                    for i, k in enumerate(kernels)))
    log(json.dumps({"kernels": kernels}))
    log(f"{card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import sos_slam_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the sos_slam_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    try:
        run(torch)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
