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
     each frame one replay of the fused frame graph of its selector rung:
     models/fused_graph.py; every phase runs that default unless it says
     otherwise),
     FullSystem.prewarm() before frame 26 as bench.py calls it (outside
     the frame timers; its launches, taken off the counters, and its wall
     ms are printed), with every launch counter set to 0
     just before and read just after; initialized, not lost, and the
     scale-aligned ATE <= 0.05 * path + 0.02, as bench.py gates it; K1
     launched once per pyramid built (build_pyramid calls outside a
     capture, and the graphs' replays: the launches captured outside
     their conditional nodes a replay, and those in the nodes' bodies
     times the runs the nodes counted on the device) and K2 once per
     template built; the conditional nodes run (branches taken, loop
     trips: `launches` of graph_cond in the kernels line); no keyframe
     chain run eagerly but the classic one (its bootstrap budgets and
     exports replay: `budget` and `export` 0, gated); the selector rung
     after each keyframe printed, and gated on staying in the prewarmed
     set from frame 26 on;
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
     through the port's FullSystem in the graph form (the fused VIO frame
     as CUDA graphs), every launch counter from 0:
     gated on initialized, not lost, the IMU initialized, the stereo scale
     trapped, the fused VIO chain run inside the graphs (eager only for a
     classic keyframe), the VIO prior finite
     after the run, the stereo scale after every keyframe from frame 35 on
     within 1% of the first one's, the scaled trajectory's metric ATE (no
     alignment) <= 0.15 * path + 0.03, K1-K4 each launched, K1 once per
     pyramid built (left and right; a replay counts its launches as in
     step 4) and K2 once per template; it prints the keyframe count,
     ATE, scale, steady fps over frames 30-43 (as bench.py measures it),
     the median of the frames that dispatch a keyframe chain (the frames
     that captured a rung's graph named apart), the graphs' replays,
     the keyframe chains in them, capture ms, pool bytes and launches
     (the capture warm-ups' apart), and on the last fused keyframe's
     inputs the VIO chain captured alone (a ChainGraph): a replay's
     device ms whole, with the GN steps and the frame marginalizations it
     ran, and by stage (each stage captured alone: the scale solve's
     branch and each branch alone against the eager solve's wall ms, and
     the eager solve's LM trips by level);
     then the eager form (cuda_graphs=False), gated at K1-K4 launches
     FLAG_EAGER_LAUNCHES and the graph form's at those plus its capture
     warm-ups', bit for bit the graph run and a finite
     prior before every VIO frame marginalization, with K3 on a VIO GN
     step and a VIO point marginalization, K4 on an activation pass and K1
     on a right image of that run against their plain twins, and every
     VIO frame marginalization of that run folded both by the port
     (`energy.fold_vio_block`, the live subspace of the block without an
     eigendecomposition) and by the float64 fold from an
     eigendecomposition (`live_fold64`), the run going on with the
     port's: one line a marginalization (the block's zero
     rows, its smallest and largest eigenvalue, the scale row of both
     folds), one a keyframe from frame 35 on (its scale and the scale's
     GN steps, the wall ms of both folds), gated on the port's fold
     within 1e-4 of the reference; the same frames once with the port's
     fold and once with the JAX package's NaN-prior fold (`jax_form=True`),
     the keyframe chain's stages timed, for the cost of the working VIO
     BA; and 2 more frames under torch.profiler;
  6a. the [pipeline] phase: the mono scene at depth 0 (synchronous) and
     depth 3 in turns (the order alternating; prewarm() at frame 26 as
     in step 4, so that no rung's graph is captured in the fps window),
     three times each, every
     run bit for bit the pipelined slice of step 4, with its steady fps,
     its host stage timers, the frames dispatched again after a rung
     change and the card's busy share under the profiler; the flagship
     scene's first 36 frames (the IMU initialization and two VIO frame
     marginalizations) at depth 0
     and 3, each drained, bit for bit on the trajectories, the window and
     the VIO prior; the most frames seen in flight (at least 2);
  6a'. the [graph] phase: the mono scene in the eager form
     (cuda_graphs=False) and the graph form (one fused frame graph a
     rung: the step, the decision and the keyframe chain, the retry, the
     tracker's loops, the chain under need_kf and the BA's loop as
     conditional nodes) in turns (the order alternating; prewarm() at
     frame 26 as in step 4, its launches and its captures' warm-ups taken
     off), three times each, every run bit for bit the mono slice of
     step 4, with its
     steady fps, its median frame with and without a keyframe chain, the
     card's busy share, device ms and device ops a frame under the
     profiler, K1-K4 launches (the graph form's gated at the eager form's
     plus its capture warm-ups'), and for the graph form the capture ms,
     the graph pool's bytes, the replays, the keyframe chains in them,
     the eager chains by reason (only `classic`, gated), the retries
     (inside the graph; no frame stepped eagerly, gated) and the LM
     trips (mean and most) of the primary track a frame; one more
     run of each form counting the synchronising calls of each frame's
     dispatch apart from the completions in the same call
     (torch.cuda.set_sync_debug_mode): 0 in the dispatch of every frame
     of the graph form, keyframe or not (gated; a frame dispatched again
     or capturing a graph left out), the eager form's beside them; on
     one steady frame's inputs the fused graph's replay, the frame step's
     own graph, the record's clones and a copy-in (device ms) and the
     eager primary track (wall ms); the flagship in both forms (fps over
     frames 30-35, frame 31's dispatch handed an untrapped scale state,
     which the next keyframe's chain solves from the multi-guess start,
     replayed in the graph form, gated; then frames 36-43 counting the
     synchronising calls: 0 in the dispatch of a VIO frame, keyframe or
     not, gated, the eager form's beside it), bit for bit on the
     trajectories, the window, the immature pool, the IMU state, the
     scale and the gyro bias;
  6a''. the [control] phase: scripts/torch_graph_probe.py's cases of the
     conditional nodes (IF, IF/else, nested IF, WHILE of no trip, three
     trips and to its cap, the counters' credit) bit for bit their eager
     forms (gated), and the device us of a skipped IF node, its plain
     twin, a tiny kernel's node and a WHILE trip;
  6b. the [loop] phase: (a) the flagship scene's frames through the port's
     SlamNode (pinhole camera files, no rectification, loop closure on
     at a 40 m LiDAR range, the loop handler synchronous so that its
     errors propagate), every launch counter from 0: gated on the
     flagship phase's keyframes (loop closure changes no odometry
     result, and `none` rectification hands the frames on unchanged),
     no keyframe chain run eagerly but the classic ones (the export
     keyframes replay: `export` 0, gated), one handler record per
     marginalized keyframe,
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
     JSON object, K1-K4 and graph_cond, whose `ms` is a skipped IF node
     and `launches` the bodies its nodes ran on the mono slice;
     `launches` counts the mono slice, `launches_flagship`
     the flagship scene, `launches_node` the SlamNode run,
     `launches_snapshot` the resumed half of step 5b,
     `launches_multidevice` the calls of step 6c: (a)'s and the ranks');
  8. last line: {"ok": true, "device": {...}}.

Needs one card; exits with code 2 when CUDA is unavailable or the port is
not importable beside this script. `python3 chip_smoke.py --flagship`
runs the build, the flagship phase and [graph]'s flagship part alone
(no result line).
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
# [graph]'s flagship part hands the first keyframe from this frame on an
# untrapped scale state, in both forms
FLAG_UNTRAP = 31
GRAPH_PAIRS = 3   # the [graph] phase: eager and graph form in turns
# K1-K4 launches of the eager form (cuda_graphs=False) over the mono scene's
# frames: the mono slice's count before the keyframe chain ran as graphs
# (K3 134 until numerics.solve took LU factors and two triangular solves on
# a card, whose rounding ends one keyframe's BA a GN step sooner)
MONO_EAGER_LAUNCHES = [73, 22, 133, 88]
# the flagship's K1-K4 launches in the eager form (cuda_graphs=False)
FLAG_EAGER_LAUNCHES = [65, 10, 64, 40]
# the reasons a keyframe chain may run eagerly in the graph form: the
# classic keyframes (the bootstrap's, those after a refused frame); the
# bootstrap budgets and the export keyframes replay
FUSED_EAGER_REASONS = {"classic"}
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
        self.n_calls = self.n_captured = 0
        setattr(module, name, self)

    @property
    def n_launched(self):
        """The calls that launched (made outside a capture)."""
        return self.n_calls - self.n_captured

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, n):
        self.orig.launches = n

    def __call__(self, *args, **kw):
        import torch
        self.calls.append((args, kw))
        self.n_calls += 1
        # a call while a graph is captured launches nothing
        self.n_captured += torch.cuda.is_current_stream_capturing()
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
        if self.torch.cuda.is_current_stream_capturing():
            # a call captured into a graph: a synchronize would break it
            return self.orig(*args, **kw)
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
    return "right" if "_scale_solve" in sys._getframe(2).f_code.co_qualname \
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
    """The keyframes whose chain ran inside a replay of the fused frame
    graph (models/fused_graph.py) so far, counted at their completion."""
    g = fs.fused_graph
    return 0 if g is None else sum(g.chains.values())


def busy_window(torch, fs, feed, first, n, exact=False):
    """n frames of the scene from `first` (`feed(i)` hands frame i to the
    same FullSystem) under torch.profiler, the frames in flight completed
    inside the window: (wall ms a frame, device ms a frame, device ops a
    frame, the window's device events, the launches). The profiler slows
    the host, so the busy share dev / wall is a lower bound. The launches
    are (the K1 kernels the profiler saw, the replays of the frame graph
    in the window, {kernel: the K2-K4 kernels seen}, the replays of the
    keyframe chain's graphs, {kernel: (seen, counted, counted inside
    conditional nodes, what the profiler shows by control.PROFILED's
    rule)}). Each kernel's launch counter moves by the launches outside
    conditional nodes (a replay adds those it captured) plus those inside
    them (`control` credits the nodes' runs at the frames' reads and at
    finish_pending); the profiler reports those inside an IF body at each
    run and those inside a WHILE body once each time the node is entered
    (control.PROFILED). Without graphs (the eager form), and with them
    where `exact` (the first window of the graph form in this process),
    the profiler must see exactly that many kernels of each name, or this
    raises. Later windows of the graph form raise only where the profiler
    sees fewer kernels of a name than were counted outside conditional
    nodes: a process that has made many conditional nodes gets records of
    their bodies' kernels lost, and some added (`[control]`'s profiler
    view logs it), which the same frames in a fresh process do not show;
    since the keyframe chain runs inside the need_kf IF node, a window's
    K2-K4 may all lie in bodies."""
    from sos_slam_tpu_torch.ops import control
    counters = kernel_counters()
    # the runs made before the window are credited before it
    torch.cuda.synchronize()
    control.account()
    before = [fn.launches for _, fn, _ in counters]
    in_nodes, shown = dict(control.CREDITED), dict(control.PROFILED)
    replays, chains = frame_replays(fs), chain_replays(fs)

    def body():
        t0 = time.perf_counter()
        for i in range(first, first + n):
            feed(i)
        fs.finish_pending()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n
    wall, ev = prof_window(torch, body, tries=1)   # body feeds the frames
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    replays = frame_replays(fs) - replays
    chains = chain_replays(fs) - chains
    graphs = fs.fused_graph is not None
    seen, held = {}, {}
    for (name, fn, kernel), b in zip(counters, before):
        seen[name] = sum(e.count for e in ev if kernel in e.key)
        counted = fn.launches - b
        inside = control.CREDITED[name] - in_nodes.get(name, 0)
        rule = counted - inside + control.PROFILED[name] \
            - shown.get(name, 0)
        held[name] = (seen[name], counted, inside, rule)
        if (seen[name] != rule) if (exact or not graphs) else (
                seen[name] < counted - inside):
            raise AssertionError(
                f"frames {first}-{first + n - 1}: the profiler saw "
                f"{seen[name]} {name} launches ({kernel}), the launch "
                f"counter counted {counted}, {inside} of them inside "
                f"conditional nodes, of which the profiler shows "
                f"{rule - counted + inside} by control.PROFILED's rule "
                f"({replays} replays of the fused frame graph, {chains} "
                f"keyframe chains in them)")
    return wall, dev_ms, sum(e.count for e in ev) / n, ev, (
        seen.pop("K1"), replays, seen, chains, held)


def profile_frames(torch, fs, feed, first, n, tag="profile", exact=False):
    """Where a frame's time goes: n more frames of the scene through the
    same FullSystem under torch.profiler (`busy_window`, `exact` passed
    on). Logs the wall and device time per frame, the card's busy share,
    its launches per frame and the device ops that take the most time."""
    n_kf = fs.stats["n_kf"]
    wall, dev_ms, ops, ev, k1 = busy_window(torch, fs, feed, first, n,
                                            exact=exact)
    log(f"[{tag}] frames {first}-{first + n - 1} ({fs.stats['n_kf'] - n_kf} "
        f"keyframes), profiler on: wall {wall:.1f} ms/frame, device "
        f"{dev_ms:.2f} ms/frame, card busy {100 * dev_ms / wall:.1f}%, "
        f"{ops:.0f} device ops/frame; K1 kernels the profiler saw {k1[0]} "
        f"(replays of the fused frame graph {k1[1]}), K2-K4 {k1[2]} ("
        f"keyframe chains in the replays {k1[3]}); (seen, counted, inside "
        f"conditional nodes, shown by control.PROFILED's rule) by kernel "
        f"{k1[4]}" + ("; held exactly" if exact else ""))
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
    # fused frame graph holds the graph's own buffers
    fs.fused_graph = None
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

    zero_launches(wrappers)
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
        from sos_slam_tpu_torch.models import chain_graph as CG
        self.torch, self.E, self.IM, self.CG = torch, E, IM, CG
        self.use, self.plant, self.f32 = use, plant, f32
        self.fold_orig, self.solve_orig = E.fold_vio_block, IM.solve_vio
        self.marg_orig = CG.marg_frames
        E.fold_vio_block, IM.solve_vio = self.fold, self.solve
        CG.marg_frames = self.marg_frames
        self.frame = -1
        self.margs, self.steps = [], []
        # whether each fold of the chain's masked marginalizations is kept
        # (a padded slot's fold is computed and dropped)
        self.kept = []

    def restore(self):
        self.E.fold_vio_block = self.fold_orig
        self.IM.solve_vio = self.solve_orig
        self.CG.marg_frames = self.marg_orig

    def marg_frames(self, fs, ba, imm, dI, host_out, marg_ks, imu=None):
        if imu is not None:
            self.kept = [k >= 0 for k in marg_ks.tolist()]
        return self.marg_orig(fs, ba, imm, dI, host_out, marg_ks, imu=imu)

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
        sl = int(sl)
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
            kept=self.kept.pop(0) if self.kept else True,
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
               for m in self.margs if m["kept"]]
        out.append(f"{tag} besides, {sum(not m['kept'] for m in self.margs)}"
                   " folds of the chains' padded slots, computed and "
                   "dropped (the marginalizations are masked on the device)")
        by = collections.defaultdict(list)
        for f, sc, dx in self.steps:
            if f >= from_frame:
                by[f].append((sc, dx))
        for f, st in sorted(by.items()):
            out.append(f"{tag} keyframe at frame {f}: scale {st[0][0]:.6f} "
                       f"at its first VIO GN step, GN steps of the scale "
                       + ", ".join(f"{dx:+.3e}" for _, dx in st))
        return out


def check_flagship_kernels(torch, BP, IMG, k3, k4, right, calib, tag,
                           kernels):
    """K3 on a VIO GN step and a VIO point marginalization, K4 on an
    activation pass and K1 on a right image of the flagship's eager run
    against their plain twins; widens each kernel's max_abs_err."""
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
    for k, e in zip(kernels, (err1, (0.0, 0.0), err3, err4)):
        k["max_abs_err"] = max(k["max_abs_err"], e[0])


def captured_ms(torch, fn):
    """fn captured alone into a CUDA graph of its own pool (after a
    warm-up on a side stream), its branches and loops as conditional
    nodes (`control.capture`), then the device ms a replay
    (`replay_ms`)."""
    from sos_slam_tpu_torch.ops import control
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with control.capture(g, torch.cuda.graph_pool_handle(), side):
        fn()
    torch.cuda.synchronize()
    return replay_ms(torch, g.replay, n=5)


def vio_stages(torch, card, fs, dispatches):
    """A VIO keyframe chain replay's device ms, whole and by stage, on the
    inputs of the run's last fused keyframe (its dispatch's arguments in
    `dispatches`, a `Dispatches`: the fused frame graph's body up to the
    chain run on them, then the chain alone captured as a ChainGraph of
    models/chain_graph.py), with the GN steps and the frame marginalizations that replay ran
    (the conditional nodes leave the BA at its break and skip the folds
    of padded slots): each stage captured alone into a graph and replayed
    under a pair of CUDA events: `vio_head` (flags, insertion, IMU
    intake, spline propagation, activation), one VIO GN step, the scale
    solve (the branch `trapped` chooses, under `control.cond`) and each
    branch alone, `vio_tail` (point marginalization, selection, the VIO
    frame marginalizations of the flagged slots, compaction), one VIO
    frame marginalization (its float64 fold included) and the fold's
    `live_pinv` alone on a 29x29 block of the IMU prior; beside them the
    eager scale solve's wall ms (one branch, early exits, the card
    synchronized around it) and the stereo scale LM's trips a level in
    the eager runs so far."""
    from sos_slam_tpu_torch.models import chain_graph as CG
    from sos_slam_tpu_torch.models import energy as E
    from sos_slam_tpu_torch.ops import ba as B
    from sos_slam_tpu_torch.ops import scale_opt as SO
    from sos_slam_tpu_torch.ops.image import build_pyramid
    from sos_slam_tpu_torch.ops.numerics import live_pinv
    tag = f"[flagship VIO chain stages] ({card})"
    g = fs.fused_graph
    last = max(i for i in fs.kf_shell_ids if i in dispatches.by_id)
    (st, inp, prev, _, img, exposure, key, right, shell_idx, block, pot,
     _) = dispatches.by_id[last]
    g._load(st, inp, prev)
    g._stage(img, exposure, key, right, shell_idx, block)
    c = g._head()
    g.last = None            # the buffers hold no record's state now
    cg = CG.ChainGraph(fs)
    cg.prepare(c["st"], c["imm"], c["pyr"], c["T_cw_new"], c["aff_new"],
               c["exposure"], c["stats"], c["host_out"], c["n_kf"], key,
               c["kf"])
    cg.capture(pot)
    i, s = cg.inp, fs.settings
    kf = dict(right=i["right"], have_right=i["have_right"],
              scale_state=i["scale_state"], staged=i["staged"],
              timestamp=i["timestamp"])
    out = cg.out[pot]
    tmpl = out["state"]["templates"]
    whole = replay_ms(torch, cg.graphs[pot].replay, n=5)
    folds = int((out["marg_ks"] >= 0).sum())
    n_its = int(out["ba_stats"]["n_its"])
    trapped = bool(i["scale_state"][1])
    hd = CG.vio_head(fs, i, i["imm"], i["pyr"], i["T_cw_new"],
                     i["aff_new"], i["exposure"], i["stats"], i["host_out"],
                     i["n_kf"], kf)
    ev = B.make_precalc_eval(hd["ba"])
    D = hd["imu"].HM.shape[0]
    blk = hd["imu"].HM[D - 29:, D - 29:].double()
    R01, t01, intr1 = fs._lr
    pyr_r, _ = build_pyramid(i["right"], fs.n_levels)
    args = (R01, t01, fs._intr, intr1, fs.n_levels)
    s_cur = i["scale_state"][0].reshape(1)
    ms = dict(
        head=lambda: CG.vio_head(fs, i, i["imm"], i["pyr"], i["T_cw_new"],
                                 i["aff_new"], i["exposure"], i["stats"],
                                 i["host_out"], i["n_kf"], kf),
        gn_step=lambda: E.gn_step_vio(hd["ba"], hd["imu"], hd["dI"], s,
                                      fs.w, fs.h, ev=ev),
        scale=lambda: fs._scale_solve(tmpl, kf, True),
        trapped=lambda: SO.scale_lm(pyr_r, tmpl, s_cur, *args,
                                    bounded=True),
        multi=lambda: SO.multi_guess(pyr_r, tmpl, *args, bounded=True),
        tail=lambda: CG.vio_tail(fs, hd, hd["ba"], hd["imu"],
                                 out["state"]["HdiF"], i["pyr"], pot,
                                 i["keys"]),
        frame_marg=lambda: E.marginalize_frame_vio(
            hd["ba"], hd["imu"], torch.clamp(hd["slot"] - 2, min=0), s),
        live_pinv=lambda: live_pinv(blk, E.LIVE_CUT))
    got = {k: captured_ms(torch, fn) for k, fn in ms.items()}
    eager = median([wall_ms(torch, lambda: fs._scale_solve(
        tmpl, kf, False)) for _ in range(5)])
    log(f"{tag} keyframe {last}, rung {pot}: a replay of the chain "
        f"alone {whole:.3f} ms of device work, with "
        f"{n_its} GN steps and {folds} of {CG.MAX_MARG_FRAMES} frame "
        f"marginalizations run (the rest skipped by their nodes), the "
        f"scale {'trapped' if trapped else 'untrapped'}; each stage in a "
        f"graph of its own (these need not add up to the replay): before "
        f"the BA (vio_head) {got['head']:.3f}, one VIO GN step "
        f"{got['gn_step']:.3f}, the scale solve (its one branch) "
        f"{got['scale']:.3f} (trapped alone {got['trapped']:.3f}, the "
        f"multi-guess alone {got['multi']:.3f}), after the scale "
        f"(vio_tail, on the last chain's flags) {got['tail']:.3f} of which "
        f"one VIO frame marginalization {got['frame_marg']:.3f} (its "
        f"float64 live_pinv on a 29x29 block {got['live_pinv']:.3f}); the "
        f"eager scale solve (one branch, early exits) {eager:.3f} ms wall")
    log(f"{tag} the stereo scale LM's trips in the eager runs so far, by "
        f"(guesses, level, doublings, LM trips, repeat's doublings, "
        f"repeat's LM trips): " + ", ".join(
            f"{k}: {v}" for k, v in sorted(SO.TRIPS.items())))


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
    # the graph form (the default): K1 and K2 calls counted (a call made
    # while a chain graph is captured launches nothing, a replay launches
    # without a call); no recorder here reads the card, as a capture
    # refuses it
    recs = [Recorder(FSM, "build_pyramid", 1, kind=pyramid_side),
            Recorder(INIT, "build_pyramid", 1),
            Recorder(WIN, "build_track_template", 1),
            Recorder(IMG, "build_pyramid", 1)]      # the frame graph's
    zero_launches(wrappers)
    fs = FSM.FullSystem(calib, settings, stereo=stereo, device=dev)
    warm, rep0 = WarmUps(fs), replay_launched(fs)
    dispatches = Dispatches(fs)
    kf_scale = {}       # the stereo scale after each fused keyframe
    finish_kf = fs._finish_kf

    def scale_of(rec, got, classic):
        finish_kf(rec, got, classic)
        kf_scale[rec["shell"].id] = fs.current_scale

    fs._finish_kf = scale_of
    cg = fs.fused_graph
    frame_ms, t_steady, captured_at = [], None, []
    for i in range(FLAG_FRAMES):
        if i == FLAG_WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        n_cap = len(cg.capture_ms)
        t0 = time.perf_counter()
        feed(fs, i)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if len(cg.capture_ms) > n_cap:
            captured_at.append(i)
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t_steady if t_steady else float("nan")
    counts = [w_.launches for w_ in wrappers]
    for r in recs:
        r.restore()
    pyr_l, pyr_i, tmpl, pyr_f = recs

    tag = f"[flagship] ({card})"
    if not fs.initialized or fs.is_lost or fs.init_failed:
        raise AssertionError(f"flagship failed: initialized={fs.initialized}"
                             f" lost={fs.is_lost} "
                             f"init_failed={fs.init_failed}")
    ate, path = synthetic.metric_ate(fs.trajectory(scaled=True),
                                     scene["poses"])
    n_kf = len(fs.kf_shell_ids)
    fps = (FLAG_FRAMES - FLAG_WARMUP) / steady_s
    # a keyframe's time is that of the frame that dispatched its chain;
    # the frames whose chain captured a rung's graph are named apart
    kf_all, nonkf = split_by_keyframe(frame_ms, fs.kf_shell_ids, FLAG_WARMUP)
    kf_ms = [frame_ms[i] for i in fs.kf_shell_ids
             if i >= FLAG_WARMUP and i not in captured_at]
    log(f"{tag} {W}x{H} {FLAG_FRAMES} frames, stereo + VIO on {card}, the "
        f"graph form (one fused frame graph a rung): n_kf "
        f"{n_kf}, metric ATE of the scaled trajectory (no alignment) "
        f"{ate:.4f} m over {path:.3f} m, stereo scale {fs.current_scale:.4f}"
        f", IMU scale {float(fs.imu.scale) * IM.SCALE_SCALE:.4f}, steady fps "
        f"{fps:.2f} (frames {FLAG_WARMUP}-{FLAG_FRAMES - 1}, {steady_s:.3f} "
        f"s), frames dispatching a keyframe chain: median "
        f"{median(kf_ms):.1f} ms ({len(kf_ms)} in the window, none that "
        f"captured), the other frames: median {median(nonkf):.1f} ms, first "
        f"frame {frame_ms[0]:.0f} ms; frames that captured a rung's graph: "
        + (", ".join(f"{i} ({frame_ms[i]:.1f} ms)" for i in captured_at)
           or "none"))
    log(f"{tag} reference: {JAX_FLAGSHIP}")
    log(f"{tag} the fused VIO frame's graphs: replays (frames by rung) "
        f"{dict(cg.replays)}, keyframe chains in them "
        f"{dict(cg.chains)}, eager chains by reason {dict(cg.eager)} "
        f"(budget {cg.eager['budget']}, export {cg.eager['export']}), "
        f"capture ms " + ", ".join(f"rung {k}: {v:.1f}"
                                   for k, v in cg.capture_ms.items())
        + f", the graphs' pool {cg.pool_bytes} bytes, the state copied in "
        f"{cg.copy_ins} times, launches K1-K4 {counts} of which "
        f"the capture warm-ups' {warm.n}, a replay's outside its "
        f"conditional nodes {dict((k, v) for k, v in cg.per_replay.items())}"
        f"; GN steps a "
        f"keyframe (n_its), keyframes by count "
        f"{dict(sorted(fs.kf_n_its.items()))}")
    if chain_replays(fs) == 0 or not set(cg.eager) <= FUSED_EAGER_REASONS:
        raise AssertionError(
            f"flagship: the VIO chain ran in {dict(cg.chains)} replays, "
            f"eager chains by reason {dict(cg.eager)}")
    log(f"{tag} the VIO prior after the run is "
        + ("finite" if bool(torch.isfinite(fs.imu.HM).all()) else "NaN")
        + f"; {n_kf} keyframes, scaled ATE {ate:.4f} m")
    rep = fs.telemetry.report()["timers_ms"]
    log(f"{tag} host stage timers: " + ", ".join(
        f"{k} n={v['n']} median {v['median']:.1f} ms"
        for k, v in sorted(rep.items())))
    if not bool(torch.isfinite(fs.imu.HM).all() & torch.isfinite(
            fs.imu.bM).all()):
        raise AssertionError("flagship: the VIO prior is not finite after "
                             "the run")
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
    rep = {c: n - rep0[c] for c, n in replay_launched(fs).items()}
    n_pyr = pyr_l.n_launched + pyr_i.n_launched + pyr_f.n_launched \
        + rep["K1"]
    n_tmpl = tmpl.n_launched + rep["K2"]
    if counts[0] != n_pyr or counts[1] != n_tmpl:
        raise AssertionError(
            f"flagship: K1 launched {counts[0]} times for {n_pyr} pyramids "
            f"({n_right} right pyramids called), K2 {counts[1]} times for "
            f"{n_tmpl} templates: a call is not one launch")
    log(f"{tag} {n_pyr} pyramids built in {counts[0]} K1 launches ("
        f"{rep['K1']} in graph replays, {pyr_l.n_captured} calls while "
        f"capturing; {n_right} right pyramids called), {n_tmpl} templates "
        f"in {counts[1]} K2 launches; K3 {counts[2]} launches; K4 "
        f"{counts[3]} launches")
    for k, c in zip(kernels, counts):
        k["launches_flagship"] = c
    del recs, pyr_l, pyr_i, tmpl, pyr_f
    dispatches.restore()
    vio_stages(torch, card, fs, dispatches)
    del dispatches
    phase_done("flagship run and checks")

    # the eager form (cuda_graphs=False): its launches gated, the K3 calls
    # by caller, the kernels on this run's own inputs; every VIO fold at
    # every frame marginalization the port's against the float64 fold from
    # an eigendecomposition (the run goes on with the port's)
    probe = FoldProbe(torch, E, IM, use="port")
    recs = [Recorder(BP, "fused_iteration", 1, kind=k3_caller),
            Recorder(BP, "act_pass", 1),
            Recorder(E, "marginalize_frame_vio", 1, kind=prior_in)]
    zero_launches(wrappers)
    fp = FSM.FullSystem(calib, settings, stereo=stereo, device=dev,
                        cuda_graphs=False)
    for i in range(FLAG_FRAMES):
        probe.frame = i
        feed(fp, i)
    fp.finish_pending()
    probe.restore()
    ptag = f"{tag} [port fold, eager form]"
    eager_counts = [w_.launches for w_ in wrappers]
    for r in recs:
        r.restore()
    k3, k4, mfv = recs
    same = (fp.kf_shell_ids == fs.kf_shell_ids and np.array_equal(
        fp.trajectory(scaled=True), fs.trajectory(scaled=True))
        and torch.equal(fp.imu.HM, fs.imu.HM))
    log(f"{ptag} launches K1-K4 {eager_counts} (gate: "
        f"{FLAG_EAGER_LAUNCHES}); K3 by caller " + ", ".join(
            f"{k} {v}" for k, v in sorted(k3.n_of.items()))
        + "; VIO frame marginalizations (the padded slots' included) by "
        "the prior they started from: " + (", ".join(
            f"{k} {v}" for k, v in sorted(mfv.n_of.items())) or "none")
        + f"; bit for bit the graph form's run (keyframes, scaled "
        f"trajectory, imu.HM): {same}")
    if eager_counts != FLAG_EAGER_LAUNCHES:
        raise AssertionError(
            f"flagship: the eager form launched K1-K4 {eager_counts} times, "
            f"not {FLAG_EAGER_LAUNCHES}")
    plus = [e + w_ for e, w_ in zip(eager_counts, warm.n)]
    log(f"{ptag} graph-form launches K1-K4 {counts} against the eager "
        f"form's plus the graph form's capture warm-ups {plus} (gate: "
        "equal)")
    if counts != plus:
        raise AssertionError(
            f"flagship: the graph form launched K1-K4 {counts} times, not "
            f"the eager form's plus its warm-ups' {plus}")
    if mfv.n_of["NaN"] or not same:
        raise AssertionError(
            f"flagship: a NaN VIO prior {dict(mfv.n_of)} or the eager form "
            f"is not the graph form's run ({same})")
    check_flagship_kernels(torch, BP, IMG, k3, k4, right, calib, tag,
                           kernels)
    del recs, k3, k4, mfv
    for line in probe.lines(ptag, FLAG_SCALE_FROM):
        log(line)
    ate_p, _ = synthetic.metric_ate(fp.trajectory(scaled=True),
                                    scene["poses"])
    log(f"{ptag} keyframes {fp.kf_shell_ids}, stereo scale "
        f"{fp.current_scale:.6f}, scaled ATE {ate_p:.5f} m")
    worst = max((m["dH"] for m in probe.margs), default=float("inf"))
    if not (probe.margs and worst <= 1e-4 and all(
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
                            jax_form=form == "jax", cuda_graphs=False)
        chain = StageTimer(torch, fj, "_kf_chain_vio")
        stages = [StageTimer(torch, *o) for o in (
            (E, "optimize_vio"), (WIN, "build_track_template"),
            (E, "marginalize_points_vio"), (E, "marginalize_frame_vio"),
            (E, "fold_vio_block"), (fj, "_activate"), (fj, "_scale_solve"),
            (fj, "_select_insert"))]
        for i in range(FLAG_FRAMES):
            feed(fj, i)
        fj.finish_pending()
        for st_ in stages + [chain]:
            st_.restore()
        k3j.restore()
        ate_j, _ = synthetic.metric_ate(fj.trajectory(scaled=True),
                                        scene["poses"])
        kc = chain.ms
        chains[form] = (sum(kc), len(kc))
        log(f"{tag} [{form} fold, stages timed, eager form] keyframes "
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
    names = ("frame", "complete", "redispatch", "dev.frame", "dev.chain")
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
            # as bench.py and the slice do: the rungs' graphs captured
            # before the window
            fs.prewarm()
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
                f"{100 * busy[depth][-1]:.1f}%; telemetry series over "
                f"the fps window (dev.*: device stamps): " + ", ".join(
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
    zero_launches(wrappers)
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
    g = fs.fused_graph
    log(f"{tag} (a) the node's fused frame graphs (an export consumer "
        f"attached: the dying keyframes' energy columns and points ride "
        f"the readback): keyframe chains in replays {dict(g.chains)}, "
        f"eager chains by reason {dict(g.eager)} (budget "
        f"{g.eager['budget']}, export {g.eager['export']})")
    if chain_replays(fs) == 0 or not set(g.eager) <= FUSED_EAGER_REASONS:
        raise AssertionError(f"the node ran keyframe chains eagerly: "
                             f"{dict(g.eager)}")
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
        zero_launches(wrappers)
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
    zero_launches(wrappers)
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


def zero_launches(wrappers):
    """Set the launch counters to 0, after crediting them with the runs
    of every conditional node so far (a replay's runs are credited at a
    later read: they belong to the work before)."""
    import torch
    from sos_slam_tpu_torch.ops import control
    torch.cuda.synchronize()
    control.account()
    for w_ in wrappers:
        w_.launches = 0


def frame_replays(fs) -> int:
    """The replays of the fused frame graph (models/fused_graph.py)."""
    return 0 if fs.fused_graph is None else fs.fused_graph.frame.replays


def replay_launched(fs) -> dict:
    """{K1, K2}: the launches of graph replays without a Python call: the
    fused frame graph's replays times the launches captured outside its
    conditional nodes (the frame's pyramid), plus what `control` credited
    from the nodes' runs (every system's: take differences)."""
    from sos_slam_tpu_torch.ops import control
    g = fs.fused_graph
    out = {}
    for c in ("K1", "K2"):
        n = control.CREDITED[c]
        if g is not None:
            n += sum(k * g.per_replay[p][c] for p, k in g.replays.items()
                     if p in g.per_replay)
        out[c] = n
    return out


class WarmUps:
    """The K1-K4 launches of the capture warm-ups of one FullSystem's
    fused frame graphs (`FusedFrameGraph.capture`): a warm-up runs the
    body's plain twins (every loop to its bound, every branch, the chain
    too) and its launches count; the capture after it launches
    nothing."""

    def __init__(self, fs):
        self.n = [0, 0, 0, 0]
        g = fs.fused_graph
        if g is not None:
            g.capture = self._wrap(g.capture)

    def _wrap(self, capture):
        counters = kernel_counters()

        def counted(*a, **kw):
            before = [fn.launches for _, fn, _ in counters]
            out = capture(*a, **kw)
            self.n = [n + fn.launches - b for n, (_, fn, _), b
                      in zip(self.n, counters, before)]
            return out
        return counted


def timed_prewarm(torch, fs, wrappers, callers=()):
    """fs.prewarm() as bench.py calls it, the card synchronized around it:
    its wall ms, its launches by kernel (taken off the launch counters and
    the callers' call counts, which then count frames alone), the ms of
    its two fallback tracks (5 wide, 78 wide) and of its dummy frame
    dispatch at each rung (stage-timed)."""
    from sos_slam_tpu_torch.ops import control
    from sos_slam_tpu_torch.ops import tracker as TK
    # the frames in flight are frames: their completions count as such
    fs.finish_pending()
    launches = [w_.launches for w_ in wrappers]
    calls = [(r.n_calls, r.n_captured) for r in callers]
    replayed, runs = replay_launched(fs), control.CREDITED["runs"]
    setters = control.setter_launches(fs.device)
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
    for r, (n, c) in zip(callers, calls):
        r.n_calls, r.n_captured = n, c
    g = fs.fused_graph
    return dict(ms=ms, launches=launched, tracks=track.ms[:2],
                dispatch=dispatch.ms,
                replayed={c: n - replayed[c]
                          for c, n in replay_launched(fs).items()},
                runs=control.CREDITED["runs"] - runs,
                setters=control.setter_launches(fs.device) - setters,
                capture_ms=dict(g.capture_ms) if g else {})


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
    the synchronising calls of each add_active_frame call apart: those of
    the frame's own dispatch (`_dispatch_fused`), those of the completions
    the call made (`_complete_fused`: the readback's fetch and the host's
    bookkeeping) and the rest. Returns {frame: dict(dispatch, where (the
    dispatch's calls by file:line), complete, other, redo (frames
    dispatched again after a rung change), captured (a graph captured in
    the call))}; a frame with no fused dispatch (the classic bootstrap)
    is left out."""
    import warnings
    out = {}
    redo = fs.telemetry.timers["redispatch"]
    g = fs.fused_graph
    dispatch, complete = fs._dispatch_fused, fs._complete_fused
    saved = {k: fs.__dict__.get(k) for k in ("_dispatch_fused",
                                             "_complete_fused")}
    box, cur = [[]], {}

    def syncs():
        return [w for w in box[0] if "synchroniz" in str(w.message)]

    def dispatched(img, shell, *a, **kw):
        n0 = len(syncs())
        rec = dispatch(img, shell, *a, **kw)
        new = syncs()[n0:]
        if shell.id == cur["i"] and "dispatch" not in cur:
            cur["dispatch"] = new
        return rec

    def completed(rec):
        n0 = len(syncs())
        try:
            return complete(rec)
        finally:
            cur["complete"] = cur.get("complete", 0) + len(syncs()) - n0

    fs._dispatch_fused, fs._complete_fused = dispatched, completed
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i in frames:
            cur.clear()
            cur["i"] = i
            n_redo = len(redo)
            n_cap = len(g.capture_ms) if g is not None else 0
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                box[0] = got
                feed(i)
            if "dispatch" not in cur:
                continue
            d = cur["dispatch"]
            out[i] = dict(
                dispatch=len(d), complete=cur.get("complete", 0),
                other=len(syncs()) - len(d) - cur.get("complete", 0),
                where=[f"{w.filename.split('/')[-1]}:{w.lineno}" for w in d],
                redo=len(redo) > n_redo,
                captured=g is not None and len(g.capture_ms) > n_cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for k, v in saved.items():     # the methods as they were
            if v is None:
                delattr(fs, k)
            else:
                setattr(fs, k, v)
    return out


def sync_gate(tag, what, got_g, got_e, kf_ids):
    """Log the synchronising calls of the graph form's and the eager
    form's frames (`synced_frames`), split into frames that made a
    keyframe and frames that did not, and raise where a graph-form
    dispatch (not dispatched again, no capture) synchronised at all."""
    clean = sorted(i for i, v in got_g.items()
                   if not (v["redo"] or v["captured"]))
    for name, frames in (("made a keyframe", [i for i in clean
                                              if i in kf_ids]),
                         ("made no keyframe", [i for i in clean
                                               if i not in kf_ids])):
        log(f"{tag} {what}: synchronising calls of the frames that "
            f"{name}, frames {frames}: graph form dispatch "
            + ", ".join(str(got_g[i]["dispatch"]) for i in frames)
            + ", completions in the same call "
            + ", ".join(str(got_g[i]["complete"]) for i in frames)
            + "; eager form dispatch "
            + ", ".join(str(got_e[i]["dispatch"]) if i in got_e else "-"
                        for i in frames)
            + (f"; the eager dispatch's calls, frame {frames[-1]}: "
               f"{got_e[frames[-1]]['where']}" if frames
               and frames[-1] in got_e else ""))
        if not frames:
            raise AssertionError(f"{what}: no clean frame that {name}")
    bad = {i: got_g[i]["where"] for i in clean if got_g[i]["dispatch"]}
    if bad:
        raise AssertionError(f"{what}: the graph form's dispatch "
                             f"synchronised: {bad}")


class Dispatches:
    """The arguments of every dispatch of one FullSystem's fused frame
    graph (`FusedFrameGraph.dispatch`), by frame id (the latest where a
    frame went again), without the dispatch source: a record kept alive
    would keep its pinned readback, and each frame would then allocate
    pinned memory anew (which waits for the card)."""

    def __init__(self, fs):
        self.by_id = {}
        g = fs.fused_graph
        run = g.dispatch
        shells = fs.shells

        def recorded(*a):
            self.by_id[shells[a[8]].id] = a[:3] + (None,) + a[4:]
            return run(*a)
        g.dispatch = recorded
        self.g = g

    def restore(self):
        del self.g.dispatch


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
    """One steady frame without keyframe (`args`: its
    FusedFrameGraph.dispatch arguments), device ms: the copy-in of its
    source record's state and inputs (`_load` and the host inputs'
    staging), the fused frame graph's replay after it (the chain's IF
    node takes its else body: the pool copied, the readback's zeros),
    the record's clones of the state, the pyramid and the next inputs,
    and the frame step's graph alone (a FrameGraph captured on the same
    inputs); the eager early-exit primary track alone, wall ms a call
    (it reads the host every trip). Returns a dict of them."""
    from sos_slam_tpu_torch.models import frame_graph as FG
    from sos_slam_tpu_torch.ops import control
    from sos_slam_tpu_torch.ops import tracker as TK
    g = fs.fused_graph
    (st, inp, prev, _, img, exposure, key, right, shell_idx, block, pot,
     _) = args

    def load():
        g._load(st, inp, prev)
        g._stage(img, exposure, key, right, shell_idx, block)

    def replay():
        load()
        g.graphs[pot].replay()

    got = dict(load=replay_ms(torch, load), both=replay_ms(torch, replay),
               clones=replay_ms(torch, lambda: control.clone(
                   (g.outs[pot]["pyr"], g.state, dict(g.frame.inp),
                    g.chained))))
    need = bool(g.outs[pot]["need"])
    g.last = None            # the buffers hold no record's state now
    fg = FG.FrameGraph(fs)
    fg.step(st, img, inp["T_primary"], inp["T_hyps"], inp, exposure)
    got["step"] = replay_ms(torch, fg.graph.replay)
    s, i = fs.settings, fg.inp

    def eager():
        TK.track_newest_coarse(
            fg.a["pyr"], fg.templates, i["T_primary"][None], i["aff"],
            i["ref_aff"], fg.a["exposures"],
            torch.full((6,), float("nan"), device=fs.device), fs._intr,
            fs.n_levels, coarse_cutoff_th=s.coarse_cutoff_th,
            huber=s.huber_th)

    got["track"] = median([wall_ms(torch, eager) for _ in range(5)])
    got["replay"] = got["both"] - got["load"]
    if need:
        raise AssertionError("graph_forms: the frame made a keyframe")
    return got


def graph_phase(torch, dev, card, mono, flag):
    """Phase [graph]: the fused frame's CUDA graphs (models/fused_graph.py:
    one graph a rung, the retry, the tracker's loops, the keyframe chain
    under need_kf and the BA's loop as conditional nodes) against the
    eager dispatch (cuda_graphs=False). The mono scene's 48
    frames in both forms, in turns, GRAPH_PAIRS times each (the order
    alternating), every run bit for bit the mono slice (keyframes,
    trajectory, the whole window); each prints its steady fps (frames
    WARMUP to PIPE_PROF_FROM - 1), the median frame with and without a
    keyframe chain, the card's busy share, device ms and device ops a
    frame under the profiler over the rest (with K1's launches there, seen
    by the profiler against the counter: `busy_window`), and for the graph
    form the capture ms, the graph pool's bytes, the replays, the keyframe
    chains in them, the eager chains by reason (only `classic`, gated),
    the retries (run inside the graph: the eager step is never called,
    gated) and the LM trips of the primary track a frame;
    K1-K4 launches of each run (the eager form's gated at
    MONO_EAGER_LAUNCHES, the graph form's at the eager form's plus its
    capture warm-ups), GN steps a keyframe, the selection keys' host ms;
    the K2-K4 kernels the profiler sees held to the counters. Then one
    more run of each form counting the synchronising calls of every
    frame's dispatch apart from its completions (`synced_frames`: 0 in
    every graph-form dispatch, keyframe or not, gated; each call named),
    the fused graph's replay, its parts and the eager primary track on
    one steady frame (`graph_forms`), and the flagship's frames in both
    forms, bit for bit, one frame handed an untrapped scale
    (`graph_flagship`)."""
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.ops import control
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
    again = {}          # frames dispatched again after a rung change
    counters = kernel_counters()
    for p in range(GRAPH_PAIRS):
        for graphs in ((False, True), (True, False))[p % 2]:
            gc.collect()
            fs, feed = mono_fs(graphs)
            warm = WarmUps(fs)
            eager_steps = Recorder(fs, "_frame_step", 1)
            torch.cuda.synchronize()
            control.account()       # the runs before count before
            before = [fn.launches for _, fn, _ in counters]
            frame_ms = []
            for i in range(PIPE_PROF_FROM):
                if i == WARMUP:
                    # as bench.py and the slice do, outside the frame
                    # timers, its launches and its warm-ups' taken off
                    warm0 = list(warm.n)
                    timed_prewarm(torch, fs, [fn for _, fn, _ in counters])
                    warm.n = warm0
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
            eager_steps.restore()
            del fs._frame_step          # the instance's method again
            extra = ""
            cg = fs.fused_graph
            if cg is not None:
                g = cg.frame
                trips = fs.telemetry.timers["track.lm_trips"]
                extra = (f"; the fused frame graphs: K1 kernels the "
                         f"profiler saw {k1[0]} in {k1[1]} replays; capture "
                         "ms " + ", ".join(f"rung {k}: {v:.1f}" for k, v
                                           in cg.capture_ms.items())
                         + f", graph pool {cg.pool_bytes} bytes, replays "
                         f"{dict(cg.replays)}, keyframe chains in them "
                         f"{dict(cg.chains)}, eager chains by reason "
                         f"{dict(cg.eager)} (budget {cg.eager['budget']}, "
                         f"export {cg.eager['export']}), retries (inside "
                         f"the graph) {g.retries}, eager frame steps "
                         f"{eager_steps.n_calls}, the state copied in "
                         f"{cg.copy_ins}, the capture warm-ups' launches "
                         f"K1-K4 {warm.n}, K2-K4 kernels the profiler saw "
                         f"{k1[2]} ((seen, counted, inside conditional "
                         f"nodes, shown by control.PROFILED's rule) "
                         f"{k1[4]}), the selection keys' host ms median "
                         f"{median(cg.draw_ms):.3f}; LM trips of the "
                         "primary track a frame, all levels, mean / most "
                         "(telemetry track.lm_trips): "
                         f"{sum(trips) / max(len(trips), 1):.2f} / "
                         f"{max(trips, default=0):.0f}")
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
            # a rung change dispatches again every frame in flight in the
            # graph form, from the first keyframe among them on eagerly:
            # each frame more is one pyramid more (no chain)
            again[graphs] = len(fs.telemetry.timers["redispatch"])
            more = again[True] - again[False] if graphs else 0
            plus = [e + w_ + (more if c == 0 else 0) for c, (e, w_) in
                    enumerate(zip(MONO_EAGER_LAUNCHES, warm.n))]
            if graphs and launched[True][-1] != plus:
                raise AssertionError(
                    f"the graph form launched K1-K4 {launched[True][-1]} "
                    f"times, not the eager form's plus its capture "
                    f"warm-ups' and the {more} frames it dispatched again "
                    f"more {plus}")
            if graphs and eager_steps.n_calls:
                raise AssertionError(
                    f"the graph form stepped {eager_steps.n_calls} frames "
                    "eagerly (a retry or a track outside the graph)")
            if graphs and (cg is None or chain_replays(fs) == 0
                           or not set(cg.eager) <= FUSED_EAGER_REASONS):
                raise AssertionError(
                    "the graph form ran no keyframe chain in a replay, or "
                    f"ran chains eagerly: {dict(cg.eager)}")
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
        f"budget {default_settings().max_opt_iterations}, the bootstrap's "
        "20 and 15, all in the graphs' WHILE node)")
    phase_done("[graph] mono pairs")

    syncs, forms = {}, None
    for graphs in (False, True):
        gc.collect()
        fs, feed = mono_fs(graphs)
        disp = Dispatches(fs) if graphs else None
        for i in range(WARMUP):
            feed(i)
        syncs[graphs] = synced_frames(torch, fs, feed,
                                      range(WARMUP, N_FRAMES))
        fs.finish_pending()
        kf_ids = set(fs.kf_shell_ids)
        if graphs:
            disp.restore()
            steady = max(i for i, v in syncs[True].items()
                         if i not in kf_ids and not v["redo"]
                         and i in disp.by_id)
            forms = graph_forms(torch, fs, disp.by_id[steady])
            del disp
        del fs, feed
    sync_gate(tag, "mono frames dispatched after frame "
              f"{WARMUP - 1}", syncs[True], syncs[False], kf_ids)
    log(f"{tag} one steady frame's inputs (frame {steady}), device ms: "
        f"the fused frame graph's replay {forms['replay']:.4f} (the "
        f"chain's IF node skipped to its else body), of which the frame "
        f"step's own graph {forms['step']:.4f}: the skipped chain, "
        f"chain_tail and the readback's packing "
        f"{1e3 * (forms['replay'] - forms['step']):.1f} us; the record's "
        f"clones of the state, the pyramid and the next inputs "
        f"{1e3 * forms['clones']:.1f} us a frame; a copy-in from another "
        f"record {1e3 * forms['load']:.1f} us; the eager early-exit "
        f"primary track alone {forms['track']:.3f} ms wall a call")
    phase_done("[graph] syncs and forms")
    graph_flagship(torch, dev, card, flag)


def graph_flagship(torch, dev, card, flag):
    """[graph]'s flagship part: the scene's first PIPE_FLAG_FRAMES frames
    in the eager and the graph form (the fused VIO frame's graphs), with
    each run's fps and its keyframe-chain frames' median over frames
    FLAG_WARMUP-(PIPE_FLAG_FRAMES - 1) (each frame synchronised); frame
    FLAG_UNTRAP's dispatch is handed an untrapped scale state in both
    forms (`untrap_once`), so that the next keyframe's chain solves the
    scale from the multi-guess start (`control.cond(trapped)`'s other
    branch; gated: the graph form replays it); then the rest of the
    scene's frames through the same two systems counting the
    synchronising calls of each frame's dispatch (`sync_gate`: 0 in the
    graph form, gated, the eager form's beside it); both forms bit for
    bit at the end."""
    from sos_slam_tpu_torch.models import full_system as FSM
    tag = f"[graph] ({card})"
    name = {False: "eager", True: "graph"}
    scene, calib = flag["scene"], flag["calib"]
    stereo = FSM.StereoCalib(T_lr=scene["T_lr"], calib_right=calib)
    runs, syncs, untrapped = {}, {}, []
    for graphs in (False, True):
        gc.collect()
        fs = FSM.FullSystem(calib, flag["settings"], stereo=stereo,
                            device=dev, cuda_graphs=graphs)
        forced = untrap_once(fs, FLAG_UNTRAP)
        if graphs:
            # whether each replay ran the VIO chain on an untrapped scale
            # (kept on the device: a read here would synchronise)
            step = fs.fused_graph.dispatch

            def recorded(*a):
                got = step(*a)
                untrapped.append(~a[1]["scale_state"][1] & got["need_kf"])
                return got
            fs.fused_graph.dispatch = recorded

        def feed(i, fs=fs):
            fs.add_active_frame(scene["left"][i], timestamp=i * FLAG_DT,
                                frame_id=i, image_right=scene["right"][i],
                                imu_samples=scene["imu"][i])
        frame_ms = []
        for i in range(PIPE_FLAG_FRAMES):
            # synchronised frames, as the flagship phase times them
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feed(i)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        steady = frame_ms[FLAG_WARMUP:]
        f_fps = len(steady) * 1e3 / sum(steady)
        syncs[graphs] = synced_frames(torch, fs, feed,
                                      range(PIPE_FLAG_FRAMES, FLAG_FRAMES))
        fs.finish_pending()
        runs[graphs] = fs
        kf_ms, nonkf = split_by_keyframe(frame_ms, fs.kf_shell_ids,
                                         FLAG_WARMUP)
        cg = fs.fused_graph
        log(f"{tag} flagship frames 0-{PIPE_FLAG_FRAMES - 1}, "
            f"{name[graphs]} form: fps over frames {FLAG_WARMUP}-"
            f"{PIPE_FLAG_FRAMES - 1} {f_fps:.2f}, frames dispatching a "
            f"keyframe chain there: median {median(kf_ms):.1f} ms ("
            + ", ".join(f"{v:.1f}" for v in kf_ms) + "), the others: "
            f"median {median(nonkf):.1f} ms"
            + (f"; the fused frame graphs (frames 0-{FLAG_FRAMES - 1}): "
               f"capture ms " + ", ".join(f"rung {k}: {v:.1f}" for k, v
                                          in cg.capture_ms.items())
               + f", graph pool {cg.pool_bytes} bytes, replays "
               f"{dict(cg.replays)}, keyframe chains in them "
               f"{dict(cg.chains)}, retries {cg.frame.retries}, eager "
               f"chains by reason {dict(cg.eager)}" if cg is not None
               else ""))
    a, b = runs[False], runs[True]
    del b.fused_graph.dispatch       # the instance's methods again
    del a._dispatch_fused, b._dispatch_fused
    same = (a.kf_shell_ids == b.kf_shell_ids
            and np.array_equal(a.trajectory(), b.trajectory())
            and np.array_equal(a.trajectory(scaled=True),
                               b.trajectory(scaled=True))
            and all(bits_equal(x, y) for x, y in zip(a.ba, b.ba))
            and all(bits_equal(x, y) for x, y in zip(a.imm, b.imm))
            and all(bits_equal(x, y) for x, y in zip(a.imu, b.imu))
            and a.current_scale == b.current_scale
            and np.array_equal(a._last_bg, b._last_bg))
    n_untrapped = int(sum(int(u) for u in untrapped))
    log(f"{tag} flagship: keyframe {forced} (the first from frame "
        f"{FLAG_UNTRAP} on) handed an untrapped scale state: "
        f"{n_untrapped} VIO chain replays solved from "
        f"the multi-guess start (of {len(untrapped)} replays), eager "
        f"chains by reason {dict(b.fused_graph.eager)}; keyframes "
        f"{b.kf_shell_ids}, "
        f"scale {b.current_scale:.6f}, graph form bit for bit the eager "
        f"form (both trajectories, every tensor of the window, the immature "
        f"pool and the IMU state, the scale, the gyro bias; frames "
        f"0-{FLAG_FRAMES - 1}): {same}")
    if not same:
        raise AssertionError("the flagship's graph form is not bit for bit "
                             "its eager form")
    if n_untrapped == 0:
        raise AssertionError("no VIO chain replay solved an untrapped scale")
    if b.fused_graph.frame.replays == 0 or chain_replays(b) == 0 \
            or not set(b.fused_graph.eager) <= FUSED_EAGER_REASONS:
        raise AssertionError("the flagship's graph form replayed no frame "
                             "or no VIO chain, or ran chains eagerly: "
                             f"{dict(b.fused_graph.eager)}")
    kf_ids = set(b.kf_shell_ids)
    del runs, a, b, fs
    sync_gate(tag, f"flagship VIO frames {PIPE_FLAG_FRAMES}-"
              f"{FLAG_FRAMES - 1}", syncs[True], syncs[False], kf_ids)


def control_phase(torch, dev, card, node_runs, setters):
    """Phase [control]: the conditional graph nodes of ops/control.py
    (csrc/graph_cond.cu) alone, as scripts/torch_graph_probe.py runs them:
    each case (an IF taken and skipped, an IF with an else, nested IFs, a
    WHILE of no trip, of three and to its cap, the launch counters
    credited from the run counts and the setter launches counted on the
    device) captured, replayed and held bit for bit to its eager form and
    its plain twin (gated); the device us of a
    skipped IF node, of a node of one tiny kernel and of a WHILE trip of
    one tiny kernel; and the plain twin of the skipped IF (its branch run
    and selected on the device) in a graph of the same shape; what
    torch.profiler reports of the kernels in a WHILE body and in IF
    bodies against control.PROFILED's rule (`profiler_view`; logged, not
    gated: late in this process the profiler loses such records, which is
    why `busy_window` holds the rule only in the first window of the graph
    form). Returns the kernels line's entry of graph_cond (`launches`: the
    setter kernels run on the mono slice, `setters`; `bodies_run`: the
    bodies its nodes ran, `node_runs`)."""
    import importlib.util
    import os
    from sos_slam_tpu_torch.ops import control
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "torch_graph_probe.py")
    spec = importlib.util.spec_from_file_location("torch_graph_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    tag = f"[control] ({card})"
    log(f"{tag} driver CUDA {control.driver_version()}, torch "
        f"{torch.__version__} (CUDA {torch.version.cuda})")
    bad = []
    for name, ok, detail in probe.control_cases(dev):
        log(f"{tag} {name}: bit for bit its eager form and plain twin "
            f"{ok} ({detail})")
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"conditional node cases off their eager "
                             f"form: {bad}")
    us = probe.node_costs(dev)
    view = probe.profiler_view(dev)
    log(f"{tag} what torch.profiler reports of kernels inside conditional "
        f"nodes, late in this process (K1 launches: seen, by "
        f"control.PROFILED's rule): " + "; ".join(
            f"{k}: {v[0]}, {v[1]}" for k, v in view.items()))
    n = 500
    x = torch.zeros(16, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)

    def plain_if():
        for _ in range(n):
            x.copy_(torch.where(off, x + 1.0, x))

    g = probe._captured(dev, plain_if)
    plain_us = 1e3 * replay_ms(torch, g.replay, n=10) / n
    log(f"{tag} device us, 10 replays of a graph under CUDA events: a "
        f"skipped IF node {us['skipped IF node']:.3f}, its plain twin "
        f"(branch run and selected) {plain_us:.3f}, a node of one tiny "
        f"kernel {us['tiny kernel node']:.3f}, a WHILE trip of one tiny "
        f"kernel {us['WHILE trip of one tiny kernel']:.3f}")
    # a setter reads one flag, writes one counter (and the trip count) and
    # adds one to the count of setter launches
    b_ms, b_by = bound(1 + 8 + 8, 0)
    return dict(name="graph_cond (conditional graph nodes: a skipped IF "
                     "node)", route="cuda",
                source="sos_slam_tpu_torch/csrc/graph_cond.cu",
                replaces="sos_slam_tpu/models/full_system.py:2656 "
                         "(lax.cond; no Pallas kernel)",
                launches=setters, bodies_run=node_runs, max_abs_err=0.0,
                ms=us["skipped IF node"] / 1e3, plain_ms=plain_us / 1e3,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                while_trip_ms=us["WHILE trip of one tiny kernel"] / 1e3,
                kernel_node_ms=us["tiny kernel node"] / 1e3)


def untrap_once(fs, first_id):
    """Hand the dispatch of frame `first_id` (and any dispatch of it
    again) an untrapped scale state, which the frames after it chain on
    until a keyframe's chain solves the scale from the multi-guess start:
    the same intervention in either form. Returns the list that gets the
    frame's id once it is dispatched."""
    import torch
    dispatch = fs._dispatch_fused
    hit = []

    def untrapped(img, shell, exposure, chain, right=None):
        if shell.id == first_id:
            hit[:1] = [shell.id]
            if chain is None:
                fs.scale_trapped = False
            else:
                s_, t_, f_ = chain["nxt"]["scale_state"]
                chain = dict(chain, nxt=dict(
                    chain["nxt"], scale_state=(s_, torch.zeros_like(t_),
                                               f_)))
        return dispatch(img, shell, exposure, chain, right)
    fs._dispatch_fused = untrapped
    return hit


def run(torch):
    from sos_slam_tpu_torch.models import full_system as FSM
    from sos_slam_tpu_torch.models import initializer as INIT
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import control
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
    if "--flagship" in sys.argv[1:]:
        # the flagship scene's phases alone (a quicker check while the VIO
        # path changes; no result line)
        cuda_build.build_all()
        kernels = [dict(max_abs_err=0.0) for _ in range(4)]
        flag = flagship(torch, dev, card, kernels)
        phase_done("flagship scene")
        graph_flagship(torch, dev, card, flag)
        phase_done("[graph] flagship")
        return

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
               Recorder(WIN, "build_track_template", 1),
               Recorder(IMG, "build_pyramid", 1)]      # the frame graph's
    zero_launches(wrappers)
    fs = FullSystem(calib, settings, device=dev)
    control.account()
    rep0, runs0 = replay_launched(fs), control.CREDITED["runs"]
    setters0 = control.setter_launches(dev)
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
    # the graphs' replays launch without a Python call; a call while a
    # graph is captured launches nothing (prewarm's are not counted)
    rep = {c: replay_launched(fs)[c] - rep0[c] - (pw["replayed"][c]
                                                   if pw else 0)
           for c in ("K1", "K2")}
    n_pyramids = callers[0].n_launched + callers[1].n_launched \
        + callers[3].n_launched + rep["K1"]
    n_templates = callers[2].n_launched + rep["K2"]
    node_runs = control.CREDITED["runs"] - runs0 - (pw["runs"] if pw else 0)
    setters = control.setter_launches(dev) - setters0 \
        - (pw["setters"] if pw else 0)
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
        f"the slice's counts), rungs {warm}; the fused frame graphs "
        f"captured by then, ms each (warm-up and capture): "
        + ", ".join(f"rung {k}: {v:.1f}" for k, v in
                    pw["capture_ms"].items()))
    cg = fs.fused_graph
    log(f"[slice] the fused frame graphs (models/fused_graph.py): replays "
        f"(frames by rung) {dict(cg.replays)}, keyframe chains in them "
        f"{dict(cg.chains)}, eager chains by reason {dict(cg.eager)} "
        f"(budget {cg.eager['budget']}, export {cg.eager['export']}), "
        f"private pool {cg.pool_bytes} bytes, the state copied in "
        f"{cg.copy_ins} times, GN steps a keyframe (n_its), keyframes by "
        f"count {dict(sorted(fs.kf_n_its.items()))}, the selection keys' "
        f"host ms a frame: median {median(cg.draw_ms):.3f}, most "
        f"{max(cg.draw_ms):.3f}")
    if not set(cg.eager) <= FUSED_EAGER_REASONS:
        raise AssertionError(f"the slice ran keyframe chains eagerly: "
                             f"{dict(cg.eager)}")
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
        f"launches; the graphs' conditional nodes ran {node_runs} bodies "
        f"(branches taken and loop trips) after {setters} launches of their "
        "setter kernels (csrc/graph_cond.cu)")
    if node_runs <= 0 or setters <= 0:
        raise AssertionError("no conditional graph node ran on the main "
                             "path")
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
    # the first window of the graph form: held exactly
    profile_frames(torch, fs, lambda i: fs.add_active_frame(
        imgs[i], timestamp=i * 0.05, frame_id=i), N_FRAMES, PROF_FRAMES,
        exact=True)
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
    graph_cond = control_phase(torch, dev, card, node_runs, setters)
    phase_done("[control] phase")
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
    log(json.dumps({"kernels": kernels + [graph_cond]}))
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
