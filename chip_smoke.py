#!/usr/bin/env python3
"""Drive the PyTorch port (sos_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

In order, failing (exit code != 0, no result line) at the first fault:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every CUDA kernel of csrc/ compiled from the checkout (one
     nvcc per source, all at once);
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
     port's FullSystem on the card, with every launch counter set to 0
     just before and read just after; initialized, not lost, and the
     scale-aligned ATE <= 0.05 * path + 0.02, as bench.py gates it; K1
     launched once per pyramid built and K2 once per template built;
  5. the breakdown: 4 more frames through the same FullSystem under
     torch.profiler (the card's busy share and its top device ops);
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
     before every VIO frame marginalization, the scaled trajectory's
     metric ATE (no alignment) <= 0.15 * path + 0.03, K1-K4 each
     launched, K1 once per pyramid built (left and right) and K2 once per
     template; it prints
     the keyframe count, ATE, scale, steady fps over frames 30-43 (as
     bench.py measures it) and the keyframe median; then K3 on a VIO GN
     step and a VIO point marginalization, K4 on an activation pass and K1
     on a right image of this run against their plain twins; the same
     frames through a FullSystem with the JAX package's NaN-prior fold
     (`jax_form=True`) for the keyframe cost of the working VIO BA; and 2
     more frames under torch.profiler;
  6b. the [loop] phase: (a) the flagship scene's frames through the port's
     SlamNode (pinhole camera files, no rectification, loop closure on
     at a 40 m LiDAR range, the loop handler synchronous so that its
     errors propagate), every launch counter from 0: gated on the
     flagship phase's keyframes (loop closure changes no odometry
     result, and `none` rectification hands the frames on unchanged),
     one handler record per marginalized keyframe,
     an odometry edge with a finite dso_error between each consecutive
     pair, at least one scan, poses.txt rows whose metric ATE passes the
     flagship gate, and K1-K4 launched (`launches_node`); (c)
     estimate_direct on the record of (a) with the most points, against
     its own pyramid from 2 cm and 1 deg off, accepted, card = CPU at the
     tracker's tolerances (1e-4 on T, 1e-3 on the residual); (b)
     LoopHandler alone on tests/test_loop_closure_e2e.py's pillar scene,
     synchronously then asynchronously: a loop edge, ICP-verified, the
     drift corrected (rigid-aligned ate_rmse < 0.6 x the odometry's), both
     modes the same poses; (d) optimize_pose_graph at 1000 keyframes on
     tests/test_loop.py's graph: its loop-error gates, first and warm
     wall times;
  7. kernel times on the inputs of step 3 (after the slices, so that the
     profiler cannot slow them), three measures of each kernel: one
     pair of CUDA events around 200 back-to-back launches queued behind a
     sleeping kernel (device time a launch with the queue full, no
     profiler; three times, SM and memory clocks before and after: the
     `ms` of the kernels line is their median), the card's time per call
     from torch.profiler over 30 calls, and the CUDA-event wall time of a
     single call; beside them the plain twin's times and the bound worked
     out from the bytes and operations. For K1, K2 and K3 also each
     launch's device time by kernel name (K1 and K2: one launch a call,
     K3: two), and for the whole wrappers (build_pyramid,
     build_track_template, fused_iteration, act_pass) the device ops a
     call and the host-device copies among them (K3: none allowed);
     then the launch counts of the four runs and the kernels line (one
     JSON object; `launches` counts the mono slice, `launches_flagship`
     the flagship scene, `launches_node` the SlamNode run,
     `launches_snapshot` the resumed half of step 5b);
  8. last line: {"ok": true, "device": {...}}.

Needs one card; exits with code 2 when CUDA is unavailable or the port is
not importable beside this script.
"""

from __future__ import annotations

import collections
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
PROFILE_TRIES = 5  # windows of the profiler before an empty one stands
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
    hidden and the card runs them without a gap. No profiler. Returns
    (the ms of each repeat, clocks before, clocks after)."""
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
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n)
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


def profiled(torch, fn, at_least=1):
    """The device events of REPS calls of `fn` under torch.profiler. The
    profiler may lose the first events of a window, at times all of them:
    a window that shows fewer than `at_least` kinds of device event is
    taken again, PROFILE_TRIES times at most, and the last one is
    returned as it is for the caller to judge."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        ev = device_events(prof)
        if len(ev) >= at_least:
            break
        log(f"[profiler] window {attempt + 1} of {PROFILE_TRIES} showed "
            f"{len(ev)} kind(s) of device event, {at_least} wanted")
    return ev


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
            ev = profiled(torch, kernel_fn, at_least=launches_a_call)
            log(f"{tag} its launches by kernel name, device ms a call "
                "(launches a call): " + "; ".join(
                    f"{e.key.split('(')[0][:40]} "
                    f"{e.self_device_time_total / 1e3 / REPS:.5f} "
                    f"({e.count / REPS:.0f})" for e in ev))
            # the profiler may drop the first events of a window, so a
            # kernel is counted at most, not exactly, REPS times
            if len(ev) != launches_a_call or any(e.count > REPS for e in ev):
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


def profile_frames(torch, fs, feed, first, n, tag="profile"):
    """Where a frame's time goes: n more frames of the scene (`feed(i)`
    hands frame i to the same FullSystem) under torch.profiler. Logs the
    wall and device time per frame, the card's busy share, its launches
    per frame and the device ops that take the most time. The profiler
    slows the host, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    n_kf = fs.stats["n_kf"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + n):
            feed(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    ev = device_events(prof)
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    log(f"[{tag}] frames {first}-{first + n - 1} ({fs.stats['n_kf'] - n_kf} "
        f"keyframes), profiler on: wall {wall:.1f} ms/frame, device "
        f"{dev_ms:.2f} ms/frame, card busy {100 * dev_ms / wall:.1f}%, "
        f"{sum(e.count for e in ev) / n:.0f} device ops/frame")
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
    frame_ms, kf_ms, t_steady = [], [], None
    for i in range(FLAG_FRAMES):
        if i == FLAG_WARMUP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        n_kf = fs.stats["n_kf"]
        t0 = time.perf_counter()
        feed(fs, i)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i >= FLAG_WARMUP and fs.stats["n_kf"] > n_kf:
            kf_ms.append(frame_ms[-1])
        if fs.is_lost or fs.init_failed:
            break
    fs.finish_pending()
    torch.cuda.synchronize()
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
    kf_ids = set(fs.kf_shell_ids)
    nonkf = [frame_ms[i] for i in range(FLAG_WARMUP, len(frame_ms))
             if i not in kf_ids]
    log(f"{tag} {W}x{H} {FLAG_FRAMES} frames, stereo + VIO on {card}: n_kf "
        f"{n_kf}, metric ATE of the scaled trajectory (no alignment) "
        f"{ate:.4f} m over {path:.3f} m, stereo scale {fs.current_scale:.4f}"
        f", IMU scale {float(fs.imu.scale) * IM.SCALE_SCALE:.4f}, steady fps "
        f"{fps:.2f} (frames {FLAG_WARMUP}-{FLAG_FRAMES - 1}, {steady_s:.3f} "
        f"s), keyframe median "
        f"{np.median(kf_ms) if kf_ms else float('nan'):.1f} ms "
        f"({len(kf_ms)} keyframes in the window), non-keyframe median "
        f"{np.median(nonkf) if nonkf else float('nan'):.1f} ms, first "
        f"frame {frame_ms[0]:.0f} ms")
    log(f"{tag} reference: {JAX_FLAGSHIP}")
    log(f"{tag} VIO frame marginalizations by the prior they started from: "
        + (", ".join(f"{k} {v}" for k, v in sorted(mfv.n_of.items()))
           or "none")
        + "; the VIO prior after the run is "
        + ("finite" if bool(torch.isfinite(fs.imu.HM).all()) else "NaN")
        + f"; {n_kf} keyframes, scaled ATE {ate:.4f} m, keyframe median "
        f"{np.median(kf_ms) if kf_ms else float('nan'):.1f} ms with the "
        "working VIO BA")
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
    for name, c in zip(("K1", "K2", "K3", "K4"), counts):
        if c <= 0:
            raise AssertionError(f"{name} was not launched on the flagship "
                                 "path")
    n_right = pyr_l.n_of["right"]
    n_pyr = pyr_l.n_calls + pyr_i.n_calls
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

    # the JAX package's fold (a NaN prior from the first VIO frame
    # marginalization on) over the same frames: what the working VIO BA
    # costs a keyframe and what it changes
    k3j = Recorder(BP, "fused_iteration", 1, kind=k3_caller)
    fj = FSM.FullSystem(calib, settings, stereo=stereo, device=dev,
                        jax_form=True)
    kf_j = []
    for i in range(FLAG_FRAMES):
        n_kf_j = fj.stats["n_kf"]
        t0 = time.perf_counter()
        feed(fj, i)
        torch.cuda.synchronize()
        if i >= FLAG_WARMUP and fj.stats["n_kf"] > n_kf_j:
            kf_j.append((time.perf_counter() - t0) * 1e3)
    k3j.restore()
    ate_j, _ = synthetic.metric_ate(fj.trajectory(scaled=True),
                                    scene["poses"])
    chain = [f.telemetry.report()["timers_ms"]["kf_chain"] for f in (fs, fj)]
    log(f"{tag} the same frames with the JAX package's fold (jax_form=True,"
        f" the prior NaN after the run: "
        f"{not bool(torch.isfinite(fj.imu.HM).all())}): keyframes "
        f"{fj.kf_shell_ids}, scaled ATE {ate_j:.4f} m, scale "
        f"{fj.current_scale:.4f}, keyframe median "
        f"{np.median(kf_j) if kf_j else float('nan'):.1f} ms, kf_chain "
        f"median {chain[1]['median']:.1f} ms (n={chain[1]['n']}), "
        f"{k3j.n_of['gn_step_vio']} VIO GN steps; with the port's fold: "
        f"keyframe median {np.median(kf_ms) if kf_ms else float('nan'):.1f} "
        f"ms, kf_chain median {chain[0]['median']:.1f} ms (n="
        f"{chain[0]['n']}), {k3.n_of['gn_step_vio']} VIO GN steps")
    del fj, k3j, k3
    kf_ids = list(fs.kf_shell_ids)
    profile_frames(torch, fs, lambda i: feed(fs, i), FLAG_FRAMES,
                   FLAG_PROF_FRAMES, tag="flagship profile")
    return dict(kf_ids=kf_ids, scene=scene, calib=calib)


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
    frame_ms, kf_ms = [], []
    for i in range(N_FRAMES):
        n_kf = fs.stats["n_kf"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        frame_ms.append(dt * 1e3)
        if i >= WARMUP and fs.stats["n_kf"] > n_kf:
            kf_ms.append(dt * 1e3)
        if fs.is_lost or fs.init_failed:
            break
    counts = [w_.launches for w_ in wrappers]
    for r in callers:
        r.restore()
    n_pyramids = callers[0].n_calls + callers[1].n_calls
    n_templates = callers[2].n_calls
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
    log(f"[slice] {W}x{H} {N_FRAMES} frames on {kind}: n_kf {n_kf} "
        f"ATE {ate:.4f} m over {path:.3f} m (Sim(3)-aligned ate_rmse "
        f"{sim3['rmse']:.4f} m, scale {sim3['scale']:.4f}), steady fps "
        f"{fps:.2f} "
        f"(frames {WARMUP}-{N_FRAMES - 1}), keyframe median "
        f"{np.median(kf_ms) if kf_ms else float('nan'):.1f} ms, first frame "
        f"{frame_ms[0]:.0f} ms")
    log(f"[slice] reference: {JAX_REFERENCE}")
    rep = fs.telemetry.report()["timers_ms"]
    nonkf = [t for t, i in zip(steady, range(WARMUP, N_FRAMES))
             if not fs.shells[i].is_kf]
    log("[slice] host stage timers (each stage ends in a host read): "
        + ", ".join(f"{k} n={v['n']} median {v['median']:.1f} ms"
                    for k, v in sorted(rep.items()))
        + f"; steady non-keyframe median "
        f"{np.median(nonkf) if nonkf else float('nan'):.1f} ms")
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
    mono = dict(calib=calib, traj=traj, kf_ids=list(fs.kf_shell_ids),
                ba={k: v.clone() for k, v in fs.ba._asdict().items()})
    phase_done("mono slice")
    profile_frames(torch, fs, lambda i: fs.add_active_frame(
        imgs[i], timestamp=i * 0.05, frame_id=i), N_FRAMES, PROF_FRAMES)
    phase_done("mono profile")
    del fs
    snapshot_phase(torch, dev, card, kernels, imgs, mono)
    del mono
    phase_done("[snapshot] phase")
    flag = flagship(torch, dev, card, kernels)
    phase_done("flagship scene")
    loop_phase(torch, dev, card, kernels, flag)
    del flag
    phase_done("loop phase")
    wrapper_stats = time_kernels(torch, kernels, timings)
    phase_done("kernel times")
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
        f"K{i + 1}={k['launches_snapshot']}" for i, k in enumerate(kernels)))
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
