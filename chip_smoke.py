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
     `good`: exact);
  4. the slice: the full bench main scene (48 frames, twist
     (0.03, 0.012, 0.02, 0.002, 0.004, 0.001), plane_z 2.0) through the
     port's FullSystem on the card, with every launch counter set to 0
     just before and read just after; initialized, not lost, and the
     scale-aligned ATE <= 0.05 * path + 0.02, as bench.py gates it;
  5. the breakdown: 8 more frames through the same FullSystem under
     torch.profiler (the card's busy share and its top device ops);
  6. kernel times on the inputs of step 3 (after the slice, so that the
     profiler cannot slow the slice): the card's time per call from
     torch.profiler over 30 calls after warm-up, and the CUDA-event wall
     time, beside the plain twin's and the bound worked out from the
     bytes and operations; then the launch counts and the kernels line
     (one JSON object);
  7. last line: {"ok": true, "device": {...}}.

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

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # fp32 without tensor cores, data sheet
W, H, N_FRAMES, WARMUP = 640, 480, 48, 26
PROF_FRAMES = 8   # frames after the slice run under the profiler
TWIST = (0.03, 0.012, 0.02, 0.002, 0.004, 0.001)
TOL = 2e-4
REPS = 30
JAX_REFERENCE = "JAX package on the same scene: 22 keyframes, ATE 0.0103 m " \
                "over 1.786 m (BENCH_r05.json, not asserted)"


def log(msg):
    print(msg, flush=True)


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
        setattr(module, name, self)

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, n):
        self.orig.launches = n

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        self.last_of[self.kind(args, kw)] = (args, kw)
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


def time_ms(torch, fn):
    """(device ms, wall ms) of one call of `fn`: the device time is the sum
    of the card's kernel time over REPS calls (torch.profiler, CUPTI) per
    call; the wall time is the median of CUDA events around each call,
    host launch overhead included (the card idles while tiny kernels are
    enqueued)."""
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in device_events(prof))
    if dev_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return dev_us / REPS / 1e3, float(np.median(times))


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


def k3_kind(args, kw):
    """A K3 call's mode: a GN linearization, or a point marginalization
    (use_rz) on a non-empty or an empty set of points."""
    if not kw.get("use_rz", False):
        return "gn"
    return "rz" if bool(kw["pmask"].any()) else "rz-empty"


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
    Pass A, per (point, frame): projection 18; 1/z, pixel, idepth 8;
    d(pixel)/d(idepth) 8; the four FEJ coefficients 16; the 2x10 X rows 34;
    per tap 30 (residual 3, d/dA 1, |g|^2 3, gradient weight 3, weight 2,
    Huber 2, energy 7, weighted rows 6, |J|^2 3) x 8 = 240; the 9 tap sums
    (2 each) x 8 = 144; Hdd, bd, Hcd, JpJd 54; the gram rows Y (10 x 3)
    x 8 = 240; the adjoint stitch of v 272 (host 8x8x2, target 8x8x2, sum
    16): 1034. Pass B2, per (point, frame): 8 taps x the 91 distinct (a, b)
    of a symmetric 13x13 cell x 2 = 1456. Pass B1, per point: v_i HdiF for
    each of D rows, 2 for each of the D(D+1)/2 distinct H_sc entries and
    the D of b_sc, and 6 for the prior and HdiF."""
    return P * F * (1034 + 1456) + P * (D + 2 * (D * (D + 1) // 2 + D) + 6)


def checked(kernels, timings, name, source, replaces, err, kernel_fn,
            plain_fn, nbytes, flops, what, wrapper_fn=None):
    """Record a kernel that matched its plain twin: log its error now,
    queue its timing (run after the slice, so the profiler cannot slow the
    slice down)."""
    log(f"[{name.split()[0]}] {what}: matches its plain twin, "
        f"max_abs_err {err[0]:.3e} ({err[1]:.3f} of the tolerance)")
    b_ms, b_by = bound(nbytes, flops)
    kernels.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, max_abs_err=err[0], bound_ms=b_ms,
                        bound_by=b_by, library_ms=None))
    timings.append((kernel_fn, plain_fn, nbytes, flops, wrapper_fn))


def time_kernels(torch, kernels, timings):
    for k, (kernel_fn, plain_fn, nbytes, flops, wrapper_fn) in zip(
            kernels, timings):
        ms, wall = time_ms(torch, kernel_fn)
        pms, pwall = time_ms(torch, plain_fn)
        k.update(ms=ms, plain_ms=pms)
        log(f"[{k['name'].split()[0]}] device ms kernel {ms:.4f} plain "
            f"{pms:.4f}; wall ms kernel {wall:.4f} plain {pwall:.4f}; bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e6:.2f} MFLOP)")
        if wrapper_fn is not None:
            wms, wwall = time_ms(torch, wrapper_fn)
            log(f"[{k['name'].split()[0]}] whole wrapper (PyTorch side "
                f"included): device ms {wms:.4f}, wall ms {wwall:.4f}")


def profile_frames(torch, fs, imgs, first, n):
    """Where a frame's time goes: n more frames of the scene through the
    same FullSystem under torch.profiler. Logs the wall and device time per
    frame, the card's busy share, its launches per frame and the device
    ops that take the most time. The profiler slows the host, so the busy
    share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    n_kf = fs.stats["n_kf"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + n):
            fs.add_active_frame(imgs[i], timestamp=i * 0.05, frame_id=i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    ev = device_events(prof)
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    log(f"[profile] frames {first}-{first + n - 1} ({fs.stats['n_kf'] - n_kf} "
        f"keyframes), profiler on: wall {wall:.1f} ms/frame, device "
        f"{dev_ms:.2f} ms/frame, card busy {100 * dev_ms / wall:.1f}%, "
        f"{sum(e.count for e in ev) / n:.0f} device ops/frame")
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    log("[profile] top device ops, ms/frame (count/frame): " + "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.3f} "
        f"({e.count / n:.0f})" for e in top))


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


def run(torch):
    from sos_slam_tpu_torch.models import window as WIN
    from sos_slam_tpu_torch.models.full_system import FullSystem
    from sos_slam_tpu_torch.ops import ba_p as BP
    from sos_slam_tpu_torch.ops import image as IMG
    from sos_slam_tpu_torch.utils import cuda_build, synthetic
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
    for name, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}.cu {r['seconds']:.2f} s " + " | ".join(regs[:6]))

    calib = synthetic.default_calib(W, H)
    settings = default_settings()
    imgs, _, poses_t = synthetic.make_sequence(
        calib, N_FRAMES + PROF_FRAMES, TWIST, plane_z=2.0, device=dev)
    poses = poses_t.cpu().numpy().astype(np.float64)

    # ---- 3. kernels against their plain twins ----
    recs = dict(k2=Recorder(WIN, "template_level", 4),
                k3=Recorder(BP, "fused_iteration", 1, kind=k3_kind),
                k4=Recorder(BP, "act_pass", 8))
    # the capture runs until the main path has marginalized a point, so
    # that K3's use_rz mode is checked on the main path's own inputs
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
    kernels, timings = [], []

    # K1: all 4 levels of one 640x480 frame
    levels = []
    cur = imgs[n_pre].contiguous()
    for _ in range(calib.levels):
        levels.append(cur)
        cur = IMG.downsample2x(cur).contiguous()
    err = (0.0, 0.0)
    for lv in levels:
        k, p = IMG.pyramid_level(lv), IMG.pyramid_level_plain(lv)
        err = worse(err, compare("K1", list(zip(k, p)), []))
    px = sum(lv.numel() for lv in levels)
    checked(kernels, timings, "K1 pyramid_level (4 levels of one frame)",
            "sos_slam_tpu_torch/csrc/pyramid.cu",
            "sos_slam_tpu/ops/pallas_kernels.py:92", err,
            lambda: [IMG.pyramid_level(lv) for lv in levels],
            lambda: [IMG.pyramid_level_plain(lv) for lv in levels],
            px * 4 * (1 + 3 + 1 + 0.25), px * 12,
            f"4 levels {W}x{H}..{W >> 3}x{H >> 3}")

    # K2: the 4 template levels of the last keyframe, both diag modes
    calls = [(a[0], a[1], a[2], kw["diag"]) for a, kw in recs["k2"].calls]
    if len(calls) != 4:
        raise AssertionError("K2 capture incomplete")
    err = (0.0, 0.0)
    for idm, wm, color, _ in calls:
        for diag in (False, True):
            ki, kg = WIN.template_level(idm, wm, color, diag)
            pi, pg = WIN.template_level_plain(idm, wm, color, diag)
            err = worse(err, compare("K2", [(ki, pi)], [(kg, pg)]))
    px = sum(a[0].numel() for a in calls)
    checked(kernels, timings, "K2 template_level (4 levels of one keyframe)",
            "sos_slam_tpu_torch/csrc/template.cu",
            "sos_slam_tpu/ops/pallas_kernels.py:171", err,
            lambda: [WIN.template_level(*a) for a in calls],
            lambda: [WIN.template_level_plain(*a) for a in calls],
            px * (3 * 4 + 4 + 1), px * 40, "4 levels x 2 diag modes")

    # K3: the last GN call and the last point marginalization (use_rz on
    # the points it marginalized) of the capture run
    last = recs["k3"].last_of
    if "rz" not in last:
        raise AssertionError(
            f"the {n_pre}-frame capture marginalized no point: K3's use_rz "
            "mode has no main-path input")
    err = (0.0, 0.0)
    for a, kw in (last["gn"], last["rz"]):
        fk = BP.fused_iteration(*a, **kw)
        fp = BP.fused_iteration_plain(*a, **kw)
        prep = BP.k3_prepare(*a, **kw)
        BP.k3_launch(prep)
        cH, cb = BP.fused_cells_plain(*a[:6], pmask=kw.get("pmask"),
                                      use_rz=kw.get("use_rz", False))
        acc = prep["out"]["acc"]
        err = worse(err, compare(
            "K3", [(fk.H_top, fp.H_top), (fk.b_top, fp.b_top),
                   (fk.H_sc, fp.H_sc), (fk.b_sc, fp.b_sc),
                   (fk.sc.Hdd, fp.sc.Hdd), (fk.sc.HdiF, fp.sc.HdiF),
                   (fk.sc.bd, fp.sc.bd), (fk.sc.vcross, fp.sc.vcross),
                   (fk.energy, fp.energy), (fk.energy_raw, fp.energy_raw),
                   (acc[..., :12, 12], cb)],
            [(fk.new_state, fp.new_state), (fk.active, fp.active),
             (fk.sc.has_res, fp.sc.has_res)],
            [(fk.H_top, fp.H_top), (fk.H_sc, fp.H_sc),
             (acc[..., :12, :12], cH)]))
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
            wrapper_fn=lambda a=a, kw=kw: BP.fused_iteration(*a, **kw))

    # K4: one activation pass, clamp off and on
    a4, kw4 = recs["k4"].calls[-1]
    err = (0.0, 0.0)
    for clamp in (False, True):
        kw = dict(kw4, clamp=clamp)
        ok_ = BP.act_pass(*a4, **kw)
        op_ = BP.act_pass_plain(*a4, **kw)
        err = worse(err, compare("K4", [(ok_[0], op_[0])] + list(
            zip(ok_[2:], op_[2:])), [(ok_[1], op_[1])]))
    N4, F4 = a4[0].shape[0], a4[0].shape[1]
    nbytes = 4 * (N4 * F4 * 8 * 6 + N4 * 16 + N4 * F4 * 3 + N4) \
        + 4 * (2 * N4 * F4 + 3 * N4)
    checked(kernels, timings, "K4 act_pass",
            "sos_slam_tpu_torch/csrc/act_pass.cu",
            "sos_slam_tpu/ops/ba_p.py:541", err,
            lambda: BP.act_pass(*a4, **kw4),
            lambda: BP.act_pass_plain(*a4, **kw4), nbytes,
            N4 * F4 * (8 * 20 + 6), f"N={N4} F={F4}, clamp off + on")
    del fs, recs
    torch.cuda.synchronize()

    # ---- 4. the slice, every launch counter from 0 ----
    wrappers = (IMG.pyramid_level, WIN.template_level, BP.fused_iteration,
                BP.act_pass)
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
    if not fs.initialized or fs.is_lost or fs.init_failed:
        raise AssertionError(f"slice failed: initialized={fs.initialized} "
                             f"lost={fs.is_lost} init_failed={fs.init_failed}")
    ate, path = ate_of(fs, poses)
    steady = frame_ms[WARMUP:]
    fps = len(steady) / (sum(steady) / 1e3)
    n_kf = len(fs.kf_shell_ids)
    log(f"[slice] {W}x{H} {N_FRAMES} frames on {kind}: n_kf {n_kf} "
        f"ATE {ate:.4f} m over {path:.3f} m, steady fps {fps:.2f} "
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
    for k, c in zip(kernels, counts):
        k["launches"] = c
    profile_frames(torch, fs, imgs, N_FRAMES, PROF_FRAMES)
    time_kernels(torch, kernels, timings)
    log("kernels: " + ", ".join(f"K{i + 1}={c}" for i, c in enumerate(counts)))
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
