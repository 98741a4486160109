"""The keyframe chain as one device program with its decisions on the
device (port of sos_slam_tpu/models/full_system.py `_kf_chain_jit` with
`_flag_frames_jit`, `_kf_mega_jit`, `_marg_select_jit`,
`_maybe_marg_frame_lean_jit` and `_compact_dI`, and of its VIO twin
`_kf_chain_vio_jit` with `_maybe_marg_frame_vio_lean_jit`), replayed on a
card as CUDA graphs.

`kf_chain_body` is the chain's one definition: the marginalization flags
(`flag_frames`), frame insertion, activation (K4), the windowed BA (K3),
HdiF, the tracker template (K2), point marginalization (K3) with the
new-trace selection (K1 for its gradient pyramid), `MAX_MARG_FRAMES`
frame marginalizations and one image-stack compaction, and with stereo
the scale solve on the fresh template (K1 for the right image's
pyramid). `kf_chain_vio_body` is the VIO chain's: the staged IMU block's
intake and the spline propagation before the activation, the
visual-inertial KKT BA, the stereo scale solve or the scale trapping, the
VIO point and VIO frame marginalizations. Nothing in either reads the
card: the window's slot, the flagged slots (`marg_ks`, descending, padded
with -1), the selection count `n_have` and the per-host dead-point counts
`host_out` stay device tensors, and the host learns them from the frame's
one pinned readback when the frame completes. Its random draws (the
selector's block directions and the density subsample) are the threefry
twin's, made on the device from four keys that the host derives at
dispatch, where it knows the keyframe's key, and copies in; the subsample
is drawn always and applied where the count asks for it.

The JAX chain's control flow is the device's here too (ops/control.py):
the BA's `lax.while_loop` (models/energy.py, its budget from the keyframe
count on the device: `ba_budget`), the scale solve's `lax.cond(trapped,
do_trap, do_multi)` under the right image's presence and its LM loops
(ops/scale_opt.py), and each frame marginalization's `lax.cond(k >= 0,
do, skip)` are conditional graph nodes in a capture, so a replay leaves
the BA at its break, runs one scale branch and skips the folds of padded
slots. The eager chain (`FullSystem._kf_chain` with `cuda_graphs=False`,
on the CPU, or for a classic keyframe) runs the body with the BA's and
the scale LM's early-exit loops, which read their tests on the host; both
give the same bits. The bodies always return what an export consumer
reads at completion (the marginalized points' host, u, v, idepth and the
dying keyframes' energy columns, `_ecols`: zeros unless one is attached,
`_exporting()`), as `_kf_chain_jit`'s run branch does.

On the fused path the chain is the body of the IF node on `need_kf` in
the fused frame's graph (models/fused_graph.py): `skip_outputs` is its
else body, `_kf_chain_jit`'s skip, and `chain_tail` the next frame's
inputs chosen on the device after it. `ChainGraph` captures a chain
alone: it holds the static buffers the body reads (the window `ba`, the
immature pool, the image stack, the activation distance, `host_out`, the
keyframe's pyramid, pose, affine and exposure, the frame's window stats,
the keyframe count, the selection's keys, the right image with
`have_right` and the scale state, and with IMU the IMU state, the staged
sample block and the keyframe's timestamp) and, on a card, one graph per
selector rung (`pot` is static in the JAX chain as it is here), warmed up
on a side stream and captured in "thread_local" mode into one private
pool. A replay overwrites the outputs of the last one, so `step` returns
clones, and adds the K1-K5 launches captured outside the conditional
nodes to the kernels' launch counters (those inside are credited from
the nodes' run counts). A failed capture raises. On the CPU the bodies
run as they are: that is how the tests hold them.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from sos_slam_tpu_torch.models import energy as E
from sos_slam_tpu_torch.models import imu as IM
from sos_slam_tpu_torch.models import window as WIN
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops import selector
from sos_slam_tpu_torch.ops.numerics import at
from sos_slam_tpu_torch.utils import rng

MAX_MARG_FRAMES = 4   # >= (max_frames - min_frames) + 1 for the defaults

# the kernels' launch counters, which a replay adds the launches captured
# outside its conditional nodes to
COUNTERS = control.counters()


def flag_frames(stats, exposure, frame_valid, host_out, n_kf, settings):
    """flagFramesForMarginalization (FullSystemMarginalize.cpp:54-141) on
    the device, the counterpart of `_flag_frames_jit`: the same
    thresholds in f32, the same sequential count gating over the slots,
    and, when the window would overflow, the same drop of the eligible
    frame with the smallest distance score. `stats`: the frame's window
    stats (pt_in, imm_in, aff, T_cw); `host_out` (F,) int; `n_kf` the
    keyframe count (int or 0-dim tensor). Returns (flags (F,) bool,
    marg_ks (MAX_MARG_FRAMES,) int64, the flagged slots descending,
    padded with -1)."""
    s = settings
    pt_in, imm_in, aff, T_cw = stats
    F = pt_in.shape[0]
    dev = pt_in.device
    n = torch.sum(frame_valid)
    newest = B.newest_slot(frame_valid)
    aff_n = at(aff[:, 0], newest)
    exp_n = at(exposure, newest)
    n_in = (pt_in + imm_in).to(torch.float32)
    n_out = host_out.to(torch.float32)
    a_rel = torch.exp(aff_n - aff[:, 0]) * exposure \
        / torch.clamp(exp_n, min=1e-9)
    bad = (n_in < s.min_points_remaining * (n_in + n_out)) \
        | (torch.abs(torch.log(torch.clamp(a_rel, min=1e-9)))
           > s.max_log_aff_fac_in_window)
    idx = torch.arange(F, device=dev)
    live = idx < n
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    flags = []
    for i in range(F):
        c = bad[i] & ((n - cnt) > s.min_frames) & live[i]
        flags.append(c)
        cnt = cnt + c.to(torch.int64)
    flags = torch.stack(flags)

    # distance-score drop when the window would overflow
    need = (n + 1 - cnt) >= s.max_frames
    t = T_cw[:, :3, 3]
    Dm = torch.linalg.norm(t[:, None] - t[None, :], dim=-1)
    tgt_ok = (idx < n - 1)[None, :] & (idx[:, None] != idx[None, :])
    inv_sum = torch.sum(torch.where(tgt_ok, 1.0 / (1e-5 + Dm),
                                    torch.zeros_like(Dm)), 1)
    d_latest = torch.linalg.norm(t - at(t, newest)[None, :], dim=-1)
    score = inv_sum * -torch.sqrt(torch.clamp(d_latest, min=1e-9))
    skip0 = n_kf <= s.max_frames
    eligible = (idx < n - 1) & ~flags & ~((idx == 0) & skip0)
    score = torch.where(eligible, score, torch.full_like(score, 2.0))
    best = torch.argmin(score)
    flags = flags | ((idx == best) & need & (at(score, best) < 1.0))
    marked = torch.where(flags, idx, torch.full_like(idx, -1))
    return flags, torch.topk(marked, MAX_MARG_FRAMES).values


def shift_host_out(ho: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Delete row k of the per-host dead-point counts and append a zero
    (`_shift_host_out`); the counts unchanged where k < 0."""
    F = ho.shape[0]
    idx = torch.arange(F, device=ho.device)
    src = torch.where(idx < k, idx, torch.clamp(idx + 1, max=F - 1))
    shifted = torch.where(idx == F - 1, torch.zeros_like(ho), ho[src])
    return torch.where(k >= 0, shifted, ho)


def _select(do, new, old):
    """`new` where the device bool `do` holds, else `old`, field by field
    of a NamedTuple."""
    return type(old)(*(a if b is a else torch.where(do, b, a)
                       for a, b in zip(old, new)))


def marg_frames(fs, ba, imm, dI, host_out, marg_ks, imu=None):
    """The chain's frame marginalizations in the lean form of
    `_maybe_marg_frame_lean_jit` (with `imu`, of its VIO twin
    `_maybe_marg_frame_vio_lean_jit`): one marginalization for each of
    the MAX_MARG_FRAMES slots `marg_ks` (descending, -1 padded), the freed
    image rows tracked in a slot -> row map `dimap`, then one compaction
    of the image stack (the counterpart of `_compact_dI`: one gather, the
    rows from the live count on zeroed). Each marginalization runs on the
    clamped device slot (a -1 is clamped to slot 0) under
    `control.cond(k >= 0)`, the JAX package's `lax.cond(k >= 0, do,
    skip)`: inside a capture a conditional node that a padded slot skips,
    elsewhere its plain twin. It writes the window, the pool and the IMU
    state into copies of their own made before the first, which reads
    nothing back; `dimap` and `host_out` are kept by device arithmetic.
    With an export consumer attached, also each slot's energy column on
    the state before its fold, its image read through `dimap` (the
    entries of padded slots are not used). Returns (ba, imm, imu, dI,
    host_out, [(e_col, n_col)])."""
    F = ba.F
    idx = torch.arange(F, device=dI.device)
    dimap = idx
    exporting = fs._exporting()
    ecols = []
    # a skipped fold writes nothing: the folds write into states of their
    # own
    state = (control.clone(ba), control.clone(imm)) + (() if imu is None
                                         else (control.clone(imu),))
    for j in range(MAX_MARG_FRAMES):
        k = marg_ks[j]
        do = k >= 0
        kc = torch.clamp(k, min=0)
        if exporting:
            ecols.append(B.col_energy(state[0], dI, kc, fs.settings, fs.w,
                                      fs.h, row=at(dimap, kc)))

        def fold(kc=kc):
            ba2, imm2, imu2 = fs._marg_frame(state[0], state[1],
                                             state[2] if imu is not None
                                             else None, kc)
            return (ba2, imm2) + (() if imu is None else (imu2,))

        control.cond(do, fold, None, out=state)
        src = torch.clamp(torch.where(idx < kc, idx, idx + 1), max=F - 1)
        dimap = torch.where(do, torch.where(idx == F - 1, at(dimap, kc),
                                            dimap[src]), dimap)
        host_out = shift_host_out(host_out, k)
    ba, imm = state[:2]
    imu = state[2] if imu is not None else None
    live = idx < torch.sum(ba.frame_valid)
    dI = torch.where(live[:, None, None, None], dI[dimap],
                     torch.zeros_like(dI))
    return ba, imm, imu, dI, host_out, ecols


def selection_keys(key) -> np.ndarray:
    """The keys of one keyframe's new-trace selection under `key`, made on
    the host (four threefry hashes): the selector's three tiers
    (rng.split(key, 3)) and the density subsample (rng.fold_in(key, 99)),
    as (4, 2) int64 words."""
    return np.concatenate([rng.split(key, 3),
                           rng.fold_in(key, 99)[None]]).astype(np.int64)


def selection_draws(keys, h: int, w: int, pot: int):
    """The selection's random draws on the device of `keys`
    (`selection_keys` there): the three tiers' block directions of
    `selector.select` and the (h, w) density subsample, bit for bit the
    host threefry twin's."""
    return selector.select_draws(keys, h, w, pot) + [
        rng.uniform_device(keys[3], (h, w))]


def ba_budget(n_kf, settings):
    """The keyframe's BA budget from the keyframe count before it
    (`_kf_chain_jit`'s `where(n_kf + 1 < 3, 20, where(n_kf + 1 < 4, 15,
    max_its))`, FullSystem._max_its): a device int where `n_kf` is a device
    tensor (the bounded BA's loop then tests it on the device), else a host
    int."""
    m = settings.max_opt_iterations
    boot, mid = E.BOOT_ITS
    if not torch.is_tensor(n_kf):
        return boot if n_kf + 1 < 3 else mid if n_kf + 1 < 4 else m
    return torch.where(n_kf + 1 < 3, torch.full_like(n_kf, boot),
                       torch.where(n_kf + 1 < 4, torch.full_like(n_kf, mid),
                                   torch.full_like(n_kf, m)))


def _ecols(ecols, dev):
    """The dying keyframes' energy columns as (MAX_MARG_FRAMES, 2) f32
    rows (energy, count), `_kf_chain_jit`'s `jnp.stack(ecols)`: zeros
    where no export consumer made them."""
    if not ecols:
        return torch.zeros(MAX_MARG_FRAMES, 2, device=dev)
    return torch.stack([torch.stack([e, n.to(e.dtype)]) for e, n in ecols])


def kf_chain_body(fs, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                  host_out, n_kf, keys, pot: int, max_its,
                  bounded: bool, kf: dict):
    """The vision keyframe chain (`_kf_chain_jit`'s run branch) on the
    state `st` (ba, dI, min_act) and the traced pool `imm`: the flags, the
    frame's insertion with its image, the activation, the BA, the
    template, point marginalization + selection, the frame
    marginalizations, and with stereo the scale solve. `pyr` is the new
    keyframe's pyramid, `T_cw_new` / `aff_new` / `exposure` its pose,
    affine and exposure, `stats` the frame's window stats, `host_out` (F,)
    device ints, `n_kf` the keyframe count before it, `keys` the
    selection's keys on the device (`selection_keys`), `pot` the selector
    rung, `max_its` the BA budget (None: `ba_budget` of `n_kf`, on the
    device for a device `n_kf`), `kf` the keyframe's other inputs
    (`keyframe_inputs`: the right image and the scale state). `bounded`:
    the BA's and the scale solve's bounded forms (module docstring), with
    which it reads nothing back. Returns a dict of device values: state
    (the entries of `st` it replaces), ba_stats, T_cw_all_t, affs_t, slot,
    marg_ks, n_have, host_out, scale_out, and for the host's completion
    imm_pre_select, marg, marg_pts (host, u, v, idepth) and ecols
    (`_ecols`)."""
    s = fs.settings
    if max_its is None:
        max_its = ba_budget(n_kf, s)
    ba, dI = st["ba"], st["dI"].clone()
    F = ba.F
    slot = torch.sum(ba.frame_valid)
    flags, marg_ks = flag_frames(stats, ba.exposure, ba.frame_valid,
                                 host_out, n_kf, s)
    ba = WIN.insert_frame(ba, T_cw_new, aff_new, exposure,
                          fs._prior_row(first=False))
    # an overflowing window (slot F) raises at completion; never write
    # past the stack
    dI.index_copy_(0, torch.clamp(slot, max=F - 1).reshape(1), pyr[0][None])
    ba, imm, min_act = fs._activate(ba, imm, dI, st["min_act"])
    ba, ba_stats = E.optimize(ba, dI, s, fs.w, fs.h, max_its=max_its,
                              min_its=s.min_opt_iterations, bounded=bounded)
    HdiF = ba_stats["HdiF"]
    templates, pc_l0 = WIN.build_track_template(
        ba, HdiF, pyr, len(pyr), fs.tmpl_sizes, fs.w, fs.h)
    scale_out = fs._scale_solve(templates, kf, bounded)
    T_cw_all = B.state_to_pose(ba.T_cw_eval, ba.state)
    affs = B.aff_real(ba.state)
    imm_pre_select = imm
    marg_pts = (ba.host, ba.u, ba.v, ba.idepth)   # loop-cache source
    ba, marg, died = fs._marg_points(ba, dI, HdiF, flags)
    imm, n_have = fs._select_insert(imm, pyr[0], slot, None, pot,
                                    keys=keys)
    host_out = host_out + died
    ba, imm, _, dI, host_out, ecols = marg_frames(fs, ba, imm, dI, host_out,
                                                  marg_ks)
    return dict(
        state=dict(ba=ba, imm=imm, dI=dI, min_act=min_act, HdiF=HdiF,
                   templates=templates, pc_l0=pc_l0),
        ba_stats=ba_stats, T_cw_all_t=T_cw_all, affs_t=affs, slot=slot,
        marg_ks=marg_ks, n_have=n_have, host_out=host_out,
        scale_out=scale_out, imm_pre_select=imm_pre_select, marg=marg,
        marg_pts=marg_pts, ecols=_ecols(ecols, dI.device))


def kf_chain_vio_body(fs, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                      host_out, n_kf, keys, pot: int, max_its,
                      bounded: bool, kf: dict):
    """The VIO keyframe chain (`_kf_chain_vio_jit`'s run branch), as
    `kf_chain_body` with the IMU state `st["imu"]`: `vio_head` (the flags,
    the insertion, the IMU intake, the spline propagation, the
    activation), the visual-inertial KKT BA (K3), the template (K2), the
    scale (with stereo the solve on the right image's pyramid, K1; else
    the trapping queue, selected by whether the scale was trapped) and
    `vio_tail` (the VIO point marginalization, the selection, the masked
    VIO frame marginalizations with the compaction, the gyro bias of the
    newest slot). `kf` adds the staged IMU block (acc, gyro, ts, valid)
    and the keyframe's timestamp, both on the device. Returns
    `kf_chain_body`'s dict with the IMU state in `state` and `bg`."""
    s = fs.settings
    if max_its is None:
        max_its = ba_budget(n_kf, s)
    hd = vio_head(fs, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                  host_out, n_kf, kf)
    ba, imu, ba_stats = E.optimize_vio(hd["ba"], hd["imu"], hd["dI"], s,
                                       fs.w, fs.h, max_its=max_its,
                                       min_its=s.min_opt_iterations,
                                       bounded=bounded)
    HdiF = ba_stats["HdiF"]
    templates, pc_l0 = WIN.build_track_template(
        ba, HdiF, pyr, len(pyr), fs.tmpl_sizes, fs.w, fs.h)
    T_cw_all = B.state_to_pose(ba.T_cw_eval, ba.state)
    affs = B.aff_real(ba.state)

    # scale: the stereo solve in the chain, or the mono trapping queue
    if fs._stereo_solve():
        scale_out = fs._scale_solve(templates, kf, bounded)
        imu = imu._replace(scale=scale_out[0] / IM.SCALE_SCALE,
                           scale_trapped=torch.ones_like(imu.scale_trapped))
    else:
        was = imu.scale_trapped
        trap = IM.try_trap_scale(imu, s.scale_trap_thres)
        newly = trap.scale_trapped & ~was
        trap = trap._replace(state_zero=torch.where(newly, trap.state,
                                                    trap.state_zero))
        imu = _select(was, imu, trap)
        scale_out = (imu.scale * IM.SCALE_SCALE, imu.scale_trapped,
                     torch.zeros_like(kf["scale_state"][2]),
                     torch.full_like(imu.scale, -1.0))
    tl = vio_tail(fs, hd, ba, imu, HdiF, pyr, pot, keys)
    return dict(
        state=dict(ba=tl["ba"], imu=tl["imu"], imm=tl["imm"], dI=tl["dI"],
                   min_act=hd["min_act"], HdiF=HdiF, templates=templates,
                   pc_l0=pc_l0),
        ba_stats=ba_stats, T_cw_all_t=T_cw_all, affs_t=affs,
        slot=hd["slot"], marg_ks=hd["marg_ks"], n_have=tl["n_have"],
        host_out=tl["host_out"], scale_out=scale_out, bg=tl["bg"],
        imm_pre_select=hd["imm"], marg=tl["marg"], marg_pts=tl["marg_pts"],
        ecols=_ecols(tl["ecols"], tl["dI"].device))


def vio_head(fs, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
             host_out, n_kf, kf: dict) -> dict:
    """The VIO chain before its BA: the flags, the insertion with the
    image, the staged IMU block's intake with the spline validity on the
    device (>3 samples, a bounded gap to the previous window keyframe),
    the spline propagation and the activation (K4). Returns dict(ba, imu,
    imm, dI, min_act, slot, flags, marg_ks, host_out)."""
    s = fs.settings
    ba, imu, dI = st["ba"], st["imu"], st["dI"].clone()
    F = ba.F
    slot = torch.sum(ba.frame_valid)
    flags, marg_ks = flag_frames(stats, ba.exposure, ba.frame_valid,
                                 host_out, n_kf, s)
    ba = WIN.insert_frame(ba, T_cw_new, aff_new, exposure,
                          fs._prior_row(first=False))
    dI.index_copy_(0, torch.clamp(slot, max=F - 1).reshape(1), pyr[0][None])
    acc, gyro, ts, valid = kf["staged"]
    timestamp = kf["timestamp"]
    prev = torch.clamp(slot - 1, min=0)
    dt_kf = timestamp - at(imu.timestamps, prev)
    sv = (torch.sum(valid) > 3) & (dt_kf < s.max_imu_interval)
    imu = fs._set_imu(imu, slot, acc, gyro, ts, valid, timestamp, sv)
    # spline propagation for the incoming KF (HessianBlocks.cpp:357); an
    # overflowing window's slot F (a warm-up's both branches) is clamped
    T_all = B.state_to_pose(ba.T_cw_eval, ba.state)
    last_bias = (at(imu.state, prev) * IM._s21(imu.state))[:6]
    imu = IM.propagate_imu_state(imu, torch.clamp(slot, max=F - 1),
                                 at(imu.timestamps, prev),
                                 at(imu.vel, prev), at(T_all, prev)[:3, :3],
                                 last_bias, s)
    ba, imm, min_act = fs._activate(ba, imm, dI, st["min_act"])
    return dict(ba=ba, imu=imu, imm=imm, dI=dI, min_act=min_act, slot=slot,
                flags=flags, marg_ks=marg_ks, host_out=host_out)


def vio_tail(fs, hd: dict, ba, imu, HdiF, pyr, pot: int, keys) -> dict:
    """The VIO chain after its scale: the VIO point marginalization (K3,
    use_rz) and the point drop, the selection (K1) into the pool of
    `vio_head`'s `hd`, the masked VIO frame marginalizations with the
    image stack's compaction, and the newest slot's gyro bias. Returns
    dict(ba, imu, imm, dI, n_have, host_out, bg, marg, marg_pts,
    ecols)."""
    s = fs.settings
    marg, drop, died = fs._flag_points(ba, HdiF, hd["flags"])
    marg_pts = (ba.host, ba.u, ba.v, ba.idepth)
    ba, imu = E.marginalize_points_vio(ba, imu, hd["dI"], marg, s, fs.w,
                                       fs.h)
    ba = E.drop_points(ba, drop)
    imm, n_have = fs._select_insert(hd["imm"], pyr[0], hd["slot"], None, pot,
                                    keys=keys)
    ba, imm, imu, dI, host_out, ecols = marg_frames(
        fs, ba, imm, hd["dI"], hd["host_out"] + died, hd["marg_ks"], imu=imu)
    newest = B.newest_slot(ba.frame_valid)
    bg = (at(imu.state, newest) * IM._s21(imu.state))[3:6]
    return dict(ba=ba, imu=imu, imm=imm, dI=dI, n_have=n_have,
                host_out=host_out, bg=bg, marg=marg, marg_pts=marg_pts,
                ecols=ecols)


def skip_outputs(fs, st, imm, host_out, scale_state) -> dict:
    """`_kf_chain_jit`'s skip branch (sos_slam_tpu/models/full_system.py:
    2177-2195; the VIO chain's :2363-2377), with a chain body's dict
    structure: the state `st` passes through with the traced pool `imm`,
    `host_out` and the scale state too, and the readback takes JAX's
    zeros and -1s; with IMU also the newest slot's gyro bias."""
    ba = st["ba"]
    F, P = ba.F, ba.P
    dev = ba.state.device

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    out = dict(
        state=dict(st, imm=imm),
        ba_stats=dict(energy=z(), rmse=z(), n_its=z(dtype=torch.int32),
                      n_active=z(dtype=torch.int64),
                      is_lost=z(dtype=torch.bool)),
        T_cw_all_t=z(F, 4, 4), affs_t=z(F, 2), slot=torch.sum(ba.frame_valid),
        marg_ks=torch.full((MAX_MARG_FRAMES,), -1, dtype=torch.int64,
                           device=dev),
        n_have=z(dtype=torch.int64), host_out=host_out,
        scale_out=tuple(scale_state) + (torch.full_like(scale_state[0],
                                                        -1.0),),
        ecols=z(MAX_MARG_FRAMES, 2), marg=z(P, dtype=torch.bool),
        marg_pts=(z(P, dtype=torch.int32), z(P), z(P), z(P)))
    if st.get("imu") is not None:
        imu = st["imu"]
        newest = torch.clamp(torch.sum(ba.frame_valid) - 1, min=0)
        out["bg"] = (at(imu.state, newest) * IM._s21(imu.state))[3:6]
    return out


def chain_tail(need_kf, res, inp, T_cw_new, aff_new, res0, accept, exposure,
               settings, shell_idx=None) -> dict:
    """The next frame's chained inputs, `_kf_chain_jit`'s `nxt`
    (sos_slam_tpu/models/full_system.py:2199-2238; the VIO chain's
    :2384-2420), each chosen by the device bool `need_kf`: from the
    keyframe's post-BA pose and affine at its slot (the previous frame's
    pose from the slot before it where that frame was a keyframe too), or
    from this frame's pose and the tracking reference it had. `res`: a
    chain body's dict or `skip_outputs`'; `inp`: this frame's chained
    inputs (T_cw_ref, ref_aff, ref_exp, T_cw_prev, rms0, first_rmse, n_kf,
    prev_was_kf, n_frames, with IMU last_kf: the shell index of the last
    keyframe, whose IMU samples later frames leave out); `shell_idx` this
    frame's. Slot indices are clamped: a warm-up runs a frame that makes
    no keyframe through the chain too, on a window that may be full."""
    from sos_slam_tpu_torch.models import frame_graph as FG
    T_all, slot = res["T_cw_all_t"], res["slot"]
    F = T_all.shape[0]
    sc = torch.clamp(slot, max=F - 1)
    T_kf, aff_kf = at(T_all, sc), at(res["affs_t"], sc)
    T_me = torch.where(need_kf, T_kf, T_cw_new)
    T_ref = torch.where(need_kf, T_kf, inp["T_cw_ref"])
    T_prev = torch.where(need_kf & inp["prev_was_kf"],
                         at(T_all, torch.clamp(sc - 1, min=0)),
                         inp["T_cw_prev"])
    nxt = FG.chain_inputs(T_prev, T_me, T_ref, res0, inp["rms0"],
                          inp["first_rmse"], accept,
                          settings.re_track_threshold)
    nxt.update(
        aff=torch.where(need_kf, aff_kf, aff_new), T_cw_ref=T_ref,
        ref_aff=torch.where(need_kf, aff_kf, inp["ref_aff"]),
        ref_exp=torch.where(need_kf, exposure, inp["ref_exp"]),
        T_cw_prev=T_me, n_kf=inp["n_kf"] + need_kf.to(inp["n_kf"].dtype),
        prev_was_kf=need_kf.clone(), host_out=res["host_out"],
        scale_state=tuple(res["scale_out"][:3]),
        n_frames=torch.where(need_kf, slot + 1 - torch.sum(res["marg_ks"] >= 0),
                             inp["n_frames"]))
    if shell_idx is not None:
        nxt["last_kf"] = torch.where(need_kf, shell_idx, inp["last_kf"])
    return nxt


def keyframe_inputs(fs, right, scale_state, staged=None, timestamp=None):
    """The keyframe chain's inputs beyond the vision ones, as the bodies
    read them: the right image (None without one: `have_right` false) and
    the scale state (s, trapped, fails) as device tensors, and with VIO
    the staged IMU block (acc, gyro, ts, valid) and the keyframe's
    timestamp (0-dim)."""
    kf = dict(right=right, scale_state=tuple(scale_state),
              have_right=torch.full((), right is not None,
                                    dtype=torch.bool, device=fs.device))
    if staged is not None:
        kf.update(staged=tuple(staged[k] for k in ("acc", "gyro", "ts",
                                                   "valid")),
                  timestamp=timestamp)
    return kf


# what a record keeps of a replay's outputs
_KEEP_STATS = ("energy", "rmse", "n_its", "n_active", "is_lost")
_KEEP = ("T_cw_all_t", "affs_t", "slot", "marg_ks", "n_have", "host_out",
         "scale_out")


class ChainGraph:
    """The keyframe chain of one FullSystem (vision, or with IMU the VIO
    chain) as bodies on static buffers; on a card, as the CUDA graphs of
    those bodies (module docstring). `step` is the fused path's keyframe
    chain."""

    def __init__(self, fs):
        self.fs = fs
        self.device = fs.device
        self.on_card = self.device.type == "cuda"
        self.vio = fs.settings.enable_imu
        self.body = kf_chain_vio_body if self.vio else kf_chain_body
        self.keep = _KEEP + (("bg",) if self.vio else ())
        self.inp = None          # the static inputs, made at the first load
        self.out = {}            # rung -> its outputs
        self.graphs = {}         # rung -> CUDA graph
        self.per_replay = {}     # rung -> {counter: launches}
        self.pool = None
        self.replays = collections.Counter()
        self.capture_ms = {}     # rung -> ms of its warm-up + capture
        self.pool_bytes = None
        # host ms of the recent keyframes' staged keys
        self.draw_ms = collections.deque(maxlen=64)

    # ------------------------------------------------------------------
    # the body and its graphs
    # ------------------------------------------------------------------
    def _chain(self, pot: int):
        """The whole chain on the static buffers, the BA and the scale
        solve bounded (`control`'s loops and branches): the body of rung
        `pot`'s graph. Reads nothing back."""
        i, fs = self.inp, self.fs
        kf = dict(right=i["right"], have_right=i["have_right"],
                  scale_state=i["scale_state"])
        if self.vio:
            kf.update(staged=i["staged"], timestamp=i["timestamp"])
        self.out[pot] = self.body(
            fs, i, i["imm"], i["pyr"], i["T_cw_new"], i["aff_new"],
            i["exposure"], i["stats"], i["host_out"], i["n_kf"], i["keys"],
            pot, None, True, kf)

    def _run(self, pot: int) -> None:
        """One replay of rung `pot`'s graph (on the CPU: the body
        itself)."""
        g = self.graphs.get(pot)
        if g is None:
            self._chain(pot)
        else:
            g.replay()
            for cname, fn in COUNTERS:
                fn.launches += self.per_replay[pot][cname]
        self.replays[pot] += 1

    def capture(self, pot: int) -> None:
        """Warm rung `pot`'s body up on a side stream, then capture it into
        a CUDA graph in the chain's private pool, in "thread_local" mode,
        its branches and loops as conditional nodes (`control.capture`),
        unless it is captured already. Needs the static buffers filled (a
        `_load`). A failed capture raises; there is no fallback to the
        eager chain."""
        if pot in self.graphs or not self.on_card:
            return
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # the warm-up runs: its launches count
            self._chain(pot)
        torch.cuda.current_stream(dev).wait_stream(side)
        # a capture launches nothing: it leaves the counters as they were
        before = {c: fn.launches for c, fn in COUNTERS}
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        with control.capture(g, self.pool, side):
            self._chain(pot)
        self.per_replay[pot] = {c: fn.launches - before[c]
                                for c, fn in COUNTERS}
        self.graphs[pot] = g
        for c, fn in COUNTERS:
            fn.launches = before[c]
        torch.cuda.synchronize(dev)
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(self.pool))
        self.capture_ms[pot] = (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _stage_keys(self, key) -> None:
        """Copy the selection's keys under `key` into their static buffer:
        one non-blocking copy from pinned memory (on the CPU, a plain
        copy)."""
        host = torch.from_numpy(selection_keys(key))
        if self.on_card:
            host = host.pin_memory()
        self.inp["keys"].copy_(host, non_blocking=self.on_card)

    def _load(self, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
              host_out, n_kf: int, kf: dict) -> None:
        """Fill the static inputs: copies on the device and fills from
        host values, none of which waits for the card. The right image is
        copied in only when the keyframe has one (`have_right` says
        so)."""
        vals = dict(ba=st["ba"], dI=st["dI"], min_act=st["min_act"],
                    imm=imm, pyr=tuple(pyr), T_cw_new=T_cw_new,
                    aff_new=aff_new, exposure=exposure, stats=tuple(stats),
                    host_out=host_out, have_right=kf["have_right"],
                    scale_state=kf["scale_state"])
        if self.vio:
            vals.update(imu=st["imu"], staged=kf["staged"],
                        timestamp=kf["timestamp"])
        if kf["right"] is not None:
            vals["right"] = kf["right"]
        if self.inp is None:
            self.inp = {k: control.clone(v) for k, v in vals.items()}
            self.inp["n_kf"] = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
            self.inp["keys"] = torch.zeros((4, 2), dtype=torch.int64,
                                           device=self.device)
            if "right" not in self.inp:
                self.inp["right"] = torch.zeros(
                    self.fs.h, self.fs.w, device=self.device)
        for k, v in vals.items():
            if torch.is_tensor(v):
                self.inp[k].copy_(v)
            else:
                control.copy_into(self.inp[k], v)
        self.inp["n_kf"].fill_(n_kf)

    def prepare(self, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                host_out, n_kf: int, key, kf: dict | None = None) -> float:
        """Load the inputs (`kf`: `keyframe_inputs`'s; None: no right image
        and the system's scale state) and stage the selection's keys under
        `key`. Returns the host ms of the keys and their staging."""
        if kf is None:
            kf = keyframe_inputs(self.fs, None, self.fs._scale_state())
        self._load(st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                   host_out, n_kf, kf)
        t0 = time.perf_counter()
        self._stage_keys(key)
        return (time.perf_counter() - t0) * 1e3

    def step(self, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
             host_out, n_kf: int, key, pot: int,
             kf: dict | None = None) -> dict:
        """The chain of one keyframe at rung `pot` on the state `st` (a record's: ba, dI, min_act, imu, key, ...) with
        the keyframe's other inputs `kf` (`keyframe_inputs`; None: see
        `prepare`): replays the rung's graph, capturing it first if it is
        not yet. Returns the body's dict (fresh tensors), its state merged
        into `st`, without the host-completion entries of an export or a
        classic keyframe."""
        self.draw_ms.append(self.prepare(st, imm, pyr, T_cw_new, aff_new,
                                         exposure, stats, host_out, n_kf,
                                         key, kf))
        self.capture(pot)
        self._run(pot)
        o = self.out[pot]
        res = {k: control.clone(o[k]) for k in self.keep}
        res["ba_stats"] = {k: control.clone(o["ba_stats"][k]) for k in _KEEP_STATS}
        res["state"] = dict(st, **control.clone(o["state"]))
        return res
