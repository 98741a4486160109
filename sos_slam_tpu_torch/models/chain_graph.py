"""The vision keyframe chain as one device program with its decisions on
the device (port of sos_slam_tpu/models/full_system.py `_kf_chain_jit`
with `_flag_frames_jit`, `_kf_mega_jit`, `_marg_select_jit`,
`_maybe_marg_frame_lean_jit` and `_compact_dI`), replayed on a card as
CUDA graphs.

`kf_chain_body` is the chain's one definition: the marginalization flags
(`flag_frames`), frame insertion, activation (K4), the windowed BA (K3),
HdiF, the tracker template (K2), point marginalization (K3) with the
new-trace selection (K1 for its gradient pyramid), `MAX_MARG_FRAMES`
masked frame marginalizations and one image-stack compaction. Nothing in
it reads the card: the window's slot, the flagged slots (`marg_ks`,
descending, padded with -1), the selection count `n_have` and the
per-host dead-point counts `host_out` stay device tensors, and the host
learns them from the frame's one pinned readback when the frame
completes. Its random draws (the selector's block directions and the
density subsample) are the threefry twin's, made on the device from four
keys that the host derives at dispatch, where it knows the keyframe's
key, and copies in; the subsample is drawn always and applied where the
count asks for it. The eager chain
(`FullSystem._kf_chain` with `cuda_graphs=False`, on the CPU, or for a
keyframe the graphs do not take) runs the body with the BA's early-exit
loop, which reads its break test on the host after each step; the graphs
run it with the BA bounded (`models/energy.py`, `bounded=True`), which
gives the same bits. With an export consumer attached (`_exporting()`)
the body also computes the dying keyframes' energy columns, and the
keyframe's completion reads them with the marginalized points, which a
graph's outputs do not keep: such a chain stays eager.

`ChainGraph` holds the static buffers the body reads (the window `ba`,
the immature pool, the image stack, the activation distance, `host_out`,
the keyframe's pyramid, pose, affine and exposure, the frame's window
stats, the keyframe count and the selection's keys) and,
on a card, the captured graphs. The card's PyTorch has no conditional
graph nodes, so the graphs take only what their shape allows:
  * the BA budget `settings.max_opt_iterations` (the bootstrap's 20 and
    15 run eagerly);
  * one graph per selector rung (`pot` is static in the JAX chain as it
    is here), captured by `FullSystem.prewarm` for its rungs, whose clamp
    keeps the rung among them, or at the first keyframe of a rung before
    any prewarm; a rung without a graph after prewarm runs eagerly.
Each keyframe that runs eagerly is counted in `eager` by its reason.
A rung's graph holds the whole chain, its BA run to the bound: a replay
reads nothing back. Every graph is warmed up on a side stream and
captured in "thread_local" mode (the loop handler's worker launches on
the same card from another thread), all into one private pool kept apart
from the frame step's (`models/frame_graph.py`): the rung graphs are
alternatives, each holding its own outputs, and the frame graphs replay
between them in no fixed order. A replay overwrites the outputs of the
last one, so `step` returns clones of what a record keeps, and adds the
K1-K4 launches captured in the replayed graphs to the kernels' launch
counters. A failed capture raises; there is no fallback to the eager
chain. On the CPU the bodies run as they are: that is how the tests hold
them.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from sos_slam_tpu_torch.models import energy as E
from sos_slam_tpu_torch.models import window as WIN
from sos_slam_tpu_torch.models.frame_graph import _clone, _copy_into
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import ba_p as BP
from sos_slam_tpu_torch.ops import image as IMG
from sos_slam_tpu_torch.ops import selector
from sos_slam_tpu_torch.ops.numerics import at
from sos_slam_tpu_torch.utils import rng

MAX_MARG_FRAMES = 4   # >= (max_frames - min_frames) + 1 for the defaults

# the kernels' launch counters, which a replay adds its captured launches to
COUNTERS = (("K1", IMG.pyramid_levels), ("K2", WIN.template_levels),
            ("K3", BP.fused_iteration), ("K4", BP.act_pass))


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
    `_maybe_marg_frame_lean_jit` (with `imu`, its VIO twin's): one
    marginalization for each of the MAX_MARG_FRAMES slots `marg_ks`
    (descending, -1 padded), the freed image rows tracked in a slot ->
    row map `dimap`, then one compaction of the image stack (the
    counterpart of `_compact_dI`: one gather, the rows from the live
    count on zeroed). In vision mode each marginalization is selected
    field by field where its slot is >= 0 (a -1 is clamped to slot 0 and
    its result dropped), which reads nothing back; the VIO fold reads its
    slot on the host, so with `imu` the flagged slots are read once and
    only those are folded. With an export consumer attached, also each
    slot's energy column on the state before its fold, its image read
    through `dimap` (the entries of padded slots are not used). Returns
    (ba, imm, imu, dI, host_out, [(e_col, n_col)])."""
    F = ba.F
    idx = torch.arange(F, device=dI.device)
    dimap = idx
    ks = None if imu is None else marg_ks.tolist()
    exporting = fs._exporting()
    ecols = []
    for j in range(MAX_MARG_FRAMES):
        k = marg_ks[j]
        do = k >= 0
        kc = torch.clamp(k, min=0)
        if exporting:
            ecols.append(B.col_energy(ba, dI, kc, fs.settings, fs.w, fs.h,
                                      row=at(dimap, kc)))
        if imu is None:
            ba2, imm2, _ = fs._marg_frame(ba, imm, None, kc)
            ba, imm = _select(do, ba2, ba), _select(do, imm2, imm)
        elif ks[j] >= 0:
            ba, imm, imu = fs._marg_frame(ba, imm, imu, ks[j])
        src = torch.clamp(torch.where(idx < kc, idx, idx + 1), max=F - 1)
        dimap = torch.where(do, torch.where(idx == F - 1, at(dimap, kc),
                                            dimap[src]), dimap)
        host_out = shift_host_out(host_out, k)
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


def kf_chain_body(fs, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                  host_out, n_kf, keys, pot: int, max_its: int,
                  bounded: bool):
    """The vision keyframe chain (`_kf_chain_jit`'s run branch) on the
    state `st` (ba, dI, min_act) and the traced pool `imm`: the flags, the
    frame's insertion with its image, the activation, the BA, the
    template, point marginalization + selection, the frame
    marginalizations. `pyr` is the new keyframe's pyramid, `T_cw_new` /
    `aff_new` / `exposure` its pose, affine and exposure, `stats` the
    frame's window stats, `host_out` (F,) device ints, `n_kf` the
    keyframe count before it, `keys` the selection's keys on the device
    (`selection_keys`), `pot` the selector rung, `max_its` the BA budget.
    `bounded`: the BA's bounded form (module docstring), with which it
    reads nothing back unless an export consumer is attached (the energy
    columns index by slot). Returns a dict of device values: state (the
    entries of `st` it replaces), ba_stats, T_cw_all_t, affs_t, slot,
    marg_ks, n_have, host_out, and for the host's completion
    imm_pre_select, marg, marg_pts and ecols."""
    s = fs.settings
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
        imm_pre_select=imm_pre_select, marg=marg, marg_pts=marg_pts,
        ecols=ecols)


# what a record keeps of a replay's outputs
_KEEP_STATS = ("energy", "rmse", "n_its", "n_active", "is_lost")
_KEEP = ("T_cw_all_t", "affs_t", "slot", "marg_ks", "n_have", "host_out")


class ChainGraph:
    """The vision keyframe chain of one FullSystem as bodies on static
    buffers; on a card, as the CUDA graphs of those bodies (module
    docstring). `step` is the fused path's keyframe chain."""

    def __init__(self, fs):
        self.fs = fs
        self.device = fs.device
        self.on_card = self.device.type == "cuda"
        self.inp = None          # the static inputs, made at the first load
        self.out = {}            # rung -> its outputs
        self.graphs = {}         # rung -> CUDA graph
        self.per_replay = {}     # rung -> {counter: launches}
        self.pool = None
        self.replays = collections.Counter()
        self.eager = collections.Counter()   # eager keyframes by reason
        self.capture_ms = {}     # rung -> ms of its warm-up + capture
        self.pool_bytes = None
        # host ms of the recent keyframes' staged keys
        self.draw_ms = collections.deque(maxlen=64)

    # ------------------------------------------------------------------
    # the body and its graphs
    # ------------------------------------------------------------------
    def _chain(self, pot: int):
        """The whole chain on the static buffers, the BA bounded: the body
        of rung `pot`'s graph. Reads nothing back."""
        i, fs = self.inp, self.fs
        self.out[pot] = kf_chain_body(
            fs, i, i["imm"], i["pyr"], i["T_cw_new"], i["aff_new"],
            i["exposure"], i["stats"], i["host_out"], i["n_kf"], i["keys"],
            pot, fs.settings.max_opt_iterations, bounded=True)

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

    def has(self, pot: int) -> bool:
        """Whether a keyframe at rung `pot` replays graphs (on a card:
        captured, or capturable now because no prewarm fixed the
        rungs)."""
        if not self.on_card:
            return True
        if pot in self.graphs:
            return True
        warm = self.fs._prewarmed_pots
        return warm is None or pot in warm

    def capture(self, pot: int) -> None:
        """Warm rung `pot`'s body up on a side stream, then capture it into
        a CUDA graph in the chain's private pool, in "thread_local" mode,
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
        with torch.cuda.graph(g, pool=self.pool, stream=side,
                              capture_error_mode="thread_local"):
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
              host_out, n_kf: int) -> None:
        """Fill the static inputs: copies on the device and one fill from
        a host int, none of which waits for the card."""
        vals = dict(ba=st["ba"], dI=st["dI"], min_act=st["min_act"],
                    imm=imm, pyr=tuple(pyr), T_cw_new=T_cw_new,
                    aff_new=aff_new, exposure=exposure, stats=tuple(stats),
                    host_out=host_out)
        if self.inp is None:
            self.inp = {k: _clone(v) for k, v in vals.items()}
            self.inp["n_kf"] = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
            self.inp["keys"] = torch.zeros((4, 2), dtype=torch.int64,
                                           device=self.device)
        for k, v in vals.items():
            if torch.is_tensor(v):
                self.inp[k].copy_(v)
            else:
                _copy_into(self.inp[k], v)
        self.inp["n_kf"].fill_(n_kf)

    def prepare(self, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                host_out, n_kf: int, key) -> float:
        """Load the inputs and stage the selection's keys under `key`.
        Returns the host ms of the keys and their staging."""
        self._load(st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                   host_out, n_kf)
        t0 = time.perf_counter()
        self._stage_keys(key)
        return (time.perf_counter() - t0) * 1e3

    def step(self, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
             host_out, n_kf: int, key, pot: int) -> dict:
        """The chain of one keyframe at rung `pot` (`has(pot)` must hold)
        on the state `st` (a record's: ba, dI, min_act, imu, key, ...): replays
        the rung's graph, capturing it first if it is not yet. Returns
        `kf_chain_body`'s dict (fresh tensors), its state merged into `st`,
        without the host-completion entries of an export or a classic
        keyframe."""
        self.draw_ms.append(self.prepare(st, imm, pyr, T_cw_new, aff_new,
                                         exposure, stats, host_out, n_kf,
                                         key))
        self.capture(pot)
        self._run(pot)
        o = self.out[pot]
        res = {k: _clone(o[k]) for k in _KEEP}
        res["ba_stats"] = {k: _clone(o["ba_stats"][k]) for k in _KEEP_STATS}
        res["state"] = dict(st, **_clone(o["state"]))
        return res
