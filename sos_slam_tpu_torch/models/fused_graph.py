"""The fused path's whole frame as one device program (port of
sos_slam_tpu/models/full_system.py `_fused_frame_mono_jit` and
`_fused_frame_vio_jit`), replayed on a card as one CUDA graph per selector
rung.

The JAX package runs a frame as one program: the frame step, the keyframe
decision, the keyframe chain under `lax.cond(need_kf, run, skip)` and the
next frame's inputs chosen by `jnp.where(need_kf, ...)`; the host reads
nothing until the frame completes. Here the same frame is one body:
  1. with IMU, the staged sample block's validity (the samples of the
     last keyframe left out) and its compaction, and the gyro-integrated
     hypothesis (`FullSystem._imu_hyp_device`);
  2. the frame step (`models/frame_graph.py`'s body: the pyramid, the
     primary track, the retry under `control.cond`, the trace, the stats
     and `need_kf`);
  3. `control.cond(need_kf, chain, skip)`: the keyframe chain of
     `models/chain_graph.py` (the vision or the VIO body, its BA budget
     from the keyframe count on the device), or `chain_graph.skip_outputs`;
     both write the state in place and the readback's values;
  4. `chain_graph.chain_tail`: the next frame's inputs, written over this
     frame's;
  5. the readback packed into one buffer, which the dispatch copies into
     the record's pinned memory after the replay, with the conditional
     nodes' run counts (`control.staged`).
A replay reads nothing on the host: the host learns `need_kf` and the run
counts from the readback when the frame completes (`FullSystem.
_complete_fused`).

Device stamps (`control.stamp`, %globaltimer) time the frame on the card,
into the static `stamps` (utils/telemetry.py's STAMPS slots): the graph
stamps `frame.begin` as its first node, zeroes its other slots, then
stamps `track.end` after the pyramid, the primary track, the retry (and
with IMU the gyro hypothesis), `step.end` after the trace, the stats and
`need_kf`, `chain.end` as the chain branch's last node (0 where the chain
is skipped) and `frame.end` after `chain_tail`; the readback carries the
slots as a bit view. `FullSystem.intake` stamps `intake.begin` /
`intake.end` around a frame's intake before its dispatch, and the
dispatch stamps `post.end` after the record's clones and the readback's
copy, which the next replay's readback carries.

`FusedFrameGraph` holds the static buffers the body reads and updates in
place (the frame's inputs and the chained ones, the state, the readback
values) and, on a card, one graph per selector rung (`pot` is static in
the JAX programs, one compiled per rung): captured by `FullSystem.prewarm`
for its rungs or at the first frame of a rung, all into one private pool
in "thread_local" mode (the loop handler's worker launches on the same
card from another thread). The rung graphs share the state buffers and
replay in stream order. Each record keeps clones of the state and of the
next frame's inputs, since a record in flight may be dispatched from
again (`FullSystem._drain_pending`); the buffers are copied in only where
the dispatch source is not the frame replayed last. Whether the chain
computes the dying keyframes' energy columns is fixed at capture
(`FullSystem._exporting`): a change of it drops the graphs. A failed
capture raises; there is no fallback to the eager path. On the CPU the
body runs as it is (there is no graph, and `control` runs its plain
twins): that is how the tests hold it.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from sos_slam_tpu_torch.models import chain_graph as CG
from sos_slam_tpu_torch.models import frame_graph as FG
from sos_slam_tpu_torch.models import imu as IM
from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops.numerics import at
from sos_slam_tpu_torch.utils import telemetry as TM

# the state a frame updates, in a record's order
STATE_KEYS = ("ba", "imu", "imm", "dI", "min_act", "HdiF", "templates",
              "pc_l0")
# the readback entries of a chain's dict (the IF node's outputs besides
# the state)
_RES_KEYS = ("ba_stats", "T_cw_all_t", "affs_t", "slot", "marg_ks", "n_have",
             "host_out", "scale_out", "ecols", "marg", "marg_pts")
# the readback's type of an int64 value that rides as a bit view (two
# float32 words)
BITS = "int64 bits"
# the chained inputs beyond the frame step's, and their types
_CHAINED = dict(n_kf=torch.int64, prev_was_kf=torch.bool,
                n_frames=torch.int64, last_kf=torch.int64)


def _unaliased(dsts, srcs):
    """`srcs` for `control.copy_into(dsts, ...)`, each cloned where it
    shares memory with a destination other than itself (a later copy
    would read what an earlier one wrote)."""
    ptrs = {d.untyped_storage().data_ptr() for d in dsts}
    return [s if s is d or s.untyped_storage().data_ptr() not in ptrs
            else s.clone() for d, s in zip(dsts, srcs)]


def _put(dst, src) -> None:
    """Write `src` (a tensor, a tuple of them, or host numbers) into the
    buffer(s) `dst`."""
    if torch.is_tensor(dst):
        if src is dst:
            return
        if torch.is_tensor(src):
            dst.copy_(src)
        else:
            dst.fill_(src)
        return
    for d, s in zip(dst, src):
        _put(d, s)


class FusedFrameGraph:
    """The fused frame of one FullSystem (vision, or with IMU the VIO
    frame) as one body on static buffers; on a card, as the CUDA graphs of
    that body, one a selector rung (module docstring). `dispatch` is the
    fused path's frame."""

    def __init__(self, fs):
        self.fs = fs
        self.device = fs.device
        self.on_card = self.device.type == "cuda"
        self.vio = fs.settings.enable_imu
        self.chain_body = CG.kf_chain_vio_body if self.vio \
            else CG.kf_chain_body
        # the frame step's body and its buffers (the frame's inputs, the
        # window, the pool, the templates)
        self.frame = FG.FrameGraph(fs)
        self.state = None        # the state buffers, made at the first load
        self.chained = None      # the chained inputs beyond the step's
        self.per_frame = None    # the frame's host inputs
        self.res = None          # the readback values of the IF node
        self.graphs = {}         # rung -> CUDA graph
        self.outs = {}           # rung -> its outputs (pyr, need, flat)
        self.per_replay = {}     # rung -> {counter: launches}
        self.pool = None
        self.exporting = None    # the export flag the graphs hold
        self.spec = None         # the packed readback's layout
        self.replays = collections.Counter()     # frames by rung
        self.chains = collections.Counter()      # keyframes by rung
        self.eager = collections.Counter()       # eager chains by reason
        self.capture_ms = {}     # rung -> ms of its warm-up + capture
        self.pool_bytes = None
        self.copy_ins = 0        # dispatches that copied a state in
        # host ms of the recent frames' staged keys
        self.draw_ms = collections.deque(maxlen=64)
        self.last = None         # the record whose state the buffers hold
        # the device stamps (module docstring), and a slot for the clock's
        # calibration
        self.stamps = torch.zeros(len(TM.STAMPS) + 1, dtype=torch.int64,
                                  device=self.device)
        self.clock_slot = len(TM.STAMPS)
        self.intake_for = None   # the frame whose intake `stamps` holds

    # ------------------------------------------------------------------
    # the buffers
    # ------------------------------------------------------------------
    def _make(self, st) -> None:
        fs, fr, dev = self.fs, self.frame, self.device
        fr.templates = control.clone(st["templates"])
        self.state = dict(ba=fr.ba, imm=fr.imm, dI=st["dI"].clone(),
                          min_act=st["min_act"].clone(),
                          HdiF=st["HdiF"].clone(), templates=fr.templates,
                          pc_l0=control.clone(st["pc_l0"]))
        if self.vio:
            self.state["imu"] = control.clone(st["imu"])
        self.state = {k: self.state[k] for k in STATE_KEYS
                      if k in self.state}
        self.chained = {k: torch.zeros((), dtype=dt, device=dev)
                        for k, dt in _CHAINED.items()}
        self.chained["host_out"] = torch.zeros(fs.F, dtype=torch.int64,
                                               device=dev)
        self.chained["scale_state"] = tuple(
            torch.zeros_like(x) for x in fs._scale_state())
        self.per_frame = dict(
            keys=torch.zeros((4, 2), dtype=torch.int64, device=dev),
            right=torch.zeros(fs.h, fs.w, device=dev),
            have_right=torch.zeros((), dtype=torch.bool, device=dev),
            shell_idx=torch.zeros((), dtype=torch.int64, device=dev))
        if self.vio:
            # acc, gyro, ts, valid, the first shell index whose time covers
            # each sample, the hypothesis' window start and the frame's time
            self.per_frame["imu"] = torch.zeros(9 * IM.N_IMU + 2, device=dev)
        skip = CG.skip_outputs(fs, self.state, self.state["imm"],
                               self.chained["host_out"],
                               self.chained["scale_state"])
        self.res = {k: control.clone(skip[k]) for k in _RES_KEYS}
        if self.vio:
            self.res["bg"] = skip["bg"].clone()

    def _load(self, st, inp, prev_was_kf) -> None:
        """Copy a state and its next-frame inputs into the buffers (a
        record's, or the host's with host numbers)."""
        for k, buf in self.state.items():
            _put(buf, st[k])
        for k, buf in self.frame.inp.items():
            if k != "exposure":
                _put(buf, inp[k])
        for k, buf in self.chained.items():
            _put(buf, prev_was_kf if k == "prev_was_kf" else inp[k])
        self.copy_ins += 1

    def _stage(self, img, exposure: float, key, right, shell_idx: int,
               imu_block) -> None:
        """The frame's host inputs: copies on the device, fills from host
        numbers and non-blocking copies from pinned memory, none of which
        waits for the card."""
        fr, pf = self.frame, self.per_frame
        fr.img.copy_(img)
        fr.inp["exposure"].fill_(exposure)
        t0 = time.perf_counter()
        self._upload(pf["keys"], torch.from_numpy(CG.selection_keys(key)))
        self.draw_ms.append((time.perf_counter() - t0) * 1e3)
        if right is not None:
            pf["right"].copy_(right)
        pf["have_right"].fill_(right is not None)
        pf["shell_idx"].fill_(shell_idx)
        if self.vio:
            self._upload(pf["imu"], torch.from_numpy(imu_block))

    def _upload(self, dst, host) -> None:
        if self.on_card:
            host = host.pin_memory()
        dst.copy_(host, non_blocking=self.on_card)

    # ------------------------------------------------------------------
    # the body: device work only, no host read
    # ------------------------------------------------------------------
    def _imu_block(self):
        """`_fused_frame_vio_jit`'s staged block: the samples at or before
        the last keyframe (by the first shell index whose time covers
        each, against the chained `last_kf`) left out, the rest compacted
        to the front and the padding zeroed, as the host queue's
        reconciliation would stage them. Returns (acc, gyro, ts, valid,
        thresh, t_kf)."""
        N = IM.N_IMU
        f = self.per_frame["imu"]
        valid = (f[7 * N:8 * N] > 0.5) \
            & (f[8 * N:9 * N] > self.chained["last_kf"].to(f.dtype))
        v = valid.to(torch.int64)
        pos = torch.where(valid, torch.cumsum(v, 0) - 1,
                          torch.sum(v) + torch.cumsum(1 - v, 0) - 1)
        order = torch.empty_like(pos).scatter_(
            0, pos, torch.arange(N, device=f.device))
        keep = valid[order]
        acc = f[:3 * N].view(N, 3)[order]
        gyro = f[3 * N:6 * N].view(N, 3)[order]
        ts = f[6 * N:7 * N][order]
        zero = torch.zeros_like(ts)
        return (torch.where(keep[:, None], acc, zero[:, None]),
                torch.where(keep[:, None], gyro, zero[:, None]),
                torch.where(keep, ts, zero), keep, f[9 * N], f[9 * N + 1])

    def _head(self) -> dict:
        """The body up to the keyframe chain: with IMU the staged block
        and the gyro-integrated hypothesis, then the frame step. Returns
        the chain's arguments (st, imm, pyr, T_cw_new, aff_new, exposure,
        stats, host_out, n_kf, keys, kf: `chain_graph.keyframe_inputs`'s
        dict)."""
        fs, fr, st, ch, pf = (self.fs, self.frame, self.state, self.chained,
                              self.per_frame)
        kf = dict(right=pf["right"], have_right=pf["have_right"],
                  scale_state=ch["scale_state"])
        if self.vio:
            acc, gyro, ts, valid, thresh, t_kf = self._imu_block()
            imu = st["imu"]
            bg = (at(imu.state, torch.clamp(ch["n_frames"] - 1, min=0))
                  * IM._s21(imu.state))[3:6]
            hyp = fs._imu_hyp_device(fr.inp["T_cw_prev"], fr.inp["T_cw_ref"],
                                     fr.inp["T_primary"], fr.inp["T_hyps"],
                                     gyro, ts, valid, thresh, bg)
            control.copy_into((fr.inp["T_primary"], fr.inp["T_hyps"]), hyp)
            kf.update(staged=(acc, gyro, ts, valid), timestamp=t_kf)
        fr.no_kf.copy_(ch["n_kf"] == 0)
        fr._primary()
        fr._retry()
        control.stamp(self.stamps, TM.TRACK_END)
        fr._finish()
        control.stamp(self.stamps, TM.STEP_END)
        a, b = fr.a, fr.b
        return dict(st=st, imm=b["imm"], pyr=a["pyr"], T_cw_new=b["T_cw_new"],
                    aff_new=fr.sel["aff"][0], exposure=fr.inp["exposure"],
                    stats=b["stats"], host_out=ch["host_out"],
                    n_kf=ch["n_kf"], keys=pf["keys"], kf=kf)

    def _body(self, pot: int) -> None:
        """The whole frame at rung `pot` on the buffers (module
        docstring). Reads nothing back."""
        fs, fr, st, ch, pf = (self.fs, self.frame, self.state, self.chained,
                              self.per_frame)
        s = fs.settings
        control.stamp(self.stamps, TM.FRAME_BEGIN)
        self.stamps[TM.TRACK_END:TM.POST_END].zero_()
        c = self._head()
        a, b, sel = fr.a, fr.b, fr.sel
        need = b["need_kf"]
        out = dict(state=st, **self.res)
        dsts = control._leaves(out)

        def fit(o):
            o = dict(o, state={k: o["state"][k] for k in st})
            return _unaliased(dsts, control._like(out, o))

        def chain():
            return fit(self.chain_body(
                fs, st, c["imm"], c["pyr"], c["T_cw_new"], c["aff_new"],
                c["exposure"], c["stats"], c["host_out"], c["n_kf"],
                c["keys"], pot, None, True, c["kf"]))

        def skip():
            return fit(CG.skip_outputs(fs, st, b["imm"], ch["host_out"],
                                       ch["scale_state"]))

        control.cond(need, chain, skip, out=dsts,
                     then=lambda: control.stamp(self.stamps, TM.CHAIN_END))
        inp = dict(fr.inp, **ch)
        nxt = CG.chain_tail(need, self.res, inp, b["T_cw_new"], sel["aff"][0],
                            sel["residuals"][0, 0], b["accept"],
                            fr.inp["exposure"], s,
                            pf["shell_idx"] if self.vio else None)
        keys = [k for k in nxt if k in inp]
        dst = control._leaves([inp[k] for k in keys])
        control.copy_into(dst, _unaliased(
            dst, control._leaves([nxt[k] for k in keys])))
        vals = dict(need_kf=need, miss=a["miss"],
                    lm_trips=a["iters"].sum(), accept=b["accept"],
                    T_cw_new=b["T_cw_new"],
                    **{"out." + k: sel[k] for k in FG._SEL_KEYS})
        vals.update(fs._kf_readback(self.res))
        if self.vio:
            vals["bg"] = self.res["bg"]
        if self.exporting:
            vals.update(ecols=self.res["ecols"], marg=self.res["marg"],
                        **{f"marg_pts.{i}": x
                           for i, x in enumerate(self.res["marg_pts"])})
        self.spec = [(k, tuple(v.shape), v.dtype) for k, v in vals.items()]
        control.stamp(self.stamps, TM.FRAME_END)
        # the stamps as a bit view: a float32 holds no nanosecond clock
        n = len(TM.STAMPS)
        self.spec.append(("stamps", (n,), BITS))
        self.outs[pot] = dict(
            pyr=a["pyr"], need=need,
            flat=torch.cat([v.reshape(-1).to(torch.float32)
                            for v in vals.values()]
                           + [self.stamps[:n].view(torch.float32)]))

    # ------------------------------------------------------------------
    # the graphs
    # ------------------------------------------------------------------
    def has(self, pot: int) -> bool:
        """Whether a frame at rung `pot` replays a graph (on a card:
        captured, or capturable now because no prewarm fixed the
        rungs)."""
        if not self.on_card or pot in self.graphs:
            return True
        warm = self.fs._prewarmed_pots
        return warm is None or pot in warm

    def _hold_export(self, exporting: bool) -> None:
        """Drop the graphs captured with the other export flag."""
        if exporting != self.exporting:
            self.graphs.clear()
            self.outs.clear()
            self.per_replay.clear()
            self.pool = None
            self.exporting = exporting

    def capture(self, pot: int) -> None:
        """Warm rung `pot`'s body up on a side stream, put the buffers it
        updated back, then capture it into a CUDA graph in the private
        pool, in "thread_local" mode, its branches and loops as
        conditional nodes (`control.capture`), unless it is captured
        already. Needs the buffers filled. A failed capture raises; there
        is no fallback to the eager path."""
        if pot in self.graphs or not self.on_card:
            return
        dev = self.device
        t0 = time.perf_counter()
        fr = self.frame
        kept = control.clone((self.state, dict(fr.inp), self.chained))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # the warm-up runs: its launches count
            self._body(pot)
            _put(control._leaves((self.state, dict(fr.inp), self.chained)),
                 control._leaves(kept))
        torch.cuda.current_stream(dev).wait_stream(side)
        before = {c: fn.launches for c, fn in CG.COUNTERS}
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        with control.capture(g, self.pool, side):
            self._body(pot)
        # a capture launches nothing: it leaves the counters as they were
        self.per_replay[pot] = {c: fn.launches - before[c]
                                for c, fn in CG.COUNTERS}
        for c, fn in CG.COUNTERS:
            fn.launches = before[c]
        self.graphs[pot] = g
        torch.cuda.synchronize(dev)
        if self.fs._prewarmed_pots is None:
            self.fs._calibrate()    # prewarm() calibrates after its own
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(self.pool))
        self.capture_ms[pot] = (time.perf_counter() - t0) * 1e3

    def _run(self, pot: int) -> None:
        """One replay of rung `pot`'s graph (on the CPU: the body
        itself)."""
        g = self.graphs.get(pot)
        if g is None:
            self._body(pot)
        else:
            g.replay()
            for c, fn in CG.COUNTERS:
                fn.launches += self.per_replay[pot][c]
        self.frame.replays += 1
        self.replays[pot] += 1

    # ------------------------------------------------------------------
    # the frame
    # ------------------------------------------------------------------
    def dispatch(self, st, inp, prev_was_kf, src, img, exposure: float,
                 key, right, shell_idx: int, imu_block, pot: int,
                 exporting: bool) -> dict:
        """The frame at rung `pot` (`has(pot)` must hold) from the state
        `st`, the chained inputs `inp` and `prev_was_kf` of the dispatch
        source `src` (a record, or None for the host's), with the frame's
        host inputs (`key`: the keyframe's selection key; `imu_block`:
        `FullSystem._stage_imu_block`'s array with IMU). Returns fresh
        tensors: pyr, need_kf (device bool), state (the entries of
        `STATE_KEYS`), nxt (the next frame's inputs), and the packed
        readback (flat) with its layout (spec)."""
        if self.state is None:
            self._make(st)
        self._hold_export(exporting)
        if src is None or src is not self.last:
            self._load(st, inp, prev_was_kf)
        self._stage(img, exposure, key, right, shell_idx, imu_block)
        self.capture(pot)
        self._run(pot)
        o = self.outs[pot]
        nxt = control.clone(dict(self.frame.inp, **self.chained))
        del nxt["exposure"]
        return dict(pyr=control.clone(o["pyr"]), need_kf=o["need"].clone(),
                    state=control.clone(self.state), nxt=nxt,
                    flat=o["flat"], spec=self.spec)


def imu_cover(shells, times) -> np.ndarray:
    """For each time of `times` (ascending), the index of the first shell
    of `shells` (by timestamp, ascending) whose time is at or after it: a
    sample is consumed by a keyframe at or after that shell."""
    import bisect
    return np.asarray([bisect.bisect_left(shells, t,
                                          key=lambda sh: sh.timestamp)
                       for t in times], np.float32)
