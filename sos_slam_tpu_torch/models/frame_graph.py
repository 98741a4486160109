"""The fused path's frame step as one device program with its decisions on
the device (port of sos_slam_tpu/models/full_system.py `_frame_step_jit`
and `_need_kf_jit`), replayed on a card as one CUDA graph.

The JAX package runs a frame as one jitted program that the host reads
nothing back from: the tracker's loops are `lax.while_loop`s, the retry a
`lax.cond`, and the trace runs always and is then selected by `accept`.
Here the same step is one body, captured on a card as one graph:
  * the pyramid (K1) and the primary-hypothesis track, with `prim_ok`;
  * `control.cond(~prim_ok, retry)`: the 5-wide retry over the standard
    hypotheses and its pick, which a replay skips where the primary
    holds (ops/control.py: a conditional graph node);
  * `accept`, the trace (run always, then selected field by field), the
    window stats, the keyframe decision and the next frame's chained
    inputs.
The tracker runs its bounded form (ops/tracker.py): each loop a
`control.while_loop`, which leaves on the device where the eager loop
leaves, and the level repeat a `control.cond`. Everything is bit for bit
the eager step (`FullSystem._frame_step` + `_need_kf`). On the fused
path this body is the head of the fused frame's graph
(models/fused_graph.py), which keeps `need_kf` on the device; `step`
here captures the step alone and reads `need_kf` on the host, in the
same copy as the conditional nodes' run counts (`control.read`).

`FrameGraph` holds the static buffers the body reads (the frame's inputs,
the window `ba`, the immature pool and the four-level templates, copied in
before a replay: `ba` and the templates only when a keyframe chain
replaced them) and, on a card, the captured graph: warmed up on a side
stream, captured into a private pool in "thread_local" mode (the loop
handler's worker launches on the same card from another thread). A replay
overwrites the outputs of the last one, so `step` returns clones of
everything a record keeps. On the CPU the body runs as it is (there is no
graph, and `control` runs its plain twins): that is how the tests hold it
to the eager step.
"""

from __future__ import annotations

import time

import torch

from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops import image as IMG
from sos_slam_tpu_torch.ops import tracker as TK
from sos_slam_tpu_torch.ops import trace as TR
from sos_slam_tpu_torch.ops.numerics import inv
from sos_slam_tpu_torch.utils import lie

# the inputs a frame's step reads besides the state, with their shapes
_INPUTS = dict(T_primary=(4, 4), T_hyps=(5, 4, 4), aff=(2,), th=(),
               T_cw_ref=(4, 4), ref_aff=(2,), ref_exp=(), exposure=(),
               first_rmse=(), rms0=(), T_cw_prev=(4, 4))
_SEL_KEYS = ("T", "aff", "residuals", "flow", "good")


def primary_ok(out, achieve_th):
    """The primary hypothesis achieves the threshold (device bool)."""
    res0 = out["residuals"][0, 0]
    return out["good"][0] & torch.isfinite(res0) & (res0 < achieve_th)


def pick(out, outb):
    """The retry's result (`_frame_step_jit`'s `retry`): the best of the
    five hypotheses by level-0 residual, or the primary where it is at
    least as good. Each (1, ...) entry of the returned dict is chosen on
    the device."""
    resb = outb["residuals"][:, 0]
    inf = torch.full_like(resb, float("inf"))
    resb = torch.where(outb["good"] & torch.isfinite(resb), resb, inf)
    # a (1,) index: indexing by a 0-dim tensor reads it on the host
    bi = torch.argmin(resb, dim=0, keepdim=True)
    res0 = out["residuals"][0, 0]
    res_p = torch.where(out["good"][0] & torch.isfinite(res0), res0, inf[0])
    use_prim = res_p <= resb.index_select(0, bi)[0]
    return {k: torch.where(use_prim, out[k], outb[k].index_select(0, bi))
            for k in _SEL_KEYS}


def accepted(out, achieve_th, escalation: float):
    """The step accepts its best track (device bool)."""
    res_best = out["residuals"][0, 0]
    return out["good"][0] & torch.isfinite(res_best) \
        & (res_best < achieve_th * escalation)


def need_kf(out, accept, exposure_new, ref_exposure, first_rmse, no_kf,
            settings, w: int, h: int):
    """The keyframe decision (FullSystem.cpp:709-732, `_need_kf_jit`) as a
    device bool. `accept`, `no_kf` (no keyframe yet): bool tensors () or
    Python bools."""
    s = settings
    a_ref = torch.exp(out["aff"][0, 0]) * exposure_new \
        / torch.clamp(ref_exposure, min=1e-9)
    flow_t, flow_rt = out["flow"][0, 0], out["flow"][0, 1]
    wh = float(w + h)
    score = (s.kf_global_weight * s.max_shift_weight_t
             * torch.sqrt(torch.clamp(flow_t, min=0.0)) / wh
             + s.kf_global_weight * s.max_shift_weight_rt
             * torch.sqrt(torch.clamp(flow_rt, min=0.0)) / wh
             + s.kf_global_weight * s.max_affine_weight
             * torch.abs(torch.log(torch.clamp(a_ref, min=1e-9))))
    res0 = out["residuals"][0, 0]
    first_eff = torch.where(first_rmse < 0, res0, first_rmse)
    return accept & ((score > 1.0) | (2.0 * first_eff < res0) | no_kf)


def chain_inputs(T_prev, T_me, T_ref, res0, rms0, first_rmse, accept,
                 re_track_threshold: float) -> dict:
    """The next frame's tracker inputs (FullSystem.cpp:148-173) in f32 from
    this frame's pose `T_me`, its predecessor's `T_prev` and the tracking
    reference `T_ref`: the primary and the four standard hypotheses (padded
    to five), the achieve threshold, the last finite level-0 RMSE and the
    first RMSE (set by the first accepted frame)."""
    finite = torch.isfinite(res0)
    rms0 = torch.where(finite, res0, rms0)
    fh_2_sl = lie.se3_inv(T_prev) @ T_me
    lastF_2_sl = lie.se3_inv(T_me) @ T_ref
    fh_inv = lie.se3_inv(fh_2_sl)
    dbl = fh_inv @ fh_inv @ lastF_2_sl
    half = lie.se3_exp(-0.5 * lie.se3_log(fh_2_sl)) @ lastF_2_sl
    eye4 = torch.eye(4, device=T_me.device)
    return dict(
        T_primary=fh_inv @ lastF_2_sl,
        T_hyps=torch.stack([dbl, half, lastF_2_sl, eye4, eye4]),
        th=rms0 * re_track_threshold, rms0=rms0,
        first_rmse=torch.where((first_rmse < 0) & finite & accept, res0,
                               first_rmse))


class FrameGraph:
    """The frame step of one FullSystem as one body on static buffers; on
    a card, as the CUDA graph of that body (module docstring). `step` is
    the fused path's frame step."""

    def __init__(self, fs):
        self.fs = fs
        self.device = dev = fs.device
        self.on_card = dev.type == "cuda"
        self.inp = {k: torch.zeros(shape, device=dev)
                    for k, shape in _INPUTS.items()}
        self.img = torch.zeros(fs.h, fs.w, device=dev)
        self.no_kf = torch.zeros((), dtype=torch.bool, device=dev)
        self.ba = control.clone(fs.ba)
        self.imm = control.clone(fs.imm)
        self.templates = None           # made at the first step
        self.sel = dict(T=torch.eye(4, device=dev)[None],
                        aff=torch.zeros(1, 2, device=dev),
                        residuals=torch.zeros(1, 6, device=dev),
                        flow=torch.zeros(1, 2, device=dev),
                        good=torch.zeros(1, dtype=torch.bool, device=dev))
        self._held = {}      # static input -> the object it holds
        self.graph = None
        self.per_replay = {}  # counter -> launches a replay outside nodes
        self.replays = 0
        self.copy_ins = dict(ba=0, templates=0)   # the state copied in
        self.retries = 0      # frames whose primary missed
        self.capture_ms = None
        self.pool_bytes = None
        self.a = self.b = None

    # ------------------------------------------------------------------
    # the body: device work only, no host read
    # ------------------------------------------------------------------
    def _frame(self):
        """The whole step: the primary track, the retry under
        `control.cond`, then `_finish`."""
        self._primary()
        self._retry()
        self._finish()

    def _primary(self):
        """The pyramid + the primary track + `miss` (not prim_ok), the
        track into `sel`, and `iters`, the LM trips it made by level."""
        fs, i = self.fs, self.inp
        pyr, _ = IMG.build_pyramid(self.img, fs.n_levels)
        exposures = torch.stack([i["ref_exp"], i["exposure"]])
        iters = torch.zeros(1, fs.n_levels, dtype=torch.int32,
                            device=self.device)
        out = TK.track_newest_coarse(
            pyr, self.templates, i["T_primary"][None], i["aff"],
            i["ref_aff"], exposures,
            torch.full((6,), float("nan"), device=self.device), fs._intr,
            fs.n_levels, coarse_cutoff_th=fs.settings.coarse_cutoff_th,
            huber=fs.settings.huber_th, bounded=True, iters=iters)
        control.copy_into((self.sel[k] for k in _SEL_KEYS),
                   (out[k] for k in _SEL_KEYS))
        self.a = dict(pyr=pyr, exposures=exposures, out=out, iters=iters,
                      miss=~primary_ok(out, i["th"]))

    def _retry(self):
        """`_frame_step_jit`'s retry: where the primary misses, the 5-wide
        track over the standard hypotheses and its pick, into `sel`."""
        fs, i, a = self.fs, self.inp, self.a

        def retry():
            outb = TK.track_hypotheses(
                a["pyr"], self.templates, i["T_hyps"], i["aff"],
                i["ref_aff"], a["exposures"], fs._intr, fs.n_levels,
                coarse_cutoff_th=fs.settings.coarse_cutoff_th,
                huber=fs.settings.huber_th, bounded=True)
            best = pick(a["out"], outb)
            return [best[k] for k in _SEL_KEYS]

        control.cond(a["miss"], retry, None,
                     out=[self.sel[k] for k in _SEL_KEYS])

    def _finish(self):
        """accept, the trace run always and selected, the window stats,
        the keyframe decision and the next frame's chained inputs (for a
        frame that makes no keyframe)."""
        fs, i, out = self.fs, self.inp, self.sel
        s = fs.settings
        accept = accepted(out, i["th"], s.re_track_escalation)
        T_cw_new = i["T_cw_ref"] @ inv(out["T"][0])
        traced = fs._trace(self.ba, self.imm, self.a["pyr"][0], T_cw_new,
                           out["aff"][0], self.a["exposures"][1])
        imm = TR.ImmatureState(*(torch.where(accept, t_, u_)
                                 for t_, u_ in zip(traced, self.imm)))
        res0 = out["residuals"][0, 0]
        self.b = dict(
            accept=accept, T_cw_new=T_cw_new, imm=imm,
            stats=fs._frame_stats(self.ba, imm),
            need_kf=need_kf(out, accept, i["exposure"], i["ref_exp"],
                            i["first_rmse"], self.no_kf, s, fs.w, fs.h),
            nxt=chain_inputs(i["T_cw_prev"], T_cw_new, i["T_cw_ref"], res0,
                             i["rms0"], i["first_rmse"], accept,
                             s.re_track_threshold))

    # ------------------------------------------------------------------
    # the graph
    # ------------------------------------------------------------------
    def _run(self) -> None:
        """One replay (on the CPU: the body itself)."""
        if self.graph is None:
            self._frame()
        else:
            self.graph.replay()
            for name, fn in control.counters():
                fn.launches += self.per_replay.get(name, 0)
        self.replays += 1

    def capture(self) -> None:
        """Warm the body up on a side stream, then capture it into a CUDA
        graph in a private pool, in "thread_local" mode, its branch and
        loops as conditional nodes (`control.capture`). Needs the static
        buffers filled (a first `_load`). A failed capture raises; there is
        no fallback to the eager step."""
        if self.graph is not None or not self.on_card:
            return
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # the warm-up runs: its launches count
            self._frame()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = {n: fn.launches for n, fn in control.counters()}
        pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        with control.capture(g, pool, side):
            self._frame()
        # a capture launches nothing: the counters stay as they were
        for n, fn in control.counters():
            self.per_replay[n] = fn.launches - before[n]
            fn.launches = before[n]
        self.graph = g
        torch.cuda.synchronize(dev)
        # the private pool's own segments
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(pool))
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _hold(self, name: str, src, dst) -> None:
        """Copy `src` into the static `dst` unless it already holds it."""
        if self._held.get(name) is not src:
            control.copy_into(dst, src)
            self._held[name] = src
            self.copy_ins[name.split(".")[0]] += 1

    def _load(self, st, img, T_primary, T_hyps, inp, exposure: float,
              n_kf: int) -> None:
        """Fill the static inputs for one frame: copies on the device and
        fills from host scalars, none of which waits for the card."""
        if self.templates is None:
            self.templates = control.clone(st["templates"])
        for lvl, (d, s_) in enumerate(zip(self.templates, st["templates"])):
            self._hold(f"templates.{lvl}", s_, d)
        self._hold("ba", st["ba"], self.ba)
        control.copy_into(self.imm, st["imm"])
        self.img.copy_(img)
        vals = dict(inp, T_primary=T_primary, T_hyps=T_hyps)
        for k, buf in self.inp.items():
            if k != "exposure":
                buf.copy_(vals[k])
        self.inp["exposure"].fill_(exposure)
        self.no_kf.fill_(n_kf == 0)

    def step(self, st, img, T_primary, T_hyps, inp, exposure: float):
        """The frame step on the state `st` from the chained inputs `inp`
        (a `_dispatch_fused` record's `nxt`, or the host's): one replay.
        Returns a dict of fresh tensors: pyr, out (the `_OUT_KEYS` dict),
        imm (the pool, traced when accepted), accept (device bool),
        T_cw_new, stats, nxt (the chained inputs of a frame without
        keyframe), and need_kf read on the host with whether the primary
        missed (one copy, which also credits the launch counters)."""
        self._load(st, img, T_primary, T_hyps, inp, exposure, inp["n_kf"])
        self.capture()
        self._run()
        b = self.b
        res = control.clone(dict(pyr=self.a["pyr"], out=self.sel,
                          imm=b["imm"], accept=b["accept"],
                          T_cw_new=b["T_cw_new"], stats=b["stats"],
                          nxt=b["nxt"]))
        need, miss = control.read(self.device, b["need_kf"], self.a["miss"])
        self.retries += miss
        res["need_kf"] = bool(need)
        return res
