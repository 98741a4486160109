"""FullSystem: the odometry driver (port of sos_slam_tpu/models/
full_system.py; reference FullSystem.cpp): monocular, stereo scale and
spline VIO.

One frame after initialization runs the JAX package's fused per-frame
program (`_fused_frame_mono_jit`, `_fused_frame_vio_jit`) in PyTorch; on
a card as one CUDA graph a selector rung with every decision on the
device (`models/fused_graph.py`), else eagerly (`cuda_graphs=False`, the
CPU), where the host reads the decisions:
  * the frame step: pyramid (K1), primary-hypothesis coarse track, a retry
    over the standard hypotheses when the primary misses the achieve
    threshold, the immature-point trace (applied only if the track is
    accepted) and the window stats (`models/frame_graph.py`'s body, the
    counterpart of `_frame_step_jit`; eagerly `_frame_step`);
  * the keyframe decision (`_need_kf`): a device bool under the graphs,
    which the host learns from the frame's readback when it completes;
  * on keyframes, `_kf_chain` (vision) or `_kf_chain_vio`: marginalization
    flags, frame insertion, point activation with K4, windowed BA with K3
    (the visual-inertial KKT BA once the IMU is initialized, with the
    staged IMU-sample intake and spline propagation before it), HdiF,
    tracker template with K2, point marginalization + new-trace selection,
    the flagged frames' marginalizations, one image-stack compaction and,
    with stereo, the 1-DoF scale solve on the right image's pyramid (K1).
The next frame's inputs (hypotheses, reference pose, thresholds, scale
state, last keyframe time) are chained from this frame's outputs in f32,
as the JAX package chains them on its device. With VIO the tracker's
primary hypothesis is the gyro-integrated one (`_imu_hyp_device`) and the
chain consumes the host-staged IMU block only when the frame becomes a
keyframe. When the step refuses a frame, the host fallback runs the
rotation-perturbed restarts (`_finish_step_host`) and the classic
keyframe path, exactly as the JAX package does after `_complete_fused`.

The fused path is pipelined as the JAX package's driver is (`pipeline`,
`pipeline_depth`): `_dispatch_fused` enqueues a frame from the record of
the frame before it (its chained device state and next-frame inputs) and
stages the values its completion reads into a pinned host buffer of the
record's own; `_complete_fused` makes the host bookkeeping up to
`pipeline_depth` frames later, from that one readback. A frame that the
step refused invalidates the frames in flight after it, and a
selector-rung change those from the first keyframe among them on (only a
keyframe's chain reads the rung); `_drain_pending` dispatches them again,
as the synchronous path would; with the graphs a rung change dispatches
every frame in flight again, since their decisions are not known yet.
With the graphs a frame's dispatch reads nothing on the host: the retry,
the loops, the keyframe chain under `need_kf` and the BA budget are
conditional graph nodes and device values (`ops/control.py`), and the
nodes' run counts ride the frame's readback; the eager step and chain
(`cuda_graphs=False`, the CPU) read the keyframe decision, the tracker's
loop exits, its accept tests, the BA's break and the scale LM's loop
conditions.

With VIO the system bootstraps on the classic path, as the JAX package
does: frames wait for `min_g_imu` samples before the first one is used,
the keyframe decision and the marginalization flags are made on the host
in f64, and the fifth keyframe initializes the IMU (`_make_keyframe_vio`);
after that every frame takes the fused path.

The export side feeds loop closure and the output wrappers: every frame
marginalization hands the dying keyframe's record (`_export_kf`: its own
pyramid, its marginalized points with per-level intensities, dso_error
from the energy column of the state before the fold, scale_error) to each
of `marg_callbacks` and publishes it on `output_wrappers`. With no
consumer attached, the point cache, the energy column and the sampling
are skipped, so the odometry runs op for op as it does without them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from sos_slam_tpu_torch import resolve_device
from sos_slam_tpu_torch.models import chain_graph as CG
from sos_slam_tpu_torch.models import energy as E
from sos_slam_tpu_torch.models import frame_graph as FG
from sos_slam_tpu_torch.models import fused_graph as FU
from sos_slam_tpu_torch.models import imu as IM
from sos_slam_tpu_torch.models import initializer as CI
from sos_slam_tpu_torch.models import window as WIN
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops import scale_opt as SO
from sos_slam_tpu_torch.ops import selector
from sos_slam_tpu_torch.ops import trace as TR
from sos_slam_tpu_torch.ops import tracker as TK
from sos_slam_tpu_torch.ops.image import build_pyramid, interp_bilinear
from sos_slam_tpu_torch.ops.numerics import at, inv
from sos_slam_tpu_torch.utils import cuda_build, lie, rng
from sos_slam_tpu_torch.utils import telemetry as TM
from sos_slam_tpu_torch.utils.camera import CalibPyramid
from sos_slam_tpu_torch.utils.config import Settings
from sos_slam_tpu_torch.utils.telemetry import Telemetry


@dataclasses.dataclass
class FrameShell:
    """Permanent per-frame record (reference util/FrameShell.h)."""

    id: int
    timestamp: float
    cam_to_world: np.ndarray
    aff: np.ndarray
    pose_valid: bool = True
    tracking_ref: Optional[int] = None  # id of the reference KF shell
    is_kf: bool = False
    marginalized_at: int = -1
    # stereo metric-scale bookkeeping (FrameShell.h:51-60)
    scale: float = 1.0
    scale_error: float = -1.0
    cam_to_world_scaled: Optional[np.ndarray] = None
    dso_error: float = np.nan   # the JAX shell's field: its snapshots load
    shell_idx: int = -1


@dataclasses.dataclass
class StereoCalib:
    """Right-camera intrinsics + left->right extrinsics (ScaleOptimizer.h)."""

    T_lr: np.ndarray                    # (4,4) left -> right
    calib_right: CalibPyramid


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _np_bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x0 = np.clip(np.floor(u), 0, w - 2).astype(int)
    y0 = np.clip(np.floor(v), 0, h - 2).astype(int)
    dx = np.clip(u - x0, 0, 1)
    dy = np.clip(v - y0, 0, 1)
    return (img[y0, x0] * (1 - dx) * (1 - dy) + img[y0, x0 + 1] * dx * (1 - dy)
            + img[y0 + 1, x0] * (1 - dx) * dy + img[y0 + 1, x0 + 1] * dx * dy)


def host_to_new_transforms(ba: B.BAState, T_cw_new):
    """Per-host-slot KRKi / Kt into an external new frame."""
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    rel = torch.einsum("ij,fjk->fik", lie.se3_inv(T_cw_new), T_cw)
    fx, fy, cx, cy = B.calib_real(ba)
    zero = torch.zeros_like(fx)
    K = torch.stack([torch.stack([fx, zero, cx]),
                     torch.stack([zero, fy, cy]),
                     torch.stack([zero, zero, zero + 1.0])])
    Ki = inv(K)
    KRKi = torch.einsum("ij,fjk,kl->fil", K, rel[:, :3, :3], Ki)
    Kt = torch.einsum("ij,fj->fi", K, rel[:, :3, 3])
    return KRKi, Kt


def trace_new(ba: B.BAState, imm: TR.ImmatureState, dI0_new, T_cw_new,
              aff_new, exposure_new, w: int, h: int, settings: Settings):
    """Trace every immature point of `imm` onto a new frame
    (traceNewCoarse): the host-to-new transforms, the affine transfer and
    trace_points (the JAX package's `_trace_jit`). Each point is traced on
    its own, so a slice of the pool traces as it would in the whole."""
    KRKi, Kt = host_to_new_transforms(ba, T_cw_new)
    aff_cur = B.aff_real(ba.state)
    affs = TK.aff_from_to(ba.exposure, exposure_new, aff_cur.T,
                          aff_new[:, None].expand(2, ba.F)).T
    return TR.trace_points(imm, dI0_new, KRKi, Kt, affs, w, h, settings)


def _words(shape, dtype) -> int:
    """The float32 words a readback value takes: an int64 bit view
    (`fused_graph.BITS`: the stamps) two each."""
    return int(np.prod(shape)) * (2 if dtype == FU.BITS else 1)


def _clamp0(i):
    """max(i, 0) of an int or a device int tensor."""
    return torch.clamp(i, min=0) if torch.is_tensor(i) else max(i, 0)


def _pad_hyps(hyps, size):
    out = list(hyps)[:size]
    while len(out) < size:
        out.append(out[-1] if out else np.eye(4))
    return out


_STATE_KEYS = ("ba", "imu", "imm", "dI", "min_act", "HdiF", "templates",
               "pc_l0", "key")
# the tracker outputs that a frame's completion reads back
_OUT_KEYS = ("T", "aff", "residuals", "flow", "good")


class FullSystem:
    def __init__(self, calib: CalibPyramid, settings: Settings,
                 stereo: Optional[StereoCalib] = None, device=None,
                 jax_form: bool = False, cuda_graphs: bool = True):
        """`jax_form=True` folds out a VIO frame whose block holds dims
        without information as the JAX package does, into a NaN prior
        (`E.marginalize_frame_vio`; for the parity tests only). On a card
        the fused path's frame (the step, the keyframe decision and the
        keyframe chain) replays one CUDA graph a selector rung
        (`models/fused_graph.py`); `cuda_graphs=False` keeps it eager, as
        running the JAX package under `jax.disable_jit()` would, and is the
        yardstick it is held to bit for bit. On the CPU it is always eager.
        With IMU the graphs run the VIO frame, and with stereo the scale
        solve inside its chain."""
        if settings.enable_scale_opt and stereo is None:
            raise ValueError("enable_scale_opt requires a StereoCalib")
        self.device = dev = resolve_device(device)
        self.jax_form = jax_form
        self.calib = calib
        self.settings = settings
        self.n_levels = calib.levels
        self.w = calib.widths[0]
        self.h = calib.heights[0]
        self._intr = tuple(calib.intrinsics(l) for l in range(self.n_levels))
        F = settings.max_window_frames
        P = settings.max_points
        self.F, self.P = F, P
        # the chains flag up to (max_frames - min_frames) + 1 frames a
        # keyframe (the count gate stops at min_frames, plus one distance
        # drop) and keep MAX_MARG_FRAMES flagged slots: a larger count
        # would drop slots whose points were marginalized all the same
        worst_flags = max(settings.max_frames - settings.min_frames, 2) + 1
        if worst_flags > CG.MAX_MARG_FRAMES:
            raise ValueError(
                f"settings allow up to {worst_flags} frames flagged a "
                f"keyframe but MAX_MARG_FRAMES={CG.MAX_MARG_FRAMES}; raise "
                f"it or narrow max_frames - min_frames")

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        fx, fy, cx, cy = calib.intrinsics(0)
        c0 = torch.tensor([fx, fy, cx, cy], dtype=torch.float32,
                          device=dev) / torch.tensor(
            [B.SCALE_F, B.SCALE_F, B.SCALE_C, B.SCALE_C], device=dev)
        D = 4 + 8 * F
        self.ba = B.BAState(
            frame_valid=z(F, dtype=torch.bool),
            T_cw_eval=torch.eye(4, device=dev).repeat(F, 1, 1),
            state=z(F, 8), state_zero=z(F, 8),
            exposure=torch.ones(F, device=dev),
            energy_th=torch.full((F,), 12.0 * 12.0 * 8.0, device=dev),
            prior=z(F, 8), c=c0, c_zero=c0.clone(),
            pt_valid=z(P, dtype=torch.bool), host=z(P, dtype=torch.int32),
            u=z(P), v=z(P), color=z(P, 8), weight=z(P, 8),
            idepth=z(P), idepth_zero=z(P), pt_prior=z(P),
            res_exist=z(P, F, dtype=torch.bool),
            res_state=z(P, F, dtype=torch.int8),
            HM=z(D, D), bM=z(D))
        self.dI = z(F, self.h, self.w, 3)
        self.frame_pyramids: List = [None] * F        # full pyramid per slot
        self.frame_shell_idx: List[int] = []
        self.HdiF = z(P)
        N = settings.max_immature
        self.imm = TR.ImmatureState(
            valid=z(N, dtype=torch.bool), host=z(N, dtype=torch.int32),
            u=z(N), v=z(N), color=z(N, 8), weights=z(N, 8),
            gradH=z(N, 2, 2), energy_th=z(N), idepth_min=z(N),
            idepth_max=torch.full((N,), float("inf"), device=dev),
            status=z(N, dtype=torch.int8),
            quality=torch.full((N,), 10000.0, device=dev),
            my_type=z(N, dtype=torch.int32))

        self.tmpl_sizes = tuple(max(settings.max_track_pts >> (2 * l), 1024)
                                for l in range(self.n_levels))
        self.templates = None
        self.pc_l0 = None
        self.ref_slot = -1
        self.ref_aff = np.zeros(2, np.float32)
        self.ref_exposure = 1.0
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = np.full(6, 100.0)

        self.initializer: Optional[CI.InitState] = None
        self.init_first_pyr = None
        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        # the activation distance: a device scalar the chains evolve
        self.current_min_act_dist = torch.full((), 2.0, device=dev)
        self.shells: List[FrameShell] = []
        self._shell_by_id: dict = {}
        self.kf_shell_ids: List[int] = []
        # carried-over world pose for reinitialization: when set (by
        # SlamNode after an init failure), the rebuilt system's first KF
        # starts here instead of the gravity-aligned origin
        # (SlamNode.cpp:174-189 curPose carry + FullSystem.cpp:1040-1042)
        self.initial_pose: Optional[np.ndarray] = None
        # per-host dead-point counts: the host's mirror of the chains'
        # device counts, taken from each keyframe's readback
        self.host_out = np.zeros(F, np.int64)
        # per-slot caches of marginalized points ([u, v, idepth] rows): the
        # analog of pointHessiansMarginalized, read by the loop closure
        self._marg_pts_cache: List[list] = [[] for _ in range(F)]
        self._last_dso_error = 1e6
        self.key = rng.PRNGKey(3141592)
        self._sel_pot = 3
        # the selector rungs prewarm() warmed; when set, the density
        # adaptation moves the rung only within it
        self._prewarmed_pots = None
        self._last_chain = None      # the last completed frame's record
        # pipelining of the fused path (the JAX package's driver): up to
        # `pipeline_depth` dispatched frames wait for their completion while
        # later frames dispatch from their records; a pipelined run
        # computes what a synchronous one does, bit for bit
        self.pipeline = True
        self.pipeline_depth = int(os.environ.get("SOS_SLAM_PIPE_DEPTH", "3"))
        self._pending_fused = collections.deque()
        # the fused per-frame path after the bootstrap; False keeps every
        # frame on the classic host-decided path
        self.fused_kf = True

        # stereo scale optimization state (FullSystem.cpp:1117-1180)
        self.stereo = stereo
        self.scale_trapped = False
        self.scale_opt_fails = 0
        self.current_scale = 1.0   # global map->metric scale (HCalib.scale)
        self._pending_right = None

        # spline VIO state (models/imu.py)
        self.imu = IM.empty_imu(F, dev) if settings.enable_imu else None
        self.imu_initialized = False
        self.imu_queue: List = []   # (t, acc(3,), gyro(3,)) since last KF
        self._last_bg = None        # host copy of the gyro bias (fused VIO)
        self.marg_callbacks = []     # loop-closure hooks: fn(kf_record)
        self.output_wrappers = []    # Output3DWrapper publishers
        self.stats = dict(n_kf=0, n_frames=0)
        self._prior_rows = {}
        self.telemetry = Telemetry(device=dev)
        # the fused graph's dispatches whose device stamps the telemetry
        # has not had yet, in stream order (`_take_stamps`), and whether
        # one was made since the last clock calibration
        self._sent = collections.deque()
        self._stamping = False
        # the fused path's frame (step, decision, keyframe chain) as CUDA
        # graphs, one a selector rung (None: eager)
        graphs = cuda_graphs and dev.type == "cuda"
        self.fused_graph = FU.FusedFrameGraph(self) if graphs else None
        if stereo is not None:
            T_lr = torch.as_tensor(np.asarray(stereo.T_lr, np.float32),
                                   device=dev)
            self._lr = (T_lr[:3, :3], T_lr[:3, 3], tuple(
                stereo.calib_right.intrinsics(l)
                for l in range(self.n_levels)))

    # ------------------------------------------------------------------
    # public API (reference FullSystem::addActiveFrame)
    # ------------------------------------------------------------------
    def add_active_frame(self, image, timestamp: float, frame_id: int,
                         exposure: float = 1.0, image_right=None,
                         imu_samples=None):
        """Track one frame; makes it a keyframe when needed. `image` (and
        `image_right`, with stereo) is an (H, W) array or tensor of
        irradiance values; `imu_samples` an iterable of (t, acc(3,),
        gyro(3,)) since the last frame."""
        if self.is_lost:
            return
        s = self.settings
        if s.enable_imu and imu_samples is not None:
            self.imu_queue.extend(imu_samples)
        if s.enable_imu and not self.initialized \
                and self.initializer is None \
                and len(self.imu_queue) < s.min_g_imu:
            # wait for enough accel samples to estimate gravity
            # (FullSystem.cpp:626-631)
            return
        self._pending_right = self._image(image_right) \
            if s.enable_scale_opt and image_right is not None else None
        shell = FrameShell(id=frame_id, timestamp=timestamp,
                           cam_to_world=np.eye(4), aff=np.zeros(2),
                           shell_idx=len(self.shells))
        self.shells.append(shell)
        self._shell_by_id[shell.id] = shell
        self.stats["n_frames"] += 1
        img = self._image(image)
        if not self.initialized:
            pyr, absgrads = build_pyramid(img, self.n_levels)
            self._initializer_step(pyr, absgrads, shell, exposure)
            return
        if self._fused_active():
            with self.telemetry.timed("frame", frame_id):
                self._add_frame_fused(img, shell, exposure)
            return
        self.finish_pending()
        with self.telemetry.timed("track", frame_id):
            self._track_classic(img, shell, exposure)

    @property
    def kf_n_its(self) -> collections.Counter:
        """Keyframes by the GN steps of their BA: a view of the
        telemetry's `ba.gn_its` series."""
        return collections.Counter(
            int(n) for n in self.telemetry.timers.get("ba.gn_its", ()))

    @contextlib.contextmanager
    def intake(self, frame_id: int):
        """The block as frame `frame_id`'s intake (SlamNode.process: the
        frame's conversion, upload and remap): the host span `node.intake`
        and, on the fused graph's path, the device stamps `intake.begin`
        and `intake.end` around it, which the frame's first dispatch
        carries to the telemetry (models/fused_graph.py)."""
        g = self.fused_graph
        with self.telemetry.timed("node.intake", frame_id):
            if g is not None:
                control.stamp(g.stamps, TM.INTAKE_BEGIN)
            yield
            if g is not None:
                control.stamp(g.stamps, TM.INTAKE_END)
                g.intake_for = frame_id

    def _image(self, image) -> torch.Tensor:
        return torch.as_tensor(np.array(image, np.float32)
                               if not torch.is_tensor(image) else image,
                               dtype=torch.float32).to(self.device)

    def _fused_active(self) -> bool:
        """The fused per-frame path runs from initialization on (unless
        `fused_kf` is False), and with VIO once the IMU is initialized (the
        bootstrap is classic)."""
        if not (self.fused_kf and self.initialized):
            return False
        return self.imu_initialized if self.settings.enable_imu else True

    def _pipeline_ready(self) -> bool:
        """Frames stay in flight from the first fused frame on, with VIO
        once the IMU is initialized: the chain takes every input it
        changes from the record it dispatches from (the BA budget from the
        chained keyframe count), and the host's gates (lost, the
        bootstrap's RMSE gates) clear the queue at completion."""
        if not self.pipeline:
            return False
        return (not self.settings.enable_imu) or self.imu_initialized

    def _add_frame_fused(self, img, shell, exposure):
        """Dispatch this frame from the newest record in flight (or the
        last completed one), then complete the oldest frames until at most
        `pipeline_depth` stay in flight."""
        q = self._pending_fused
        q.append(self._dispatch_fused(img, shell, exposure,
                                      q[-1] if q else self._last_chain,
                                      self._pending_right))
        self._drain_pending(self.pipeline_depth if self._pipeline_ready()
                            else 0)

    def _drain_pending(self, depth: int) -> None:
        """Complete frames in flight until at most `depth` remain. A
        completion that invalidates the newer frames (fallback tracking, a
        loss) reprocesses them one by one: the first from the host state,
        each later one chained from the one completed before it. A
        selector-rung change dispatches them again from the first keyframe
        among them on, chained, with the new rung. A lost system or a
        failed bootstrap clears the queue."""
        q = self._pending_fused
        while len(q) > depth:
            pot_before = self._sel_pot
            rec = q.popleft()
            with self.telemetry.timed("complete", rec["shell"].id):
                redo = self._complete_fused(rec)
            self._last_chain = None if redo else rec
            if self.is_lost or self.init_failed:
                q.clear()
                return
            if redo:
                stale = list(q)
                q.clear()
                for r in stale:
                    again = self._dispatch_fused(
                        r["image"], r["shell"], r["exposure"],
                        self._last_chain, r["stereo_right"])
                    with self.telemetry.timed("complete", r["shell"].id):
                        redo2 = self._complete_fused(again)
                    self._last_chain = None if redo2 else again
                    if self.is_lost or self.init_failed:
                        return
                continue
            if self._sel_pot != pot_before:
                # only a keyframe's chain reads the rung: the frames in
                # flight before the first keyframe among them stand; a
                # graph's frame learns its decision at completion, so from
                # the first such frame on all go again (the JAX package's
                # re-dispatch)
                stale = list(q)
                first = next((j for j, r in enumerate(stale)
                              if not isinstance(r["need_kf"], bool)
                              or r["need_kf"]), len(stale))
                q.clear()
                q.extend(stale[:first])
                src = stale[first - 1] if first else self._last_chain
                for r in stale[first:]:
                    with self.telemetry.timed("redispatch", r["shell"].id):
                        src = self._dispatch_fused(r["image"], r["shell"],
                                                   r["exposure"], src,
                                                   r["stereo_right"])
                    q.append(src)

    def finish_pending(self) -> None:
        """Complete every frame in flight. Call it before reading the
        trajectory or the state at the end of a sequence. On a card, also
        credit the kernels' launch counters with the conditional graph
        nodes' runs so far (`ops/control.py`)."""
        self._drain_pending(0)
        if self._stamping:
            self._end_stamps()
        if self.device.type == "cuda":
            control.account(self.device)

    # ------------------------------------------------------------------
    # the fused frame's device stamps (utils/telemetry.py)
    # ------------------------------------------------------------------
    def _calibrate(self) -> None:
        """Map the card's clock onto the host's (`Telemetry.calibrate`):
        three stamps into the fused graph's clock slot, each between two
        host reads, the card waited for."""
        g = self.fused_graph
        self.telemetry.calibrate([control.clock_pair(g.stamps, g.clock_slot)
                                  for _ in range(3)])

    def _take_stamps(self, upto=None) -> None:
        """Hand the telemetry the device stamps of the graph dispatches,
        in stream order, up to `upto` (a record completing, its readback
        fetched): those before it were dispatched again or cleared,
        dropped unfetched, and count once their event has passed (so that
        their device time is not taken for idle). None: all of them (the
        card waited for)."""
        q = self._sent
        if q and self.telemetry.clock is None:
            self._calibrate()
        while q:
            r = q[0]
            done = r["readback"][2]
            if upto is not None and r is not upto and done is not None \
                    and not done.query():
                return
            q.popleft()
            self.telemetry.stamped(r["shell"].id,
                                   self._stamps_of(r["readback"]),
                                   r["intake"], r is upto, r["opens"])
            if r is upto:
                return

    def _end_stamps(self) -> None:
        """With no frame in flight: the dispatches dropped last, the last
        dispatch's `post.end` (read once the card is idle), then a new
        calibration, which closes the telemetry's device timeline."""
        g = self.fused_graph
        if self._sent:
            if g.on_card:
                torch.cuda.synchronize(self.device)
            self._take_stamps()
        if self.telemetry.clock is not None:
            self.telemetry.ended(int(g.stamps[TM.POST_END]))
        self._calibrate()
        self._stamping = False

    def prewarm(self, pots=(1, 2, 3, 4)) -> None:
        """Run the rare variants of the per-frame work once, so that their
        first-use costs land here and not in the steady frames: the kernel
        libraries' build and load, the 5-wide full and the 78-wide
        coarsest-level fallback tracks, and at each selector rung of
        `pots` the new-trace selection, the point marginalization before
        it and, on the fused path, one frame dispatch (on a zero image,
        from the host state), which on a card captures the rung's fused
        frame graph (`models/fused_graph.py`: the step, the decision and
        the keyframe chain; its warm-up runs the chain too), as the JAX
        prewarm compiles its programs. Records the rungs: the density
        adaptation then stays among them, as the JAX package's does.

        Pure dispatches on the current state: no state, key, rung or
        telemetry changes but the clock's calibration (`_calibrate`).
        Requires an initialized system with a built tracker template;
        completes the frames in flight first."""
        self.finish_pending()
        if not self.initialized or self.templates is None:
            return
        self._prewarmed_pots = {selector._snap_pot(p) for p in pots}
        pyr = self.frame_pyramids[self.ref_slot]
        if pyr is None:
            return
        cuda = self.device.type == "cuda"
        if cuda:
            cuda_build.build_all()
            for name in cuda_build.SOURCES:
                cuda_build.load(name)
        s = self.settings
        eye = np.eye(4, dtype=np.float32)
        exposures = self._t(np.ones(2, np.float32))
        for width, min_level in ((5, 0), (78, self.n_levels - 1)):
            TK.track_hypotheses(
                pyr, self.templates, self._t(np.stack([eye] * width)),
                self._t(np.zeros(2, np.float32)), self._t(self.ref_aff),
                exposures, self._intr, self.n_levels, min_level=min_level,
                coarse_cutoff_th=s.coarse_cutoff_th, huber=s.huber_th)
        # the dispatches below are no frames: their timers go nowhere
        telemetry = self.telemetry
        self.telemetry = Telemetry(device=self.device)
        saved_pot, saved_last = self._sel_pot, self._last_chain
        try:
            for i, pot in enumerate(pots):
                pot = selector._snap_pot(pot)
                # the JAX package compiles the selection twice, alone and
                # behind the point marginalization; eagerly it is one call
                self._marg_points(self.ba, self.dI, self.HdiF,
                                  self._flag_mask(()))
                self._select_insert(self.imm, pyr[0], 0,
                                    rng.fold_in(self.key, 990000 + i), pot)
                if self._fused_active():
                    self._sel_pot = pot
                    dummy = FrameShell(id=990000 + i, timestamp=0.0,
                                       cam_to_world=np.eye(4),
                                       aff=np.zeros(2),
                                       shell_idx=len(self.shells))
                    self._dispatch_fused(
                        torch.zeros(self.h, self.w, device=self.device),
                        dummy, 1.0, chain=None)
        finally:
            self.telemetry = telemetry
            self._sel_pot, self._last_chain = saved_pot, saved_last
        if cuda:
            torch.cuda.synchronize(self.device)
            control.account(self.device)
        if self.fused_graph is not None:
            self._sent.clear()          # its dispatches are no frames
            self._calibrate()
            self._stamping = False

    def trajectory(self, scaled: bool = False) -> np.ndarray:
        """poses.txt contract: one row `id x y z` per keyframe
        (LoopHandler::savePose); scaled=True uses the metric
        camToWorldScaled chain."""
        rows = []
        for sh in self.shells:
            if sh.is_kf:
                T = sh.cam_to_world_scaled if (
                    scaled and sh.cam_to_world_scaled is not None) \
                    else sh.cam_to_world
                t = T[:3, 3]
                rows.append([sh.id, t[0], t[1], t[2]])
        return np.array(rows)

    # ------------------------------------------------------------------
    # state hand-over between the chains and the system
    # ------------------------------------------------------------------
    def _state(self) -> dict:
        """The state a dispatch reads and a keyframe chain replaces. A
        record holds its own; nothing writes into its tensors after it was
        made."""
        return dict(ba=self.ba, imu=self.imu, imm=self.imm, dI=self.dI,
                    min_act=self.current_min_act_dist, HdiF=self.HdiF,
                    templates=self.templates, pc_l0=self.pc_l0, key=self.key)

    def _adopt(self, st: dict) -> None:
        (self.ba, self.imu, self.imm, self.dI, self.current_min_act_dist,
         self.HdiF, self.templates, self.pc_l0, self.key) = (
            st[k] for k in _STATE_KEYS)

    def _stage_readback(self, vals: dict):
        """Start the copy of the device values a completion reads (float32,
        bool) into one host buffer of this record's own: on a card, one
        non-blocking copy into pinned memory behind an event on the
        current stream. Returns the handle `_fetch` reads."""
        spec = [(k, tuple(v.shape), v.dtype) for k, v in vals.items()]
        return self._stage_flat(spec, torch.cat(
            [v.reshape(-1).to(torch.float32) for v in vals.values()]))

    def _stage_flat(self, spec, flat, counts=None):
        """`_stage_readback` of values already packed into `flat` after the
        layout `spec`; `counts`: `control.staged`'s run counts, which ride
        the same copy (as float32 pairs) and are credited at the fetch."""
        token = None
        if counts is not None:
            token, cnt = counts
            flat = torch.cat([flat, cnt.view(torch.float32)])
        if not flat.is_cuda:
            return spec, flat.clone(), None, token
        host = torch.empty(flat.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return spec, host, done, token

    @staticmethod
    def _fetch(staged) -> dict:
        """Wait for a staged readback and unpack it into numpy arrays of
        the staged shapes (bool where the value was bool, int64 where it
        rode as a bit view: `fused_graph.BITS`); credit the run counts it
        carries (`control.credit_staged`)."""
        spec, host, done, token = staged
        if done is not None:
            done.synchronize()
        flat = host.numpy()
        if token is not None:
            n = sum(_words(sh, dt) for _, sh, dt in spec)
            control.credit_staged(token, flat[n:].view(np.int64))
        out, at = {}, 0
        for k, shape, dtype in spec:
            n = _words(shape, dtype)
            a = flat[at:at + n].copy()
            if dtype == FU.BITS:
                a = a.view(np.int64)
            a = a.reshape(shape)
            out[k] = a.astype(bool) if dtype == torch.bool else a
            at += n
        return out

    @staticmethod
    def _stamps_of(staged):
        """The device stamps a fused frame's staged readback carries (its
        host copy, which the caller knows to be complete)."""
        spec, host, _, _ = staged
        at = 0
        for k, shape, dtype in spec:
            n = _words(shape, dtype)
            if k == "stamps":
                return host.numpy()[at:at + n].copy().view(np.int64)
            at += n
        raise KeyError("the readback carries no stamps")

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _initializer_step(self, pyr, absgrads, shell, exposure):
        if self.initializer is None:
            self.initializer = CI.set_first(pyr, absgrads, self.calib,
                                            self.settings, self.key)
            self.init_first_pyr = pyr
            self.init_first_shell = shell
            self.init_first_exposure = exposure
            shell.is_kf = True
            return
        self.initializer, done = CI.track_frame(
            self.initializer, self.init_first_pyr, pyr, self.calib,
            self.settings)
        if done:
            self._initialize_from_initializer(pyr, shell, exposure)

    def _gravity_aligned_pose(self) -> np.ndarray:
        """First keyframe pose: identity, or gravity-aligned from the first
        `min_g_imu` accelerometer samples with VIO (FullSystem.cpp:
        1012-1043)."""
        T0 = np.eye(4, dtype=np.float32)
        s = self.settings
        if s.enable_imu and len(self.imu_queue) >= 1:
            n_g = min(s.min_g_imu, len(self.imu_queue))
            g_imu = np.mean([np.asarray(q[1]) for q in self.imu_queue[:n_g]],
                            axis=0)
            g_imu = g_imu / max(np.linalg.norm(g_imu), 1e-9)
            g_w = np.asarray(s.gravity)
            g_w = g_w / max(np.linalg.norm(g_w), 1e-9)
            v = np.cross(g_imu, g_w)
            s_t, c_t = np.linalg.norm(v), float(g_imu @ g_w)
            axis = v / max(s_t, 1e-9)
            K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            rot_w_i0 = c_t * np.eye(3) + (1 - c_t) * np.outer(axis, axis) \
                + s_t * K
            ric = np.asarray(s.rot_imu_cam).reshape(3, 3)
            T0[:3, :3] = (rot_w_i0 @ ric).astype(np.float32)
        return T0

    def _initialize_from_initializer(self, pyr, shell, exposure):
        """FullSystem::initializeFromInitializer (FullSystem.cpp:933-1069)."""
        s = self.settings
        dev = self.device
        st = self.initializer
        lv0 = st.levels[0]
        good = lv0.valid & lv0.is_good
        init_scale = float(torch.sum(torch.where(good, lv0.iR,
                                                 torch.zeros_like(lv0.iR)))
                           / max(int(torch.sum(good)), 1))
        T0 = self._gravity_aligned_pose()
        # reinitialization: a carried-over pose overrides the fresh origin
        # (FullSystem.cpp:1040-1042: curPose kept unless ~identity)
        if self.initial_pose is not None and \
                np.linalg.norm(lie.np_se3_log(self.initial_pose)) > 1e-3:
            T0 = np.asarray(self.initial_pose, np.float32)
        first_shell = self.init_first_shell
        self.ba = WIN.insert_frame(
            self.ba, torch.as_tensor(T0, device=dev),
            torch.zeros(2, device=dev),
            torch.tensor(float(self.init_first_exposure), device=dev),
            self._prior_row(first=True))
        self.dI[0] = self.init_first_pyr[0]
        self.frame_pyramids[0] = self.init_first_pyr
        self.frame_shell_idx = [first_shell.shell_idx]
        self.kf_shell_ids.append(first_shell.id)
        first_shell.is_kf = True
        self.stats["n_kf"] += 1

        keep_p = s.desired_point_density / max(float(torch.sum(good)), 1.0)
        self.key, k = rng.split(self.key)
        u01 = rng.uniform(k, tuple(good.shape))
        keep = good & torch.as_tensor(u01 < np.float32(keep_p), device=dev)
        pat = B.pattern(dev)
        u = lv0.u + 0.5
        v = lv0.v + 0.5
        ptc = interp_bilinear(self.init_first_pyr[0],
                              u[:, None] + pat[None, :, 0],
                              v[:, None] + pat[None, :, 1])
        color = ptc[..., 0]
        g2 = torch.sum(ptc[..., 1:] ** 2, -1)
        oc = s.outlier_th_sum_component
        weights = torch.sqrt(oc / (oc + g2))
        keep &= torch.isfinite(color).all(-1)
        slot, accepted = WIN.scatter_into_free_slots(self.ba.pt_valid, keep)
        self.ba = WIN.insert_points(
            self.ba, slot, accepted,
            host=torch.zeros_like(lv0.u, dtype=torch.int32), u=u, v=v,
            color=color, weight=weights, idepth=lv0.iR / init_scale,
            prior_w=torch.full(lv0.u.shape, s.idepth_fix_prior, device=dev))

        T_fn = _np(st.T).copy()
        T_fn[:3, 3] *= init_scale
        T_nf = np.linalg.inv(T_fn)
        first_shell.cam_to_world = T0.astype(np.float64)
        shell.cam_to_world = T0 @ T_nf
        shell.tracking_ref = first_shell.id
        self.initialized = True
        self._deliver(pyr, shell, exposure, need_kf=True,
                      right=self._pending_right)

    def _prior_row(self, first: bool) -> torch.Tensor:
        """The new keyframe's prior row (made once: a copy from the
        host)."""
        row = self._prior_rows.get(first)
        if row is None:
            row = self._prior_rows[first] = self._make_prior_row(first)
        return row

    def _make_prior_row(self, first: bool) -> torch.Tensor:
        s = self.settings
        p = np.zeros(8, np.float32)
        if first:
            p[0:3] = s.initial_trans_prior
            p[3:6] = s.initial_rot_prior
            p[6] = s.initial_aff_a_prior
            p[7] = s.initial_aff_b_prior
        else:
            p[6] = (s.initial_aff_a_prior if s.affine_opt_mode_a < 0
                    else s.affine_opt_mode_a)
            p[7] = (s.initial_aff_b_prior if s.affine_opt_mode_b < 0
                    else s.affine_opt_mode_b)
        return torch.as_tensor(p, device=self.device)

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------
    def _motion_hypotheses(self, lag: int = 0, no_imu: bool = False):
        """lastF -> new initializations (FullSystem.cpp:148-215): the
        standard hypotheses, led by the IMU-predicted one when it exists
        and `no_imu` is False, and the 78 rotation-perturbed restarts."""
        ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]
        T_ref = ref_shell.cam_to_world
        hyps = [np.eye(4)]
        if len(self.shells) >= 3 + lag:
            slast = self.shells[-2 - lag]
            sprelast = self.shells[-3 - lag]
            if slast.pose_valid and sprelast.pose_valid \
                    and ref_shell.pose_valid:
                T_sl = slast.cam_to_world
                fh_2_sl = np.linalg.inv(sprelast.cam_to_world) @ T_sl
                lastF_2_sl = np.linalg.inv(T_sl) @ T_ref
                const = np.linalg.inv(fh_2_sl) @ lastF_2_sl
                dbl = np.linalg.inv(fh_2_sl) @ np.linalg.inv(fh_2_sl) \
                    @ lastF_2_sl
                half_xi = 0.5 * lie.np_se3_log(fh_2_sl)
                half = np.linalg.inv(lie.np_se3_exp(half_xi)) @ lastF_2_sl
                hyps = [const, dbl, half, lastF_2_sl, np.eye(4)]
                # IMU-predicted hypothesis first (FullSystem.cpp:163-173)
                if not no_imu:
                    imu_hyp = self._imu_hypothesis(T_ref, T_sl, const, lag)
                    if imu_hyp is not None:
                        hyps.insert(0, imu_hyp)
        base = hyps[0]
        rot_signs = [
            (1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0),
            (0, 0, -1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (-1, 1, 0),
            (0, -1, 1), (-1, 0, 1), (1, -1, 0), (0, 1, -1), (1, 0, -1),
            (-1, -1, 0), (0, -1, -1), (-1, 0, -1), (-1, -1, -1),
            (-1, -1, 1), (-1, 1, -1), (-1, 1, 1), (1, -1, -1), (1, -1, 1),
            (1, 1, -1), (1, 1, 1)]
        perturbed = []
        for delta in (0.02, 0.03, 0.04):
            for rs in rot_signs:
                q = np.array([1.0, rs[0] * delta, rs[1] * delta,
                              rs[2] * delta])
                Tp = np.eye(4)
                Tp[:3, :3] = lie.np_quat_to_rot(q)
                perturbed.append(base @ Tp)
        return hyps, perturbed

    def _imu_hypothesis(self, T_ref, T_slast, const_hyp, lag: int = 0):
        """Gyro-integrated rotation prediction for the tracker init, on the
        host in f64 (the classic path's `_imu_hypothesis`)."""
        if not (self.settings.enable_imu and self.imu_initialized
                and len(self.shells) >= 2 + lag):
            return None
        t0 = self.shells[-2 - lag].timestamp
        t1 = self.shells[-1 - lag].timestamp
        samples = [q for q in self.imu_queue if t0 < q[0] <= t1]
        if len(samples) < 2:
            return None
        bg = self._last_bg
        if bg is None:
            newest = len(self.frame_shell_idx) - 1
            bg = (_np(self.imu.state[newest]) * IM.IMU_SCALE21)[3:6]
        ric = np.asarray(self.settings.rot_imu_cam).reshape(3, 3)
        R = T_slast[:3, :3].copy()
        t_prev = t0
        for (t, _, g) in samples:
            dt = max(t - t_prev, 0.0)
            w_cam = ric.T @ (np.asarray(g) - bg)
            R = R @ lie.np_so3_exp(w_cam * dt)
            t_prev = t
        # translation from the constant-motion hypothesis
        T_pred = (T_ref @ np.linalg.inv(const_hyp)).copy()
        T_pred[:3, :3] = R
        return np.linalg.inv(T_pred) @ T_ref

    def _imu_hyp_device(self, T_prev, T_cw_ref, T_primary_const,
                        T_hyps_const, gyro_s, ts_s, valid_s, ts_thresh, bg):
        """Gyro-integrated rotation hypothesis from the staged IMU block's
        samples in (t_prev_frame, t_new] (FullSystem.cpp:163-173; the JAX
        package's `_imu_hyp_device`). With at least 2 samples in the
        window it becomes the primary hypothesis and the constant-motion
        one shifts into the retry batch, chosen on the device
        (`torch.where`): nothing is read back. `ts_thresh`: the window's
        start relative to the new frame, a 0-dim device tensor (the staged
        block's `thresh`) or a float."""
        if not torch.is_tensor(ts_thresh):
            ts_thresh = torch.full((), ts_thresh, device=self.device)
        ts_thresh = ts_thresh.reshape(1)
        in_win = valid_s & (ts_s > ts_thresh)
        ric, _ = IM._consts(self.settings, self.device)
        t_eff = torch.clamp(ts_s, min=ts_thresh)
        t_pre = torch.cat([ts_thresh, t_eff[:-1]])
        dts = torch.where(in_win, torch.clamp(t_eff - t_pre, min=0.0),
                          torch.zeros_like(t_eff))
        w_cam = (gyro_s - bg[None, :]) @ ric      # == (ric^T (g - bg))^T
        R = IM.ordered_rotations(T_prev[:3, :3], w_cam, dts)[-1]
        T_pred = (T_cw_ref @ lie.se3_inv(T_primary_const)).clone()
        T_pred[:3, :3] = R
        T_imu = lie.se3_inv(T_pred) @ T_cw_ref
        use = torch.sum(in_win) >= 2
        return (torch.where(use, T_imu, T_primary_const),
                torch.where(use, torch.cat([T_primary_const[None],
                                            T_hyps_const[:-1]], 0),
                            T_hyps_const))

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _frame_step(self, st, img, T_primary, T_hyps, T_cw_ref, aff0,
                    ref_aff, ref_exp, exposure, achieve_th):
        """The fused steady-state frame step (`_frame_step_jit`) on the
        state `st`, eagerly: the tracker leaves its loops early and the
        host reads each decision (the classic path, and the fused path
        with `cuda_graphs=False` or on the CPU). `models/frame_graph.py`
        is its device-decision form, bit for bit the same."""
        s = self.settings
        pyr, _ = build_pyramid(img, self.n_levels)
        exposures = torch.stack([ref_exp, exposure])
        kw = dict(coarse_cutoff_th=s.coarse_cutoff_th, huber=s.huber_th)
        nan6 = torch.full((6,), float("nan"), device=self.device)
        out = TK.track_newest_coarse(pyr, st["templates"], T_primary[None],
                                     aff0, ref_aff, exposures, nan6,
                                     self._intr, self.n_levels, **kw)
        if not bool(FG.primary_ok(out, achieve_th)):
            outb = TK.track_hypotheses(pyr, st["templates"], T_hyps, aff0,
                                       ref_aff, exposures, self._intr,
                                       self.n_levels, **kw)
            out = FG.pick(out, outb)
        accept = bool(FG.accepted(out, achieve_th, s.re_track_escalation))
        T_cw_new = T_cw_ref @ inv(out["T"][0])
        imm = st["imm"]
        if accept:
            imm = self._trace(st["ba"], imm, pyr[0], T_cw_new, out["aff"][0],
                              exposures[1])
        stats = self._frame_stats(st["ba"], imm)
        return pyr, out, imm, accept, T_cw_new, stats

    def _need_kf(self, out, accept, exposure_new, ref_exposure, first_rmse,
                 n_kf) -> bool:
        """The keyframe decision (FullSystem.cpp:709-732) in f32 from the
        step's outputs (`_need_kf_jit`), read on the host."""
        return accept and bool(FG.need_kf(
            out, accept, exposure_new, ref_exposure, first_rmse, n_kf == 0,
            self.settings, self.w, self.h))

    def _host_inputs(self, shell):
        """The fused frame's chained inputs from the host's bookkeeping (a
        dispatch from no record), with `prev_was_kf`."""
        s = self.settings
        # the predecessor by shell index, never [-2]: a frame that is
        # dispatched again has newer shells after it
        prev_sh = self.shells[shell.shell_idx - 1] \
            if shell.shell_idx >= 1 else None
        hyps, _ = self._motion_hypotheses(
            lag=len(self.shells) - 1 - shell.shell_idx,
            no_imu=s.enable_imu)
        ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]
        inp = dict(
            T_primary=self._t(np.asarray(hyps[0], np.float32)),
            T_hyps=self._t(np.stack(_pad_hyps(hyps[1:], 5))
                           .astype(np.float32)),
            aff=self._t(np.asarray(prev_sh.aff, np.float32)
                        if prev_sh is not None else np.zeros(2, np.float32)),
            th=self._t(np.float32(self.last_coarse_rmse[0]
                                  * s.re_track_threshold)),
            T_cw_ref=self._t(np.asarray(ref_shell.cam_to_world, np.float32)),
            ref_aff=self._t(self.ref_aff),
            ref_exp=self._t(np.float32(self.ref_exposure)),
            T_cw_prev=self._t(np.asarray(
                prev_sh.cam_to_world if prev_sh is not None else np.eye(4),
                np.float32)),
            rms0=self._t(np.float32(self.last_coarse_rmse[0])),
            first_rmse=self._t(np.float32(self.first_coarse_rmse)),
            n_kf=len(self.kf_shell_ids),
            host_out=self._t(self.host_out, torch.int64),
            scale_state=self._scale_state(),
            # the host queue is reconciled here: nothing to leave out
            t_last_kf=float("-inf"), last_kf=-1,
            n_frames=len(self.frame_shell_idx))
        return inp, bool(prev_sh.is_kf) if prev_sh is not None else False

    def _eager_inputs(self, chain):
        """A graph record's chained inputs as the eager dispatch reads
        them (host numbers; one read of the card): for a frame that leaves
        the graphs (a rung prewarm() left out)."""
        inp = dict(chain["nxt"])
        for k in ("n_kf", "last_kf"):
            inp[k] = int(inp[k])
        inp["t_last_kf"] = self.shells[inp["last_kf"]].timestamp \
            if inp["last_kf"] >= 0 else float("-inf")
        return inp, bool(chain["need_kf"])

    def _dispatch_fused(self, img, shell, exposure, chain, right=None):
        """Enqueue one frame of the fused path: step, decision, keyframe
        chain and the next frame's chained inputs, all from `chain` (the
        record of the frame before: its device state and `nxt` inputs) or,
        with None, from the host state. Stages the values its completion
        reads and makes no host bookkeeping: returns the record that
        `_complete_fused` completes. `right`: this frame's right image
        (stereo). On a card, one replay of the rung's fused frame graph
        (`_dispatch_graph`), else the eager form, which reads the decision
        on the host."""
        g = self.fused_graph
        if g is not None and g.has(self._sel_pot):
            return self._dispatch_graph(img, shell, exposure, chain, right)
        s = self.settings
        dev = self.device
        vio = s.enable_imu
        if chain is None:
            st = self._state()
            inp, prev_was_kf = self._host_inputs(shell)
        else:
            st = chain["state"]
            inp, prev_was_kf = (chain["nxt"], chain["need_kf"]) \
                if isinstance(chain["need_kf"], bool) \
                else self._eager_inputs(chain)
        # a frame fills no slot before its chain: the window's frame count
        # from the host's bookkeeping, or chained on the device from the
        # last keyframe's chain
        slot = inp["n_frames"]
        exp_t = self._t(np.float32(exposure))
        T_primary, T_hyps = inp["T_primary"], inp["T_hyps"]
        staged = bg = None
        if vio:
            staged = self._stage_imu(shell, inp["t_last_kf"],
                                     self._t_prev_frame(shell, chain))
            imu = st["imu"]
            bg = (at(imu.state, _clamp0(slot - 1))
                  * IM._s21(imu.state))[3:6]
            T_primary, T_hyps = self._imu_hyp_device(
                inp["T_cw_prev"], inp["T_cw_ref"], T_primary, T_hyps,
                staged["gyro"], staged["ts"], staged["valid"],
                staged["thresh"], bg)

        pyr, out, imm_new, accept, T_cw_new, stats_dev = \
            self._frame_step(st, img, T_primary, T_hyps, inp["T_cw_ref"],
                             inp["aff"], inp["ref_aff"], inp["ref_exp"],
                             exp_t, inp["th"])
        need_kf = self._need_kf(out, accept, exp_t, inp["ref_exp"],
                                inp["first_rmse"], inp["n_kf"])
        accept_t = torch.tensor(accept, device=dev)
        aff_new = out["aff"][0]
        n_kf = inp["n_kf"]
        rec = dict(shell=shell, exposure=exposure, image=img,
                   stereo_right=right, pyr=pyr, need_kf=need_kf,
                   pot=self._sel_pot)
        back = dict(T_cw_new=T_cw_new, accept=accept_t,
                    **{"out." + k: out[k] for k in _OUT_KEYS})
        if need_kf:
            if g is not None:
                g.eager["rung"] += 1
            args = (st, imm_new, pyr, T_cw_new, aff_new, exp_t, stats_dev,
                    inp["host_out"], n_kf, shell.id, self._max_its(n_kf + 1),
                    inp["scale_state"], self._sel_pot, right)
            chain_out = self._kf_chain_vio(*args, staged, staged["t_kf"]) \
                if vio else self._kf_chain(*args)
            rec.update(chain_out)
            back.update(self._kf_readback(chain_out))
            bg = chain_out.get("bg")
            kf_slot = chain_out["slot"]
            T_kf = at(chain_out["T_cw_all_t"], kf_slot)
            aff_kf = at(chain_out["affs_t"], kf_slot)
            T_me, T_ref_n = T_kf, T_kf
            T_prev_f = at(chain_out["T_cw_all_t"], _clamp0(kf_slot - 1)) \
                if prev_was_kf else inp["T_cw_prev"]
            aff_n, ref_aff_n, ref_exp_n = aff_kf, aff_kf, exp_t
            host_out_n = chain_out["host_out"]
            scale_n = chain_out["scale_out"][:3]
            t_last_kf_n, last_kf_n = shell.timestamp, shell.shell_idx
            n_frames_n = kf_slot + 1 \
                - torch.sum(chain_out["marg_ks"] >= 0)
        else:
            rec["state"] = dict(st, imm=imm_new)
            T_me, T_ref_n, T_prev_f = T_cw_new, inp["T_cw_ref"], \
                inp["T_cw_prev"]
            aff_n, ref_aff_n, ref_exp_n = aff_new, inp["ref_aff"], \
                inp["ref_exp"]
            host_out_n = inp["host_out"]
            scale_n = inp["scale_state"]
            t_last_kf_n, last_kf_n = inp["t_last_kf"], inp["last_kf"]
            n_frames_n = slot
        rec["host_out"] = host_out_n
        if vio:
            back["bg"] = bg

        # next-frame chaining inputs (FullSystem.cpp:148-173), in f32
        nxt = FG.chain_inputs(T_prev_f, T_me, T_ref_n, out["residuals"][0, 0],
                              inp["rms0"], inp["first_rmse"], accept_t,
                              s.re_track_threshold)
        rec["nxt"] = dict(
            nxt, aff=aff_n, T_cw_ref=T_ref_n, ref_aff=ref_aff_n,
            ref_exp=ref_exp_n, T_cw_prev=T_me, n_kf=n_kf + int(need_kf),
            host_out=host_out_n, scale_state=scale_n, t_last_kf=t_last_kf_n,
            last_kf=last_kf_n, n_frames=n_frames_n)
        rec["readback"] = self._stage_readback(back)
        return rec

    def _t_prev_frame(self, shell, chain) -> float:
        """The time of the frame before `shell` (the IMU hypothesis'
        window start)."""
        if chain is not None:
            return chain["shell"].timestamp
        if shell.shell_idx >= 1:
            return self.shells[shell.shell_idx - 1].timestamp
        return shell.timestamp - 1.0

    def _dispatch_graph(self, img, shell, exposure, chain, right=None):
        """`_dispatch_fused` on a card: one replay of the fused frame
        graph of the selector rung (`models/fused_graph.py`), which reads
        nothing on the host. The record keeps the decision as a device
        bool, clones of the state and of the next frame's inputs, and the
        pinned readback with the conditional nodes' run counts; the host
        learns the decision when the frame completes."""
        g = self.fused_graph
        if chain is None:
            st = self._state()
            inp, prev_was_kf = self._host_inputs(shell)
        else:
            st, inp, prev_was_kf = chain["state"], chain["nxt"], \
                chain["need_kf"]
        block = self._stage_imu_block(shell, self._t_prev_frame(
            shell, chain)) if self.settings.enable_imu else None
        held = g.graphs.get(self._sel_pot)
        got = g.dispatch(st, inp, prev_was_kf, chain, img, exposure,
                         rng.fold_in(st["key"], shell.id), right,
                         shell.shell_idx, block, self._sel_pot,
                         self._exporting())
        # the frame's first dispatch carries its intake's stamps
        intake = g.intake_for == shell.id
        if intake:
            g.intake_for = None
        rec = dict(shell=shell, exposure=exposure, image=img,
                   stereo_right=right, pyr=got["pyr"],
                   need_kf=got["need_kf"], pot=self._sel_pot,
                   state=dict(st, **got["state"]), nxt=got["nxt"],
                   intake=intake,
                   opens=g.graphs.get(self._sel_pot) is not held)  # captured
        rec["readback"] = self._stage_flat(got["spec"], got["flat"],
                                           control.staged(self.device))
        control.stamp(g.stamps, TM.POST_END)
        g.last = rec
        self._sent.append(rec)
        self._stamping = True
        return rec

    @staticmethod
    def _kf_readback(chain_out) -> dict:
        """The device values of a keyframe chain that `_finish_kf` reads
        (the tuple `_kf_chain_jit` returns for its readback): the BA's
        stats, the window's poses and affines, the slot, the flagged slots,
        the selection count and the dead-point counts."""
        st = chain_out["ba_stats"]
        back = dict(T_cw_all_t=chain_out["T_cw_all_t"],
                    affs_t=chain_out["affs_t"])
        dev = chain_out["slot"].device
        back.update({k: st[k] if torch.is_tensor(st[k])
                     else torch.full((), float(st[k]), device=dev)
                     for k in ("energy", "rmse", "n_its", "n_active",
                               "is_lost")})
        back.update({k: chain_out[k] for k in
                     ("slot", "marg_ks", "n_have", "host_out")})
        back.update(zip(("scale_s", "scale_trapped", "scale_fails",
                         "scale_err"), chain_out["scale_out"]))
        return back

    def _complete_fused(self, rec) -> bool:
        """Host bookkeeping of one dispatched fused frame from its one
        readback: the adopted state, the IMU queue, the shell's pose and
        affine, the keyframe's window bookkeeping, rung adaptation and
        exports. Returns True when the frames chained from this record
        are invalid (fallback tracking, or lost)."""
        shell, exposure = rec["shell"], rec["exposure"]
        got = self._fetch(rec["readback"])
        need_kf = rec["need_kf"]
        if not isinstance(need_kf, bool):
            # a graph's frame: the decision and the export's values come
            # with the readback
            need_kf = bool(got["need_kf"])
            self.fused_graph.frame.retries += int(got["miss"])
            self.telemetry.observe("track.retry", got["miss"])
            self.telemetry.observe("track.lm_trips", got["lm_trips"])
            self._take_stamps(rec)
            if need_kf:
                self.fused_graph.chains[rec["pot"]] += 1
                if "marg" in got:
                    rec.update(marg=torch.from_numpy(got["marg"]),
                               marg_pts=tuple(torch.from_numpy(
                                   got[f"marg_pts.{i}"]) for i in range(4)),
                               ecols=got["ecols"])
        self._adopt(rec["state"])
        if self.settings.enable_imu:
            # gyro bias for the host IMU hypothesis of the fallback path
            self._last_bg = got["bg"].astype(np.float64)
            if need_kf:
                # the chain consumed the staged sample block; mirror it on
                # the host queue (setImuData's split)
                self.imu_queue = [q for q in self.imu_queue
                                  if q[0] > shell.timestamp]
        if need_kf:
            self.host_out = got["host_out"].astype(np.int64)
        out_np = {k: got["out." + k] for k in _OUT_KEYS}
        accept = bool(got["accept"])
        tres = self._finish_step_host(rec, out_np, accept, got["T_cw_new"])
        if tres is None:
            self.is_lost = True
            return True
        for ow in self.output_wrappers:
            ow.publish_cam_pose(shell, None)
        if not accept:
            # fallback tracking was used: decide classically
            need_kf = self._keyframe_decision(tres, shell)
            self._deliver(rec["pyr"], shell, exposure, need_kf,
                          right=rec["stereo_right"])
            return True
        if need_kf:
            if int(got["slot"]) >= self.F:
                raise RuntimeError("window overflow — marginalization failed")
            self._finish_kf(rec, got, classic=False)
        return False

    def _finish_step_host(self, p, out, accept, T_cw_new):
        """Host completion of a frame step: the rotation-restart fallback
        when the step refused the frame, then the shell pose/affine
        update."""
        s = self.settings
        shell = p["shell"]
        pyr = p["pyr"]
        ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]

        def run_batch(T_list, aff0, min_level=0):
            # made here, not above: a copy from the host that a frame
            # without fallback would wait for
            exposures = self._t(np.array([self.ref_exposure,
                                          p["exposure"]], np.float32))
            Ts = self._t(np.stack([np.asarray(t, np.float32)
                                   for t in T_list]))
            o = TK.track_hypotheses(pyr, self.templates, Ts, self._t(aff0),
                                    self._t(self.ref_aff), exposures,
                                    self._intr, self.n_levels,
                                    min_level=min_level,
                                    coarse_cutoff_th=s.coarse_cutoff_th,
                                    huber=s.huber_th)
            return {k: _np(v) for k, v in o.items()}

        def pick(o, lvl=0):
            res = o["residuals"][:, lvl]
            ok = o["good"] & np.isfinite(res)
            if not ok.any():
                return None, np.inf
            c = np.where(ok)[0]
            b = c[np.argmin(res[c])]
            return int(b), float(res[b])

        achieve_th = self.last_coarse_rmse[0] * s.re_track_threshold
        best, achieved = pick(out)
        if not accept and (best is None or achieved >= achieve_th):
            _, perturbed = self._motion_hypotheses(
                lag=len(self.shells) - 1 - shell.shell_idx)
            aff0 = np.asarray(self.shells[shell.shell_idx - 1].aff,
                              np.float32) \
                if shell.shell_idx >= 1 else np.zeros(2, np.float32)
            coarse = run_batch(perturbed, aff0,
                               min_level=self.n_levels - 1)
            res_c = coarse["residuals"][:, self.n_levels - 1]
            res_c = np.where(np.isfinite(res_c), res_c, np.inf)
            top2 = np.argsort(res_c)[:2]
            out3 = run_batch(_pad_hyps([perturbed[i] for i in top2], 5),
                             aff0)
            b3, a3 = pick(out3)
            if b3 is not None and a3 < achieved:
                out, best, achieved = out3, b3, a3
        if best is None:
            shell.pose_valid = False
            shell.cam_to_world = self.shells[shell.shell_idx - 1] \
                .cam_to_world if shell.shell_idx >= 1 else np.eye(4)
            return None
        T_ref_to_new = out["T"][best]
        aff = out["aff"][best]
        residuals = out["residuals"][best]
        shell.cam_to_world = T_cw_new if accept else \
            ref_shell.cam_to_world @ np.linalg.inv(T_ref_to_new)
        shell.aff = aff
        shell.tracking_ref = ref_shell.id
        self.last_coarse_rmse = np.where(np.isfinite(residuals), residuals,
                                         self.last_coarse_rmse)
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = float(residuals[0])
        return dict(res=residuals, flow=out["flow"][best], aff=aff,
                    T_ref_to_new=T_ref_to_new, exposure=p["exposure"])

    def _keyframe_decision(self, tres, shell) -> bool:
        """Optical-flow/brightness heuristic (FullSystem.cpp:709-732)."""
        s = self.settings
        if len(self.kf_shell_ids) == 0:
            return True
        a_ref = np.exp(tres["aff"][0]) * tres["exposure"] \
            / max(self.ref_exposure, 1e-9)
        flow_t, flow_rt = tres["flow"]
        wh = self.w + self.h
        score = (s.kf_global_weight * s.max_shift_weight_t
                 * np.sqrt(max(flow_t, 0)) / wh
                 + s.kf_global_weight * s.max_shift_weight_rt
                 * np.sqrt(max(flow_rt, 0)) / wh
                 + s.kf_global_weight * s.max_affine_weight
                 * abs(np.log(max(a_ref, 1e-9))))
        return bool(score > 1.0 or 2.0 * self.first_coarse_rmse
                    < tres["res"][0])

    def _track_classic(self, img, shell, exposure):
        """The classic frame (the VIO bootstrap): the same frame step from
        host-computed inputs, the host keyframe decision in f64, then a
        keyframe or the trace (`_track_new_coarse` + `_finish_tracked`)."""
        s = self.settings
        ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]
        aff0 = np.asarray(self.shells[shell.shell_idx - 1].aff, np.float32) \
            if shell.shell_idx >= 1 else np.zeros(2, np.float32)
        hyps, _ = self._motion_hypotheses(
            lag=len(self.shells) - 1 - shell.shell_idx)
        exp_t = self._t(np.float32(exposure))
        pyr, out, imm_new, accept, T_cw_new, stats = self._frame_step(
            self._state(), img, self._t(np.asarray(hyps[0], np.float32)),
            self._t(np.stack(_pad_hyps(hyps[1:], 5)).astype(np.float32)),
            self._t(np.asarray(ref_shell.cam_to_world, np.float32)),
            self._t(aff0), self._t(self.ref_aff),
            self._t(np.float32(self.ref_exposure)), exp_t,
            self._t(np.float32(self.last_coarse_rmse[0]
                               * s.re_track_threshold)))
        if accept:
            self.imm = imm_new
        rec = dict(shell=shell, exposure=exposure, pyr=pyr)
        tres = self._finish_step_host(rec, {k: _np(v) for k, v in out.items()},
                                      accept, _np(T_cw_new))
        if tres is None:
            self.is_lost = True
            return
        need_kf = self._keyframe_decision(tres, shell)
        for ow in self.output_wrappers:
            ow.publish_cam_pose(shell, None)
        self._deliver(pyr, shell, exposure, need_kf, traced=accept,
                      stats=stats, right=self._pending_right)

    def _deliver(self, pyr, shell, exposure, need_kf: bool,
                 traced: bool = False, stats=None, right=None):
        """A tracked frame's classic completion: a keyframe, or the trace
        when the step did not already run it. `right`: the frame's right
        image (stereo)."""
        if need_kf:
            if self.settings.enable_imu:
                self._make_keyframe_vio(pyr, shell, exposure, traced, stats,
                                        right)
            else:
                self._make_keyframe(pyr, shell, exposure, right)
        elif not traced:
            self.imm = self._trace(
                self.ba, self.imm, pyr[0],
                self._t(np.asarray(shell.cam_to_world, np.float32)),
                self._t(np.asarray(shell.aff, np.float32)),
                self._t(np.float32(exposure)))

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def _max_its(self, n_kf_after: int) -> int:
        """Windowed-BA iteration budget, higher during bootstrap."""
        if n_kf_after < 3:
            return 20
        if n_kf_after < 4:
            return 15
        return self.settings.max_opt_iterations

    def _make_keyframe(self, pyr, shell, exposure, right=None):
        """The classic vision keyframe path (first keyframe after
        initialization and refused frames): trace + stats, then the same
        chain."""
        T_cw = self._t(np.asarray(shell.cam_to_world, np.float32))
        aff = self._t(np.asarray(shell.aff, np.float32))
        exp_t = self._t(np.float32(exposure))
        imm = self._trace(self.ba, self.imm, pyr[0], T_cw, aff, exp_t)
        stats = self._frame_stats(self.ba, imm)
        slot = len(self.frame_shell_idx)
        if slot >= self.F:
            raise RuntimeError("window overflow — marginalization failed")
        n_kf = len(self.kf_shell_ids)
        rec = dict(shell=shell, exposure=exposure, pyr=pyr,
                   pot=self._sel_pot)
        rec.update(self._kf_chain(
            self._state(), imm, pyr, T_cw, aff, exp_t, stats,
            self._t(self.host_out, torch.int64), n_kf, shell.id,
            self._max_its(n_kf + 1), self._scale_state(), self._sel_pot,
            right, classic=True))
        got = self._fetch(self._stage_readback(self._kf_readback(rec)))
        self._adopt(rec["state"])
        self.host_out = got["host_out"].astype(np.int64)
        self._finish_kf(rec, got, classic=True)

    def _finish_kf(self, rec, got, classic: bool):
        """Host bookkeeping of a keyframe from its chain's values and their
        readback `got`."""
        s = self.settings
        shell = rec["shell"]
        slot = int(got["slot"])
        marg_ks = [int(k) for k in got["marg_ks"] if k >= 0]
        self.telemetry.observe("ba.gn_its", got["n_its"])
        self.frame_pyramids[slot] = rec["pyr"]
        self.frame_shell_idx.append(shell.shell_idx)
        self.kf_shell_ids.append(shell.id)
        shell.is_kf = True
        self.stats["n_kf"] += 1
        n_kf = len(self.kf_shell_ids)
        rmse = float(got["rmse"])
        if bool(got["is_lost"]):
            self.is_lost = True
            return
        if (n_kf == 2 and rmse > 25) or (n_kf == 3 and rmse > 15) or \
                (n_kf == 4 and rmse > 10):
            self.init_failed = True
            return
        T_cw, affs = got["T_cw_all_t"], got["affs_t"]
        for i, sh_idx in enumerate(self.frame_shell_idx):
            self.shells[sh_idx].cam_to_world = T_cw[i]
            self.shells[sh_idx].aff = affs[i]
        self.ref_slot = len(self.frame_shell_idx) - 1
        self.ref_aff = np.asarray(shell.aff, np.float32)
        self.ref_exposure = rec["exposure"]
        if s.enable_scale_opt:
            shell.scale_error = float(got["scale_err"])
            self.current_scale = float(got["scale_s"])
            self.scale_trapped = bool(got["scale_trapped"])
            self.scale_opt_fails = int(got["scale_fails"])
        elif s.enable_imu:
            # VIO-mono: the chain's scale trapping moved imu.scale
            self.current_scale = float(got["scale_s"])
        self._update_scaled_poses()

        # selector potential adaptation (PixelSelector2.cpp K-model)
        pot = rec["pot"]
        density = float(s.desired_immature_density)
        quotia = density / max(int(got["n_have"]), 1)
        redo = None
        if quotia > 1.25 and pot > 1:
            redo = selector.pot_step(pot, up=False)
        elif quotia < 0.25:
            redo = selector.pot_step(pot, up=True)
        warm = self._prewarmed_pots
        if redo is not None and warm is not None and redo not in warm:
            redo = None      # a rung that prewarm() did not warm
        if redo is not None and redo != pot:
            if classic and not marg_ks:
                # the classic path re-selects within the same keyframe
                k2 = rng.fold_in(rng.fold_in(self.key, shell.id), 1)
                self.imm, _ = self._select_insert(
                    rec["imm_pre_select"], rec["pyr"][0], slot, k2, redo)
            self._sel_pot = redo

        exporting = self._exporting()
        if exporting:
            self._cache_marg_points(rec["marg"], rec["marg_pts"])
            self._publish_kf(shell, rec["pyr"])
            ecols = _np(rec["ecols"]) if torch.is_tensor(rec["ecols"]) \
                else rec["ecols"]
        for j, k in enumerate(marg_ks):  # descending: lower slots
            self.shells[self.frame_shell_idx[k]].marginalized_at = \
                len(self.shells)
            kf_record = self._export_kf(k, float(ecols[j][0]),
                                        int(ecols[j][1])) \
                if exporting else None
            self._drop_slot(k)
            self._emit(kf_record)

    def _kf_chain(self, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                  host_out, n_kf: int, shell_id: int, max_its: int,
                  scale_state, pot: int, right, classic: bool = False):
        """The vision keyframe chain (`_kf_chain_jit`'s run branch) on the
        state `st`: `models/chain_graph.py`'s body (flags, the mega-step,
        with stereo the scale solve on the fresh template and the right
        image `right`, point marginalization + selection at rung `pot`,
        the flagged frames' marginalizations, the image-stack compaction),
        run eagerly (on a card the fused frame graph runs the same body
        inside its frame, `models/fused_graph.py`). `host_out`: (F,) device ints; `scale_state`: (s,
        trapped, fails) device tensors. The image stack is copied before
        the new slot is written: the record it came from may be dispatched
        from again. A classic keyframe runs eagerly (its completion may
        select again)."""
        return self._run_chain(
            st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out,
            n_kf, shell_id, max_its, pot,
            CG.keyframe_inputs(self, right, scale_state), classic)

    def _kf_chain_vio(self, st, imm, pyr, T_cw_new, aff_new, exposure,
                      stats, host_out, n_kf: int, shell_id: int,
                      max_its: int, scale_state, pot: int, right, staged,
                      timestamp):
        """The VIO keyframe chain (`_kf_chain_vio_jit`'s run branch) on the
        state `st`: insert + IMU-sample intake + spline propagation +
        activation + the visual-inertial KKT BA + the stereo scale solve or
        the scale trapping + VIO point/frame marginalization + new-trace
        selection (`chain_graph.kf_chain_vio_body`), replayed as the
        chain's CUDA graphs or run eagerly as `_kf_chain`. `staged`: the
        frame's staged IMU block, `timestamp` the keyframe's (0-dim)."""
        return self._run_chain(
            st, imm, pyr, T_cw_new, aff_new, exposure, stats, host_out,
            n_kf, shell_id, max_its, pot,
            CG.keyframe_inputs(self, right, scale_state, staged, timestamp))

    def _run_chain(self, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                   host_out, n_kf: int, shell_id: int, max_its: int,
                   pot: int, kf: dict, classic: bool = False):
        """A keyframe chain run eagerly: the eager dispatch's, and with
        the graphs a classic keyframe's (counted in `fused_graph.eager`;
        a frame at a rung prewarm() left out is counted at its
        dispatch)."""
        key = rng.fold_in(st["key"], shell_id)
        g = self.fused_graph
        if g is not None and classic:
            g.eager["classic"] += 1
        keys = torch.as_tensor(CG.selection_keys(key), device=self.device)
        body = CG.kf_chain_vio_body if self.settings.enable_imu \
            else CG.kf_chain_body
        out = body(self, st, imm, pyr, T_cw_new, aff_new, exposure, stats,
                   host_out, n_kf, keys, pot, max_its, False, kf)
        out["state"] = dict(st, **out["state"])
        return out

    def _kf_core_vio(self, ba, imu, dI, pyr, max_its: int):
        """Windowed visual-inertial BA + HdiF + tracker template + poses
        (`_kf_core_vio_jit`) of the classic VIO keyframe."""
        s = self.settings
        ba, imu, ba_stats = E.optimize_vio(ba, imu, dI, s, self.w, self.h,
                                           max_its=max_its,
                                           min_its=s.min_opt_iterations)
        HdiF = ba_stats["HdiF"]
        templates, pc_l0 = WIN.build_track_template(
            ba, HdiF, pyr, len(pyr), self.tmpl_sizes, self.w, self.h)
        return (ba, imu, ba_stats, HdiF, templates, pc_l0,
                B.state_to_pose(ba.T_cw_eval, ba.state), B.aff_real(ba.state))

    def _stereo_solve(self) -> bool:
        """Whether keyframes solve the stereo scale."""
        return self.stereo is not None and self.settings.enable_scale_opt

    def _scale_state(self):
        """The host's scale state (s, trapped, fails) as device tensors,
        made by fills (no copy from the host)."""
        dev = self.device
        return (torch.full((), float(np.float32(self.current_scale)),
                           device=dev),
                torch.full((), bool(self.scale_trapped), dtype=torch.bool,
                           device=dev),
                torch.full((), int(self.scale_opt_fails), dtype=torch.int32,
                           device=dev))

    def _scale_solve(self, templates, kf: dict, bounded: bool):
        """The stereo 1-DoF scale solve of the keyframe's right image on
        its template with trapping and fail counting (FullSystem::
        optimizeScale; the chains' in-chain solve, `_kf_chain_vio_jit`'s
        at sos_slam_tpu/models/full_system.py:2299-2325), on device
        tensors: `kf` holds the right image (None: no solve), `have_right`
        and the scale state (s, trapped, fails). Returns (s, trapped,
        fails, error), 0-dim device tensors; without a right image (or
        without stereo) the state passes through with error -1.

        Eagerly the host reads `trapped` and runs its branch with the
        early-exit loops. `bounded` reads nothing back: the right image's
        pyramid (K1) and the solve run under `control.cond(have_right)`,
        the trapped solve from s (one guess) and the multi-guess one
        (seven) are the two branches of `control.cond(trapped)` (the JAX
        chain's `lax.cond(trapped, do_trap, do_multi)`), and the scale
        LM's loops are `control.while_loop`s: inside a capture,
        conditional nodes."""
        s_cur, trapped, fails = kf["scale_state"]
        right = kf["right"]
        if not self._stereo_solve() or right is None:
            return (s_cur, trapped, fails, torch.full_like(s_cur, -1.0))
        R01, t01, intr1 = self._lr
        args = (R01, t01, self._intr, intr1, self.n_levels)
        have = kf["have_right"]
        if bounded:
            res = (s_cur.clone(), torch.full_like(s_cur, -1.0))

            def solve():
                pyr_r, _ = build_pyramid(right, self.n_levels)
                got = (torch.empty_like(s_cur), torch.empty_like(s_cur))
                control.cond(
                    trapped,
                    lambda: [x[0] for x in SO.scale_lm(
                        pyr_r, templates, s_cur.reshape(1), *args,
                        bounded=True)[:2]],
                    lambda: SO.multi_guess(pyr_r, templates, *args,
                                           bounded=True),
                    out=got)
                return got

            control.cond(have, solve, None, out=res)
            sv, err = res
        else:
            pyr_r, _ = build_pyramid(right, self.n_levels)
            if bool(trapped):
                sv, err = (x[0] for x in SO.scale_lm(
                    pyr_r, templates, s_cur.reshape(1), *args))
            else:
                sv, err = SO.multi_guess(pyr_r, templates, *args)
            err = torch.where(have, err, torch.full_like(err, -1.0))
        ok = (err > 0) & (err < self.settings.scale_opt_thres)
        fails = torch.where(ok, torch.zeros_like(fails),
                            torch.where(have, fails + 1, fails))
        trapped = ok | torch.where(have, trapped & (fails <= 5), trapped)
        return (torch.where(ok, sv, s_cur), trapped, fails, err)

    def _update_scaled_poses(self):
        """camToWorldScaled chain (FullSystemOptimize.cpp:437-456): every
        window shell takes the CURRENT global scale, then the scaled chain
        is rebuilt through each frame's tracking reference."""
        by_id = self._shell_by_id
        for i in self.frame_shell_idx:
            sh = self.shells[i]
            sh.scale = self.current_scale
            ref = by_id.get(sh.tracking_ref) \
                if sh.tracking_ref is not None else None
            if ref is None or ref.cam_to_world_scaled is None:
                sh.cam_to_world_scaled = sh.cam_to_world.copy()
                continue
            rel = (np.linalg.inv(ref.cam_to_world) @ sh.cam_to_world).copy()
            rel[:3, 3] *= ref.scale
            sh.cam_to_world_scaled = ref.cam_to_world_scaled @ rel

    # ------------------------------------------------------------------
    # the classic VIO keyframe (the bootstrap; _make_keyframe's IMU branch)
    # ------------------------------------------------------------------
    def _make_keyframe_vio(self, pyr, shell, exposure, traced=False,
                           stats=None, right=None):
        """FullSystem::makeKeyFrame with the IMU enabled, step by step as
        the JAX package's classic path runs it: host flags, insertion,
        IMU-sample intake (+ propagation once initialized), activation,
        the IMU initialization at the 5th keyframe, the BA (vision or
        VIO), the scale solve or trapping, point marginalization, new
        traces and the flagged frames' marginalizations."""
        s = self.settings
        dev = self.device
        if not traced:
            self.imm = self._trace(
                self.ba, self.imm, pyr[0],
                self._t(np.asarray(shell.cam_to_world, np.float32)),
                self._t(np.asarray(shell.aff, np.float32)),
                self._t(np.float32(exposure)))
            stats = self._frame_stats(self.ba, self.imm)
        marg_flags = self._flag_frames_for_marginalization(stats) \
            if len(self.frame_shell_idx) >= s.min_frames else []

        slot = len(self.frame_shell_idx)
        if slot >= self.F:
            raise RuntimeError("window overflow — marginalization failed")
        prior_row = self._prior_row(first=len(self.kf_shell_ids) == 0)
        self.frame_pyramids[slot] = pyr
        self.frame_shell_idx.append(shell.shell_idx)
        self.kf_shell_ids.append(shell.id)
        shell.is_kf = True
        self.stats["n_kf"] += 1
        n_kf = len(self.kf_shell_ids)
        max_its = self._max_its(n_kf)

        self.ba = WIN.insert_frame(
            self.ba, self._t(np.asarray(shell.cam_to_world, np.float32)),
            self._t(np.asarray(shell.aff, np.float32)),
            self._t(np.float32(exposure)), prior_row)
        self.dI = self.dI.clone()   # a record may hold the stack
        self.dI[slot] = pyr[0]
        self._set_imu_data(slot, shell)
        if self.imu_initialized:
            self._propagate_imu(slot, shell)
        self.ba, self.imm, self.current_min_act_dist = self._activate(
            self.ba, self.imm, self.dI, self.current_min_act_dist)

        # IMU initialization at the 5th keyframe (FullSystem.cpp:841-848)
        if n_kf == 5 and not self.imu_initialized:
            self.imu, ok = IM.initialize_imu(self.ba, self.imu, s)
            if not bool(ok):
                self.init_failed = True
                return
            self.imu_initialized = True

        if self.imu_initialized:
            (self.ba, self.imu, ba_stats, self.HdiF, self.templates,
             self.pc_l0, T_cw_j, affs_j) = self._kf_core_vio(
                self.ba, self.imu, self.dI, pyr, max_its)
        else:
            self.ba, ba_stats = E.optimize(self.ba, self.dI, s, self.w,
                                           self.h, max_its=max_its,
                                           min_its=s.min_opt_iterations)
            self.HdiF = ba_stats["HdiF"]
            self.templates, self.pc_l0 = WIN.build_track_template(
                self.ba, self.HdiF, pyr, len(pyr), self.tmpl_sizes, self.w,
                self.h)
            T_cw_j = B.state_to_pose(self.ba.T_cw_eval, self.ba.state)
            affs_j = B.aff_real(self.ba.state)

        rmse = float(ba_stats["rmse"])
        if bool(ba_stats["is_lost"]):
            self.is_lost = True
            return
        if (n_kf == 2 and rmse > 25) or (n_kf == 3 and rmse > 15) or \
                (n_kf == 4 and rmse > 10):
            self.init_failed = True
            return
        T_cw, affs = _np(T_cw_j), _np(affs_j)
        for i, sh_idx in enumerate(self.frame_shell_idx):
            self.shells[sh_idx].cam_to_world = T_cw[i]
            self.shells[sh_idx].aff = affs[i]
        self.ref_slot = len(self.frame_shell_idx) - 1
        self.ref_aff = np.asarray(shell.aff, np.float32)
        self.ref_exposure = exposure

        # stereo scale optimization (optimizeScale, FullSystem.cpp:1117-1180)
        if s.enable_scale_opt:
            sv, trapped, fails, err = self._scale_solve(
                self.templates,
                CG.keyframe_inputs(self, right, self._scale_state()), False)
            shell.scale_error = float(err)
            self.current_scale = float(sv)
            self.scale_trapped = bool(trapped)
            self.scale_opt_fails = int(fails)

        # IMU post-BA bookkeeping: scale trapping + FEJ reset at init KF
        if self.imu_initialized:
            if n_kf == 5:
                self.imu = self.imu._replace(state_zero=self.imu.state)
            if s.enable_scale_opt:
                self.imu = self.imu._replace(
                    scale=torch.tensor(np.float32(self.current_scale
                                                  / IM.SCALE_SCALE),
                                       device=dev),
                    scale_trapped=torch.ones((), dtype=torch.bool,
                                             device=dev))
            elif not bool(self.imu.scale_trapped):
                self.imu = IM.try_trap_scale(self.imu, s.scale_trap_thres)
                if bool(self.imu.scale_trapped):
                    self.imu = self.imu._replace(state_zero=self.imu.state)
            if not s.enable_scale_opt:
                self.current_scale = float(self.imu.scale) * IM.SCALE_SCALE
        self._last_bg = None   # the device bias moved; drop the host copy
        self._update_scaled_poses()

        self._flag_and_marginalize_points(marg_flags)
        if self._exporting():
            self._publish_kf(shell, pyr)
        self._make_new_traces(pyr, slot)
        self._marginalize_frames(marg_flags)

    def _set_imu(self, imu, slot, acc, gyro, ts, valid, timestamp,
                 spline_valid):
        """Per-KF IMU-sample intake into window slot `slot`, an int or a
        0-dim device int (FrameHessian::setImuData; `_set_imu_jit`): each
        row written by a one-hot `torch.where`, which reads nothing
        back. `spline_valid`: a bool or a 0-dim device bool."""
        rows = dict(acc=acc, gyro=gyro, ts=ts, imu_valid=valid,
                    timestamps=timestamp, spline_valid=spline_valid)
        sel = torch.arange(self.F, device=self.device) == slot
        new = {}
        for name, val in rows.items():
            a = getattr(imu, name)
            new[name] = torch.where(
                sel.reshape((-1,) + (1,) * (a.dim() - 1)), val, a)
        return imu._replace(**new)

    def _imu_block(self, samples, t_ref):
        """The padded (acc, gyro, ts, valid) block of the newest N_IMU
        samples, times relative to t_ref, as numpy."""
        samples = samples[-IM.N_IMU:]
        acc = np.zeros((IM.N_IMU, 3), np.float32)
        gyro = np.zeros((IM.N_IMU, 3), np.float32)
        ts = np.zeros(IM.N_IMU, np.float32)
        for i, (t, a, g) in enumerate(samples):
            acc[i] = a
            gyro[i] = g
            ts[i] = t - t_ref
        return acc, gyro, ts, np.arange(IM.N_IMU) < len(samples)

    def _set_imu_data(self, slot: int, shell):
        """Fill the new KF's padded IMU-sample arrays from the host queue
        (FrameHessian::setImuData) and clear the queue up to the frame."""
        samples = [q for q in self.imu_queue if q[0] <= shell.timestamp]
        self.imu_queue = [q for q in self.imu_queue
                          if q[0] > shell.timestamp]
        acc, gyro, ts, valid = self._imu_block(samples, shell.timestamp)
        # spline validity: consecutive KFs close enough in time
        sv = False
        if slot > 0:
            prev_sh = self.shells[self.frame_shell_idx[slot - 1]]
            dt = shell.timestamp - prev_sh.timestamp
            sv = (int(valid.sum()) > 3) and dt < self.settings.max_imu_interval
        self.imu = self._set_imu(
            self.imu, slot, self._t(acc), self._t(gyro), self._t(ts),
            self._t(valid, torch.bool),
            self._t(np.float32(shell.timestamp)), sv)

    def _stage_imu(self, shell, t_last_kf: float, t_prev_frame=None):
        """The fused path's candidate IMU block (`_imu_candidate`): the
        samples this frame WOULD consume if it becomes a keyframe, without
        touching the host queue. The samples of a keyframe still in flight
        (at or before the chained last-keyframe time) are left out on the
        host, in float64, exactly as the completion's reconciliation of
        the queue drops them; the JAX package masks them on the device in
        f32, which keeps a sample at the keyframe's own time when the f32
        roundings of the two times fall so (the flagship scene's frame 29
        at 640x480). Also the IMU hypothesis' window start `thresh`
        (`t_prev_frame` relative to the frame, f32) and the frame's
        timestamp `t_kf` (f32), 0-dim. On a card one non-blocking copy
        from pinned memory carries all of it, so that staging waits for
        nothing."""
        samples = [q for q in self.imu_queue
                   if t_last_kf < q[0] <= shell.timestamp]
        acc, gyro, ts, valid = self._imu_block(samples, shell.timestamp)
        thresh = 0.0 if t_prev_frame is None \
            else t_prev_frame - shell.timestamp
        flat = torch.from_numpy(np.concatenate(
            [acc.ravel(), gyro.ravel(), ts, valid.astype(np.float32),
             np.asarray([thresh, shell.timestamp], np.float32)]))
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        N = IM.N_IMU
        return dict(acc=flat[:3 * N].view(N, 3),
                    gyro=flat[3 * N:6 * N].view(N, 3),
                    ts=flat[6 * N:7 * N], valid=flat[7 * N:8 * N] > 0.5,
                    thresh=flat[8 * N], t_kf=flat[8 * N + 1])

    def _stage_imu_block(self, shell, t_prev_frame: float) -> np.ndarray:
        """The fused frame graph's IMU block (`models/fused_graph.py`): the
        newest N_IMU samples of the host queue up to the frame, in
        `_imu_block`'s layout, each with the index of the first shell whose
        time covers it, then the hypothesis' window start and the frame's
        time, as one float32 array. Whether the keyframes still in flight
        consumed a sample is not known at dispatch: the body leaves out the
        samples whose cover index is at or before the chained last
        keyframe's, which is `_stage_imu`'s float64 test `t_last_kf <
        q.t`, and compacts the rest to the front."""
        samples = [q for q in self.imu_queue
                   if q[0] <= shell.timestamp][-IM.N_IMU:]
        acc, gyro, ts, valid = self._imu_block(samples, shell.timestamp)
        cover = np.zeros(IM.N_IMU, np.float32)
        cover[:len(samples)] = FU.imu_cover(self.shells,
                                            [q[0] for q in samples])
        return np.concatenate(
            [acc.ravel(), gyro.ravel(), ts, valid.astype(np.float32), cover,
             np.asarray([t_prev_frame - shell.timestamp, shell.timestamp],
                        np.float32)])

    def _propagate_imu(self, slot: int, shell):
        """propagateImuState for the incoming KF (HessianBlocks.cpp:357-404)."""
        prev = slot - 1
        last_bias = (self.imu.state[prev] * IM._s21(self.imu.state))[:6]
        prev_sh = self.shells[self.frame_shell_idx[prev]]
        self.imu = IM.propagate_imu_state(
            self.imu, slot, self._t(np.float32(prev_sh.timestamp)),
            self.imu.vel[prev],
            self._t(np.asarray(prev_sh.cam_to_world[:3, :3], np.float32)),
            last_bias, self.settings)

    def _flag_frames_for_marginalization(self, stats) -> List[int]:
        """flagFramesForMarginalization (FullSystemMarginalize.cpp:54-141)
        on the host, as the classic path decides it. Returns window slots
        to marginalize AFTER this KF, ascending."""
        s = self.settings
        n = len(self.frame_shell_idx)
        if n < s.min_frames:
            return []
        pt_in, imm_in, aff, T_cw = (_np(x) for x in stats)
        exp = _np(self.ba.exposure)
        flags = []
        for i in range(n):
            n_in = pt_in[i] + imm_in[i]
            n_out = self.host_out[i]
            a_rel = np.exp(aff[n - 1, 0] - aff[i, 0]) * exp[i] \
                / max(exp[n - 1], 1e-9)
            if (n_in < s.min_points_remaining * (n_in + n_out)
                    or abs(np.log(max(a_rel, 1e-9)))
                    > s.max_log_aff_fac_in_window) \
                    and n - len(flags) > s.min_frames:
                flags.append(i)
        if n + 1 - len(flags) >= s.max_frames:
            # drop the frame with the smallest pairwise-distance score
            best_score, best_i = 1.0, None
            for i in range(n - 1):
                if i == 0 and len(self.kf_shell_ids) <= s.max_frames:
                    continue
                if i in flags:
                    continue
                dist_score = 0.0
                for j in range(n - 1):
                    if j == i:
                        continue
                    d = np.linalg.norm(T_cw[i][:3, 3] - T_cw[j][:3, 3])
                    dist_score += 1.0 / (1e-5 + d)
                d_latest = np.linalg.norm(
                    (np.linalg.inv(T_cw[n - 1]) @ T_cw[i])[:3, 3])
                dist_score *= -np.sqrt(max(d_latest, 1e-9))
                if dist_score < best_score:
                    best_score, best_i = dist_score, i
            if best_i is not None:
                flags.append(best_i)
        return sorted(flags)

    def _flag_and_marginalize_points(self, frame_marg_flags):
        """flagPointsForRemoval + dropPointsF + marginalizePointsF on the
        classic path."""
        s = self.settings
        flagged = self._flag_mask(frame_marg_flags)
        ba = self.ba
        if s.enable_imu and self.imu_initialized:
            marg, drop, died = self._flag_points(ba, self.HdiF, flagged)
            self.ba, self.imu = E.marginalize_points_vio(
                ba, self.imu, self.dI, marg, s, self.w, self.h)
            self.ba = E.drop_points(self.ba, drop)
            died = _np(died)
        else:
            self.ba, marg, died = self._marg_points(ba, self.dI, self.HdiF,
                                                    flagged)
            died = _np(died)
        self.host_out += died
        if self._exporting():
            # the pre-marginalization arrays, which `ba` still holds
            self._cache_marg_points(marg, (ba.host, ba.u, ba.v, ba.idepth))

    def _make_new_traces(self, pyr, slot):
        """makeNewTraces (FullSystem.cpp:1071-1097) on the classic path:
        selection with a fresh key, re-run once within the keyframe when
        the density is far off (the reference's recursion)."""
        density = float(self.settings.desired_immature_density)
        pot = self._sel_pot
        for attempt in range(2):
            self.key, k = rng.split(self.key)
            imm_new, n_have = self._select_insert(self.imm, pyr[0], slot, k,
                                                  pot)
            n_have = int(n_have)
            quotia = density / max(n_have, 1)
            K = n_have * (pot + 1) ** 2
            ideal = selector._snap_pot(
                max(int((K / density) ** 0.5) - 1, 1))
            if attempt == 0 and quotia > 1.25 and pot > 1:
                pot = selector._snap_pot(min(ideal, pot - 1))
                continue
            if attempt == 0 and quotia < 0.25:
                pot = selector._snap_pot(max(ideal, pot + 1))
                continue
            break
        self._sel_pot = pot
        self.imm = imm_new

    def _marginalize_frames(self, flags: List[int]):
        """Marginalize flagged window slots on the classic path (highest
        first so that indices hold)."""
        vio = self.settings.enable_imu and self.imu_initialized
        exporting = self._exporting()
        for k in sorted(flags, reverse=True):
            self.shells[self.frame_shell_idx[k]].marginalized_at = \
                len(self.shells)
            kf_record = None
            if exporting:
                # dso_error needs the residuals targeting k: export first
                e_col, n_col = B.col_energy(self.ba, self.dI, k,
                                            self.settings, self.w, self.h)
                kf_record = self._export_kf(k, float(e_col), int(n_col))
            self.ba, self.imm, imu = self._marg_frame(
                self.ba, self.imm, self.imu if vio else None, k)
            if vio:
                self.imu = imu
            self.dI = torch.cat([self.dI[:k], self.dI[k + 1:],
                                 torch.zeros_like(self.dI[:1])], 0)
            self.host_out[k:-1] = self.host_out[k + 1:].copy()
            self.host_out[-1] = 0
            self._drop_slot(k)
            self._emit(kf_record)

    # ------------------------------------------------------------------
    # the export side: loop-closure records and output wrappers
    # ------------------------------------------------------------------
    def _exporting(self) -> bool:
        """Whether anything consumes keyframe records: without a consumer
        the point cache, the energy columns and the sampling are skipped."""
        return bool(self.marg_callbacks or self.output_wrappers)

    def _drop_slot(self, k: int) -> None:
        """Host bookkeeping of window slot k's marginalization: the slots
        above it move down one."""
        self.frame_pyramids = (self.frame_pyramids[:k]
                               + self.frame_pyramids[k + 1:] + [None])
        del self.frame_shell_idx[k]
        del self._marg_pts_cache[k]
        self._marg_pts_cache.append([])
        if self.ref_slot > k:
            self.ref_slot -= 1

    def _emit(self, kf_record) -> None:
        """publishKeyframes(final=true) of a marginalized keyframe."""
        if kf_record is None:
            return
        for cb in self.marg_callbacks:
            cb(kf_record)
        for ow in self.output_wrappers:
            ow.publish_keyframes(kf_record, final=True)

    def _cache_marg_points(self, marg, marg_pts) -> None:
        """Append the marginalized points' [u, v, idepth] rows to their
        host slot's cache (pointHessiansMarginalized)."""
        m = marg.cpu()
        if not bool(m.any()):
            return
        rows = _np(torch.stack([a[marg].to(torch.float32)
                                for a in marg_pts], -1))
        for hh, uu, vv, ii in rows:
            self._marg_pts_cache[int(hh)].append((uu, vv, ii))

    def _publish_kf(self, shell, pyr) -> None:
        """Non-final keyframe + the level-0 inverse-depth image of its
        tracking template, to every output wrapper."""
        if not self.output_wrappers:
            return
        u_t, v_t, id_t, ok_t = (_np(a) for a in self.pc_l0)
        idmap = np.zeros((self.h, self.w), np.float32)
        sel = ok_t.astype(bool)
        idmap[v_t[sel].astype(int), u_t[sel].astype(int)] = id_t[sel]
        img0 = _np(pyr[0][..., 0])
        for ow in self.output_wrappers:
            ow.publish_keyframes(dict(shell=shell), final=False)
            ow.push_depth_image(img0, idmap)

    def _export_kf(self, k: int, e_col: float, n_col: int) -> dict:
        """Final-KF record for loop closure / output (publishKeyframes
        final=true, LoopHandler.cpp:142-220): metric-rescaled [u, v, idepth]
        points, per-level intensities, the slot's own pyramid, dso_error /
        scale_error. e_col/n_col: energy/count of the residuals targeting
        the dying frame on the state before its marginalization
        (FullSystemMarginalize.cpp:151-187)."""
        sh = self.shells[self.frame_shell_idx[k]]
        if n_col > 0:
            dso_error = e_col / n_col / n_col
            self._last_dso_error = dso_error
        else:
            dso_error = 10.0 * self._last_dso_error
        pts = np.array(self._marg_pts_cache[k], np.float32).reshape(-1, 3)
        scale = max(sh.scale, 1e-9)
        pyramid = self.frame_pyramids[k]
        if len(pts) and pyramid is not None:
            pts_uvdi = pts.copy()
            pts_uvdi[:, 2] = pts[:, 2] / scale    # idepth -> metric
            inten = np.zeros((len(pts), self.n_levels), np.float32)
            # the intensity planes in one transfer
            flat = _np(torch.cat([p[..., 0].reshape(-1) for p in pyramid]))
            at = 0
            for lvl, p in enumerate(pyramid):
                hl, wl = p.shape[0], p.shape[1]
                img = flat[at:at + hl * wl].reshape(hl, wl)
                at += hl * wl
                u = (pts[:, 0] + 0.5) / (1 << lvl) - 0.5
                v = (pts[:, 1] + 0.5) / (1 << lvl) - 0.5
                inten[:, lvl] = _np_bilinear(img, u, v)
        else:
            pts_uvdi = np.zeros((0, 3), np.float32)
            inten = np.zeros((0, self.n_levels), np.float32)
        return dict(shell=sh, slot=k, pts_uvdi=pts_uvdi, intensities=inten,
                    pyramid=pyramid, dso_error=dso_error,
                    scale_error=sh.scale_error,
                    calib=self.calib.intrinsics(0))

    # ------------------------------------------------------------------
    # device steps of the chain
    # ------------------------------------------------------------------
    def _trace(self, ba, imm, dI0_new, T_cw_new, aff_new, exposure_new):
        """Trace every immature point of `imm` onto a new frame
        (traceNewCoarse) against the window `ba` (`trace_new`)."""
        return trace_new(ba, imm, dI0_new, T_cw_new, aff_new, exposure_new,
                         self.w, self.h, self.settings)

    def _frame_stats(self, ba, imm):
        """Per-frame point counts + affines + current poses."""
        F = ba.F
        pt_in = torch.zeros(F, dtype=torch.int64, device=self.device) \
            .index_add_(0, ba.host.long(), ba.pt_valid.to(torch.int64))
        imm_in = torch.zeros(F, dtype=torch.int64, device=self.device) \
            .index_add_(0, imm.host.long(), imm.valid.to(torch.int64))
        return (pt_in, imm_in, B.aff_real(ba.state),
                B.state_to_pose(ba.T_cw_eval, ba.state))

    def _flag_mask(self, ks) -> torch.Tensor:
        """(F,) bool mask of the window slots `ks`."""
        m = torch.zeros(self.F, dtype=torch.bool, device=self.device)
        m[list(ks)] = True
        return m

    def _activate(self, ba, imm, dI, min_act_dist):
        """activatePointsMT (FullSystem.cpp:375-531): density adaptation of
        the activation distance, candidate gating with an exact brute-force
        distance map, batched 1-DoF activation GN (K4) and scatter into
        the window. Returns (ba, imm, new_min_act_dist)."""
        s = self.settings
        dev = self.device
        d = float(s.desired_point_density)
        # the density ladder in f32 on the device (`_activate_jit`)
        n = torch.sum(ba.pt_valid).to(torch.float32)

        def f(c):
            return c.to(torch.float32)

        def pick(c, a, b):
            return torch.where(c, torch.full_like(n, a), b)

        delta = (-0.8 * f(n < 0.66 * d)
                 + pick(n < 0.8 * d, -0.5, pick(n < 0.9 * d, -0.2, pick(
                     n < d, -0.1, torch.zeros_like(n))))
                 + 0.8 * f(n > 1.5 * d) + 0.5 * f(n > 1.3 * d)
                 + 0.2 * f(n > 1.15 * d) + 0.1 * f(n > d))
        min_act = torch.clamp(min_act_dist + delta, 0.0, 4.0)

        w, h = self.w, self.h
        newest = B.newest_slot(ba.frame_valid)
        can = (imm.valid
               & ((imm.status == TR.IPS_GOOD) | (imm.status == TR.IPS_SKIPPED)
                  | (imm.status == TR.IPS_BADCONDITION)
                  | (imm.status == TR.IPS_OOB))
               & (imm.quality > s.min_trace_quality)
               & ((imm.idepth_max + imm.idepth_min) > 0)
               & torch.isfinite(imm.idepth_max))
        kill = imm.valid & (~torch.isfinite(imm.idepth_max)
                            | (imm.status == TR.IPS_OUTLIER))
        pre = B.make_precalc(ba)
        fx, fy, cx, cy = B.calib_real(ba)
        ih = imm.host.long()
        R_new, t_new = at(pre.R, newest, 1), at(pre.t, newest, 1)
        Rn = R_new[ih]
        tn = t_new[ih]
        KliP = torch.stack([(imm.u - cx) / fx, (imm.v - cy) / fy,
                            torch.ones_like(imm.u)], -1)
        mid_id = 0.5 * (imm.idepth_min + torch.where(
            torch.isfinite(imm.idepth_max), imm.idepth_max, imm.idepth_min))
        ptp = torch.einsum("nij,nj->ni", Rn, KliP) + tn * mid_id[:, None]
        pu = (ptp[:, 0] / ptp[:, 2] * fx + cx) * 0.5
        pv = (ptp[:, 1] / ptp[:, 2] * fy + cy) * 0.5
        inb = (pu > 0) & (pv > 0) & (pu < w // 2) & (pv < h // 2)
        kill |= imm.valid & can & ~inb
        can &= inb

        bh = ba.host.long()
        Rm = R_new[bh]
        tm = t_new[bh]
        KliPm = torch.stack([(ba.u - cx) / fx, (ba.v - cy) / fy,
                             torch.ones_like(ba.u)], -1)
        ptm = torch.einsum("nij,nj->ni", Rm, KliPm) + tm * ba.idepth[:, None]
        mu = (ptm[:, 0] / ptm[:, 2] * fx + cx) * 0.5
        mv = (ptm[:, 1] / ptm[:, 2] * fy + cy) * 0.5
        m_ok = ba.pt_valid & (ptm[:, 2] > 0)
        dd = (pu[:, None] - mu[None, :]) ** 2 + (pv[:, None] - mv[None, :]) ** 2
        dd = torch.where(m_ok[None, :], dd, torch.full_like(dd, float("inf")))
        dist = torch.sqrt(torch.amin(dd, -1))
        want = can & (dist >= min_act * imm.my_type)

        N = imm.u.shape[0]
        K = min(1024, N)
        idx, _ = selector.compact_mask_indices(want, K)
        sub = TR.ImmatureState(*(a[idx] for a in imm))
        idepth_k, ok_k, _ = TR.activate_points(
            sub, want[idx], dI, pre.R, pre.t, pre.affLL, ba.frame_valid,
            (fx, fy, cx, cy), w, h, s)
        idepth = torch.zeros(N, device=dev)
        idepth[idx] = idepth_k
        ok = torch.zeros(N, dtype=torch.bool, device=dev)
        ok[idx] = ok_k
        ok &= want
        slot, accepted = WIN.scatter_into_free_slots(ba.pt_valid, ok)
        ba = WIN.insert_points(ba, slot, accepted, host=imm.host, u=imm.u,
                               v=imm.v, color=imm.color, weight=imm.weights,
                               idepth=idepth,
                               prior_w=torch.zeros_like(idepth))
        imm = imm._replace(valid=imm.valid & ~ok & ~kill)
        return ba, imm, min_act

    def _flag_points(self, ba, HdiF, flagged_hosts):
        """flagPointsForRemoval (FullSystem.cpp:533-614). Returns (marg (P,),
        drop (P,), died-per-host (F,))."""
        s = self.settings
        n = torch.sum(ba.frame_valid)
        newest = n - 1
        n_res = torch.sum(ba.res_exist & ba.pt_valid[:, None], -1)
        bh = ba.host.long()
        host_flagged = flagged_hosts[bh]
        drop = ba.pt_valid & ((ba.idepth < 0) | (n_res == 0))
        vis_in_marg = torch.sum(ba.res_exist & flagged_hosts[None, :]
                                & (ba.res_state == B.RES_IN), -1)
        mg = s.min_good_active_res_for_marg
        oob = ba.pt_valid & (host_flagged | ((n_res >= mg)
                                             & (n_res - vis_in_marg < mg)))
        # invisible in the two newest frames, from the third frame on
        re_new = at(ba.res_exist, _clamp0(newest), 1)
        re_prev = at(ba.res_exist, _clamp0(newest - 1), 1)
        oob |= (n >= 3) & ba.pt_valid & ~re_new & ~re_prev & (n_res >= 2)
        inlier = n_res >= mg
        hess_ok = torch.where(HdiF > 0, 1.0 / torch.clamp(HdiF, min=1e-12),
                              torch.zeros_like(HdiF)) > s.min_idepth_h_marg
        marg = oob & inlier & hess_ok & ~drop
        drop = drop | (oob & ~(inlier & hess_ok))
        died = torch.zeros(ba.F, dtype=torch.int64, device=self.device) \
            .index_add_(0, bh, (marg | drop).to(torch.int64))
        return marg, drop, died

    def _marg_points(self, ba, dI, HdiF, flagged_hosts):
        """flagPointsForRemoval + marginalizePointsF + dropPointsF. Returns
        (ba, marg mask, died-per-host (F,) device ints)."""
        marg, drop, died = self._flag_points(ba, HdiF, flagged_hosts)
        ba = E.marginalize_points(ba, dI, marg, self.settings, self.w, self.h)
        ba = E.drop_points(ba, drop)
        return ba, marg, died

    def _select_insert(self, imm, dI0, slot, key, pot, keys=None):
        """makeNewTraces: 3-level gradient pyramid, block thresholds,
        hierarchical selection, density subsample, immature construction
        and pool scatter (`_select_insert_jit`). `slot`: the new points'
        host slot (int or 0-dim device tensor); `keys`: the selection's
        keys under `key` already on the device (`chain_graph.
        selection_keys`; None makes them here). The random draws are made
        on the device from them (the threefry twin's bits); the subsample
        is drawn always and applied where the f32 ratio `quotia` asks for
        it. Returns (imm, the pre-subsample count as a 0-dim device
        tensor)."""
        s = self.settings
        n_slots = min(s.max_immature, imm.u.shape[0])
        if keys is None:
            keys = torch.as_tensor(CG.selection_keys(key), device=self.device)
        h, w = dI0.shape[0], dI0.shape[1]
        draws = CG.selection_draws(keys, h, w, pot)
        _, absgrads = build_pyramid(dI0[..., 0], 3)
        ths = selector.block_thresholds(absgrads[0], s.min_grad_hist_cut,
                                        s.min_grad_hist_add)
        status, _ = selector.select(dI0, absgrads[0], absgrads[1],
                                    absgrads[2], ths, pot, 2.0,
                                    s.grad_downweight_per_level, key,
                                    draws=draws[:3])
        n_have = torch.sum(status != 0)
        n_f = torch.clamp(n_have.to(torch.float32), min=1.0)
        # a true f32 division (a Python number over a tensor is its
        # reciprocal times the number)
        quotia = torch.full_like(n_f, s.desired_immature_density) / n_f
        drop = (quotia < 0.95) & ~(draws[3] < quotia)
        status = torch.where(drop, torch.zeros_like(status), status)
        u, v, my_type = selector.extract_points(status, n_slots)
        new = TR.init_immature(u, v, torch.zeros_like(my_type) + slot,
                               my_type, dI0, s, n_slots)
        sidx, accepted = WIN.scatter_into_free_slots(imm.valid, new.valid)

        def put(arr, vals):
            return WIN.put_rows(arr, sidx, accepted, vals)

        dev = self.device
        nv = torch.ones_like(new.u)
        imm = imm._replace(
            valid=put(imm.valid, torch.ones_like(new.valid)),
            host=put(imm.host, new.host), u=put(imm.u, new.u),
            v=put(imm.v, new.v), color=put(imm.color, new.color),
            weights=put(imm.weights, new.weights),
            gradH=put(imm.gradH, new.gradH),
            energy_th=put(imm.energy_th, new.energy_th),
            idepth_min=put(imm.idepth_min, torch.zeros_like(nv)),
            idepth_max=put(imm.idepth_max, torch.full_like(nv, float("inf"))),
            status=put(imm.status, torch.full(
                new.host.shape, TR.IPS_UNINITIALIZED, dtype=torch.int8,
                device=dev)),
            quality=put(imm.quality, torch.full_like(nv, 10000.0)),
            my_type=put(imm.my_type, new.my_type))
        return imm, n_have

    def _marg_frame(self, ba, imm, imu, k):
        """One frame marginalization (`_maybe_marg_frame_lean_jit`'s and
        `_maybe_marg_frame_vio_lean_jit`'s do branch) of slot `k` (an int,
        or in vision mode a 0-dim device tensor): straggler drop,
        residual-column kill, immature-host remap and the frame Schur fold
        (the 29-dim VIO fold when `imu` is given). The image stack is
        compacted by the caller. Returns (ba, imm, imu)."""
        stragglers = ba.pt_valid & (ba.host == k)
        kcol = torch.arange(ba.F, device=self.device) == k
        ba = ba._replace(
            pt_valid=ba.pt_valid & ~stragglers,
            res_exist=torch.where(kcol[None, :], torch.zeros_like(
                ba.res_exist), ba.res_exist & ~stragglers[:, None]))
        imm = imm._replace(valid=imm.valid & (imm.host != k),
                           host=torch.where(imm.host > k, imm.host - 1,
                                            imm.host))
        if imu is None:
            return E.marginalize_frame(ba, k), imm, None
        ba, imu = E.marginalize_frame_vio(ba, imu, k, self.settings,
                                          jax_form=self.jax_form)
        return ba, imm, imu
