"""FullSystem: the monocular odometry driver (port of the mono, vision-only
main path of sos_slam_tpu/models/full_system.py; reference FullSystem.cpp).

One frame after initialization runs the JAX package's fused per-frame
program as synchronous PyTorch:
  * `_frame_step`: pyramid (K1), primary-hypothesis coarse track, a retry
    over the standard hypotheses when the primary misses the achieve
    threshold, the immature-point trace (applied only if the track is
    accepted) and the window stats;
  * `_need_kf`: the keyframe decision, read on the host once per frame;
  * on keyframes, `_kf_chain`: marginalization flags, the keyframe
    mega-step (insert frame, activate points with K4, windowed BA with K3,
    HdiF, tracker template with K2), point marginalization + new-trace
    selection, the flagged frames' marginalizations and one image-stack
    compaction.
The next frame's inputs (hypotheses, reference pose, thresholds) are
chained from this frame's outputs in f32, as the JAX package chains them on
its device. When the step refuses a frame, the host fallback runs the
rotation-perturbed restarts (`_finish_step_host`) and the classic
keyframe path, exactly as the JAX package does after `_complete_fused`.

Stereo scale, VIO and loop closure are later slices: enabling them raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from sos_slam_tpu_torch import resolve_device
from sos_slam_tpu_torch.models import energy as E
from sos_slam_tpu_torch.models import initializer as CI
from sos_slam_tpu_torch.models import window as WIN
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import selector
from sos_slam_tpu_torch.ops import trace as TR
from sos_slam_tpu_torch.ops import tracker as TK
from sos_slam_tpu_torch.ops.image import build_pyramid, interp_bilinear
from sos_slam_tpu_torch.ops.numerics import inv
from sos_slam_tpu_torch.utils import lie, rng
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
    is_kf: bool = False
    shell_idx: int = -1


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pad_hyps(hyps, size):
    out = list(hyps)[:size]
    while len(out) < size:
        out.append(out[-1] if out else np.eye(4))
    return out


class FullSystem:
    def __init__(self, calib: CalibPyramid, settings: Settings, device=None):
        if settings.enable_scale_opt or settings.enable_imu \
                or settings.enable_loop_closure:
            raise NotImplementedError(
                "the port runs the monocular vision-only path; stereo scale, "
                "VIO and loop closure are not ported yet")
        self.device = dev = resolve_device(device)
        self.calib = calib
        self.settings = settings
        self.n_levels = calib.levels
        self.w = calib.widths[0]
        self.h = calib.heights[0]
        self._intr = tuple(calib.intrinsics(l) for l in range(self.n_levels))
        F = settings.max_window_frames
        P = settings.max_points
        self.F, self.P = F, P

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
        self.current_min_act_dist = np.float32(2.0)
        self.shells: List[FrameShell] = []
        self.kf_shell_ids: List[int] = []
        self.host_out = np.zeros(F, np.int64)
        self.key = rng.PRNGKey(3141592)
        self._sel_pot = 3
        self._last_chain = None
        self.stats = dict(n_kf=0, n_frames=0)
        self.telemetry = Telemetry()

    # ------------------------------------------------------------------
    # public API (reference FullSystem::addActiveFrame)
    # ------------------------------------------------------------------
    def add_active_frame(self, image, timestamp: float, frame_id: int,
                         exposure: float = 1.0):
        """Track one frame; makes it a keyframe when needed. `image` is an
        (H, W) array or tensor of irradiance values."""
        if self.is_lost:
            return
        shell = FrameShell(id=frame_id, timestamp=timestamp,
                           cam_to_world=np.eye(4), aff=np.zeros(2),
                           shell_idx=len(self.shells))
        self.shells.append(shell)
        self.stats["n_frames"] += 1
        img = torch.as_tensor(np.array(image, np.float32)
                              if not torch.is_tensor(image) else image,
                              dtype=torch.float32).to(self.device)
        if not self.initialized:
            pyr, absgrads = build_pyramid(img, self.n_levels)
            self._initializer_step(pyr, absgrads, shell, exposure)
            return
        with self.telemetry.timed("frame"):
            rec = self._fused_frame(img, shell, exposure, self._last_chain)
            redo = self._complete_fused(rec)
        self._last_chain = None if redo else rec

    def finish_pending(self) -> None:
        """No frames are ever in flight: the port runs synchronously."""

    def trajectory(self) -> np.ndarray:
        """poses.txt contract: one row `id x y z` per keyframe."""
        rows = []
        for sh in self.shells:
            if sh.is_kf:
                t = sh.cam_to_world[:3, 3]
                rows.append([sh.id, t[0], t[1], t[2]])
        return np.array(rows)

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

    def _initialize_from_initializer(self, pyr, shell, exposure):
        """FullSystem::initializeFromInitializer (FullSystem.cpp:933-1069),
        mono path."""
        s = self.settings
        dev = self.device
        st = self.initializer
        lv0 = st.levels[0]
        good = lv0.valid & lv0.is_good
        init_scale = float(torch.sum(torch.where(good, lv0.iR,
                                                 torch.zeros_like(lv0.iR)))
                           / max(int(torch.sum(good)), 1))
        T0 = np.eye(4, dtype=np.float32)
        first_shell = self.init_first_shell
        self.ba = WIN.insert_frame(
            self.ba, torch.as_tensor(T0, device=dev),
            torch.zeros(2, device=dev),
            torch.tensor(float(self.init_first_exposure), device=dev),
            self._prior_row(first=True))
        self.dI[0] = self.init_first_pyr[0]
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
        self.initialized = True
        self._make_keyframe(pyr, shell, exposure)

    def _prior_row(self, first: bool) -> torch.Tensor:
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
    def _motion_hypotheses(self, lag: int = 0):
        """lastF -> new initializations (FullSystem.cpp:148-215): the
        standard hypotheses and the 78 rotation-perturbed restarts."""
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

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _frame_step(self, img, T_primary, T_hyps, T_cw_ref, aff0, ref_aff,
                    ref_exp, exposure, achieve_th):
        """The fused steady-state frame step (`_frame_step_jit`)."""
        s = self.settings
        pyr, _ = build_pyramid(img, self.n_levels)
        exposures = torch.stack([ref_exp, exposure])
        kw = dict(coarse_cutoff_th=s.coarse_cutoff_th, huber=s.huber_th)
        nan6 = torch.full((6,), float("nan"), device=self.device)
        out = TK.track_newest_coarse(pyr, self.templates, T_primary[None],
                                     aff0, ref_aff, exposures, nan6,
                                     self._intr, self.n_levels, **kw)
        res0 = out["residuals"][0, 0]
        prim_ok = bool(out["good"][0] & torch.isfinite(res0)
                       & (res0 < achieve_th))
        if not prim_ok:
            outb = TK.track_hypotheses(pyr, self.templates, T_hyps, aff0,
                                       ref_aff, exposures, self._intr,
                                       self.n_levels, **kw)
            resb = outb["residuals"][:, 0]
            inf = torch.full_like(resb, float("inf"))
            resb = torch.where(outb["good"] & torch.isfinite(resb), resb, inf)
            bi = int(torch.argmin(resb))
            res_p = torch.where(out["good"][0] & torch.isfinite(res0), res0,
                                inf[0])
            if not bool(res_p <= resb[bi]):
                out = {k: v[bi:bi + 1] for k, v in outb.items()}
        res_best = out["residuals"][0, 0]
        accept = bool(out["good"][0] & torch.isfinite(res_best)
                      & (res_best < achieve_th * s.re_track_escalation))
        T_cw_new = T_cw_ref @ inv(out["T"][0])
        imm = self.imm
        if accept:
            imm = self._trace(pyr[0], T_cw_new, out["aff"][0], exposures[1])
        stats = self._frame_stats(self.ba, imm)
        return pyr, out, imm, accept, T_cw_new, stats

    def _need_kf(self, out, accept, exposure_new, ref_exposure, first_rmse,
                 n_kf) -> bool:
        """The keyframe decision (FullSystem.cpp:709-732) in f32 from the
        step's outputs (`_need_kf_jit`)."""
        if not accept:
            return False
        s = self.settings
        a_ref = torch.exp(out["aff"][0, 0]) * exposure_new \
            / torch.clamp(ref_exposure, min=1e-9)
        flow_t, flow_rt = out["flow"][0, 0], out["flow"][0, 1]
        wh = float(self.w + self.h)
        score = (s.kf_global_weight * s.max_shift_weight_t
                 * torch.sqrt(torch.clamp(flow_t, min=0.0)) / wh
                 + s.kf_global_weight * s.max_shift_weight_rt
                 * torch.sqrt(torch.clamp(flow_rt, min=0.0)) / wh
                 + s.kf_global_weight * s.max_affine_weight
                 * torch.abs(torch.log(torch.clamp(a_ref, min=1e-9))))
        res0 = out["residuals"][0, 0]
        first_eff = torch.where(first_rmse < 0, res0, first_rmse)
        return bool((score > 1.0) | (2.0 * first_eff < res0)) or n_kf == 0

    def _fused_frame(self, img, shell, exposure, chain):
        """One frame of the fused path: step, decision, keyframe chain and
        the next frame's chained inputs. Returns the completion record."""
        s = self.settings
        dev = self.device
        if chain is None:
            prev_sh = self.shells[shell.shell_idx - 1] \
                if shell.shell_idx >= 1 else None
            hyps, _ = self._motion_hypotheses(
                lag=len(self.shells) - 1 - shell.shell_idx)
            ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]
            inp = dict(
                T_primary=self._t(np.asarray(hyps[0], np.float32)),
                T_hyps=self._t(np.stack(_pad_hyps(hyps[1:], 5))
                               .astype(np.float32)),
                aff=self._t(np.asarray(prev_sh.aff, np.float32)
                            if prev_sh is not None
                            else np.zeros(2, np.float32)),
                th=self._t(np.float32(self.last_coarse_rmse[0]
                                      * s.re_track_threshold)),
                T_cw_ref=self._t(np.asarray(ref_shell.cam_to_world,
                                            np.float32)),
                ref_aff=self._t(self.ref_aff),
                ref_exp=self._t(np.float32(self.ref_exposure)),
                T_cw_prev=self._t(np.asarray(
                    prev_sh.cam_to_world if prev_sh is not None
                    else np.eye(4), np.float32)),
                rms0=self._t(np.float32(self.last_coarse_rmse[0])),
                first_rmse=self._t(np.float32(self.first_coarse_rmse)),
                n_kf=len(self.kf_shell_ids),
                host_out=self.host_out.copy())
            prev_was_kf = bool(prev_sh.is_kf) if prev_sh is not None \
                else False
        else:
            inp = chain["nxt"]
            prev_was_kf = chain["need_kf"]
        exp_t = self._t(np.float32(exposure))

        with self.telemetry.timed("step"):
            pyr, out, imm_new, accept, T_cw_new, stats_dev = \
                self._frame_step(img, inp["T_primary"], inp["T_hyps"],
                                 inp["T_cw_ref"], inp["aff"], inp["ref_aff"],
                                 inp["ref_exp"], exp_t, inp["th"])
        need_kf = self._need_kf(out, accept, exp_t, inp["ref_exp"],
                                inp["first_rmse"], inp["n_kf"])
        slot = int(torch.sum(self.ba.frame_valid))
        aff_new = out["aff"][0]
        n_kf = inp["n_kf"]
        rec = dict(shell=shell, exposure=exposure, pyr=pyr, out=out,
                   accept=accept, T_cw_new=T_cw_new, need_kf=need_kf,
                   slot=slot, pot=self._sel_pot)
        if need_kf:
            with self.telemetry.timed("kf_chain"):
                chain_out = self._kf_chain(
                    imm_new, pyr, T_cw_new, aff_new,
                    exp_t, stats_dev, inp["host_out"], n_kf, shell.id,
                    self._max_its(n_kf + 1))
            rec.update(chain_out)
            T_kf = chain_out["T_cw_all_t"][slot]
            aff_kf = chain_out["affs_t"][slot]
            T_me, T_ref_n = T_kf, T_kf
            T_prev_f = chain_out["T_cw_all_t"][max(slot - 1, 0)] \
                if prev_was_kf else inp["T_cw_prev"]
            aff_n, ref_aff_n, ref_exp_n = aff_kf, aff_kf, exp_t
            host_out_n = chain_out["host_out"]
        else:
            rec["state"] = (self.ba, imm_new, self.dI,
                            self.current_min_act_dist, self.HdiF,
                            self.templates, self.pc_l0)
            T_me, T_ref_n, T_prev_f = T_cw_new, inp["T_cw_ref"], \
                inp["T_cw_prev"]
            aff_n, ref_aff_n, ref_exp_n = aff_new, inp["ref_aff"], \
                inp["ref_exp"]
            host_out_n = inp["host_out"]
        rec["host_out"] = host_out_n

        # next-frame chaining inputs (FullSystem.cpp:148-173), in f32
        res0 = out["residuals"][0, 0]
        finite = torch.isfinite(res0)
        rms0 = torch.where(finite, res0, inp["rms0"])
        fh_2_sl = lie.se3_inv(T_prev_f) @ T_me
        lastF_2_sl = lie.se3_inv(T_me) @ T_ref_n
        fh_inv = lie.se3_inv(fh_2_sl)
        dbl = fh_inv @ fh_inv @ lastF_2_sl
        half = lie.se3_exp(-0.5 * lie.se3_log(fh_2_sl)) @ lastF_2_sl
        eye4 = torch.eye(4, device=dev)
        first = inp["first_rmse"]
        rec["nxt"] = dict(
            T_primary=fh_inv @ lastF_2_sl,
            T_hyps=torch.stack([dbl, half, lastF_2_sl, eye4, eye4]),
            aff=aff_n, th=rms0 * s.re_track_threshold, rms0=rms0,
            T_cw_ref=T_ref_n, ref_aff=ref_aff_n, ref_exp=ref_exp_n,
            T_cw_prev=T_me, n_kf=n_kf + int(need_kf), host_out=host_out_n,
            first_rmse=torch.where((first < 0) & finite
                                   & torch.tensor(accept, device=dev),
                                   res0, first))
        return rec

    def _complete_fused(self, rec) -> bool:
        """Host bookkeeping of one fused frame. Returns True when the next
        frame must not chain from this one (fallback tracking or lost)."""
        shell, exposure = rec["shell"], rec["exposure"]
        (self.ba, self.imm, self.dI, self.current_min_act_dist, self.HdiF,
         self.templates, self.pc_l0) = rec["state"]
        self.host_out = np.asarray(rec["host_out"], np.int64)
        out_np = {k: _np(v) for k, v in rec["out"].items()}
        tres = self._finish_step_host(rec, out_np, rec["accept"],
                                      _np(rec["T_cw_new"]))
        if tres is None:
            self.is_lost = True
            return True
        if not rec["accept"]:
            need_kf = self._keyframe_decision(tres, shell)
            if need_kf:
                self._make_keyframe(rec["pyr"], shell, exposure)
            else:
                self.imm = self._trace(
                    rec["pyr"][0], self._t(shell.cam_to_world),
                    self._t(shell.aff), self._t(np.float32(exposure)))
            return True
        if rec["need_kf"]:
            if rec["slot"] >= self.F:
                raise RuntimeError("window overflow — marginalization failed")
            self._finish_kf(rec, classic=False)
        return False

    def _finish_step_host(self, p, out, accept, T_cw_new):
        """Host completion of a frame step: the rotation-restart fallback
        when the step refused the frame, then the shell pose/affine
        update."""
        s = self.settings
        shell = p["shell"]
        pyr = p["pyr"]
        ref_shell = self.shells[self.frame_shell_idx[self.ref_slot]]
        exposures = self._t(np.array([self.ref_exposure, p["exposure"]],
                                     np.float32))

        def run_batch(T_list, aff0, min_level=0):
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
            with self.telemetry.timed("fallback"):
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

    def _make_keyframe(self, pyr, shell, exposure):
        """The classic keyframe path (first keyframe after initialization
        and refused frames): trace + stats, then the same chain."""
        T_cw = self._t(np.asarray(shell.cam_to_world, np.float32))
        aff = self._t(np.asarray(shell.aff, np.float32))
        exp_t = self._t(np.float32(exposure))
        imm = self._trace(pyr[0], T_cw, aff, exp_t)
        stats = self._frame_stats(self.ba, imm)
        slot = len(self.frame_shell_idx)
        if slot >= self.F:
            raise RuntimeError("window overflow — marginalization failed")
        n_kf = len(self.kf_shell_ids)
        rec = dict(shell=shell, exposure=exposure, pyr=pyr, slot=slot,
                   pot=self._sel_pot)
        rec.update(self._kf_chain(imm, pyr, T_cw, aff, exp_t, stats,
                                  self.host_out.copy(), n_kf, shell.id,
                                  self._max_its(n_kf + 1)))
        (self.ba, self.imm, self.dI, self.current_min_act_dist, self.HdiF,
         self.templates, self.pc_l0) = rec["state"]
        self.host_out = np.asarray(rec["host_out"], np.int64)
        self._finish_kf(rec, classic=True)

    def _finish_kf(self, rec, classic: bool):
        """Host bookkeeping of a keyframe from its chain's values."""
        s = self.settings
        shell = rec["shell"]
        slot = rec["slot"]
        self.frame_shell_idx.append(shell.shell_idx)
        self.kf_shell_ids.append(shell.id)
        shell.is_kf = True
        self.stats["n_kf"] += 1
        n_kf = len(self.kf_shell_ids)
        st = rec["ba_stats"]
        rmse = float(st["rmse"])
        if bool(st["is_lost"]):
            self.is_lost = True
            return
        if (n_kf == 2 and rmse > 25) or (n_kf == 3 and rmse > 15) or \
                (n_kf == 4 and rmse > 10):
            self.init_failed = True
            return
        T_cw = _np(rec["T_cw_all_t"])
        affs = _np(rec["affs_t"])
        for i, sh_idx in enumerate(self.frame_shell_idx):
            self.shells[sh_idx].cam_to_world = T_cw[i]
            self.shells[sh_idx].aff = affs[i]
        self.ref_slot = len(self.frame_shell_idx) - 1
        self.ref_aff = np.asarray(shell.aff, np.float32)
        self.ref_exposure = rec["exposure"]

        # selector potential adaptation (PixelSelector2.cpp K-model)
        pot = rec["pot"]
        density = float(s.desired_immature_density)
        quotia = density / max(rec["n_have"], 1)
        redo = None
        if quotia > 1.25 and pot > 1:
            redo = selector.pot_step(pot, up=False)
        elif quotia < 0.25:
            redo = selector.pot_step(pot, up=True)
        if redo is not None and redo != pot:
            if classic and not rec["marg_ks"]:
                # the classic path re-selects within the same keyframe
                k2 = rng.fold_in(rng.fold_in(self.key, shell.id), 1)
                self.imm, _ = self._select_insert(
                    rec["imm_pre_select"], rec["pyr"][0], slot, k2, redo)
            self._sel_pot = redo

        for k in rec["marg_ks"]:   # descending: lower slots stay valid
            del self.frame_shell_idx[k]
            if self.ref_slot > k:
                self.ref_slot -= 1

    def _kf_chain(self, imm, pyr, T_cw_new, aff_new, exposure, stats,
                  host_out, n_kf: int, shell_id: int, max_its: int):
        """The keyframe chain (`_kf_chain_jit`'s run branch): flags, the
        mega-step, point marginalization + selection, the flagged frames'
        marginalizations and the image-stack compaction."""
        s = self.settings
        dev = self.device
        ba, dI = self.ba, self.dI
        slot = int(torch.sum(ba.frame_valid))
        key = rng.fold_in(self.key, shell_id)
        marg_ks = self._flag_frames(stats, ba.exposure, ba.frame_valid,
                                    host_out, n_kf)
        flags = torch.zeros(self.F, dtype=torch.bool, device=dev)
        flags[marg_ks] = True
        ba = WIN.insert_frame(ba, T_cw_new, aff_new, exposure,
                              self._prior_row(first=False))
        dI[slot] = pyr[0]
        ba, imm, min_act = self._activate(ba, imm, dI,
                                          self.current_min_act_dist)
        ba, ba_stats = E.optimize(ba, dI, s, self.w, self.h, max_its=max_its,
                                  min_its=s.min_opt_iterations)
        HdiF = ba_stats["HdiF"]
        templates, pc_l0 = WIN.build_track_template(
            ba, HdiF, pyr, len(pyr), self.tmpl_sizes, self.w, self.h)
        T_cw_all = B.state_to_pose(ba.T_cw_eval, ba.state)
        affs = B.aff_real(ba.state)
        imm_pre_select = imm
        pot = self._sel_pot
        ba, marg, died = self._marg_points(ba, dI, HdiF, flags)
        imm, n_have = self._select_insert(imm, pyr[0], slot, key, pot)
        host_out = host_out + died
        dimap = list(range(self.F))
        for k in marg_ks:
            ba, imm = self._marg_frame(ba, imm, k)
            dimap = dimap[:k] + dimap[k + 1:] + [dimap[k]]
            host_out = np.concatenate([host_out[:k], host_out[k + 1:], [0]])
        n_live = int(torch.sum(ba.frame_valid))
        if dimap != list(range(self.F)):
            dI = dI[torch.tensor(dimap, device=dev)]
        dI[n_live:] = 0.0
        return dict(
            state=(ba, imm, dI, min_act, HdiF, templates, pc_l0),
            ba_stats=ba_stats, T_cw_all_t=T_cw_all, affs_t=affs,
            marg_ks=marg_ks, n_have=n_have, host_out=host_out,
            imm_pre_select=imm_pre_select)

    # ------------------------------------------------------------------
    # device steps of the chain
    # ------------------------------------------------------------------
    def _host_to_new_transforms(self, ba, T_cw_new):
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

    def _trace(self, dI0_new, T_cw_new, aff_new, exposure_new):
        """Trace every immature point onto a new frame (traceNewCoarse)."""
        ba = self.ba
        KRKi, Kt = self._host_to_new_transforms(ba, T_cw_new)
        aff_cur = B.aff_real(ba.state)
        affs = TK.aff_from_to(ba.exposure, exposure_new, aff_cur.T,
                              aff_new[:, None].expand(2, ba.F)).T
        return TR.trace_points(self.imm, dI0_new, KRKi, Kt, affs, self.w,
                               self.h, self.settings)

    def _frame_stats(self, ba, imm):
        """Per-frame point counts + affines + current poses."""
        F = ba.F
        pt_in = torch.zeros(F, dtype=torch.int64, device=self.device) \
            .index_add_(0, ba.host.long(), ba.pt_valid.to(torch.int64))
        imm_in = torch.zeros(F, dtype=torch.int64, device=self.device) \
            .index_add_(0, imm.host.long(), imm.valid.to(torch.int64))
        return (pt_in, imm_in, B.aff_real(ba.state),
                B.state_to_pose(ba.T_cw_eval, ba.state))

    def _flag_frames(self, stats, exposure, frame_valid, host_out, n_kf):
        """flagFramesForMarginalization (FullSystemMarginalize.cpp:54-141),
        in f32 like `_flag_frames_jit`. Returns the flagged window slots,
        descending."""
        s = self.settings
        pt_in, imm_in, aff, T_cw = (t.cpu() for t in stats)
        exp = exposure.cpu()
        F = pt_in.shape[0]
        n = int(frame_valid.sum())
        newest = n - 1
        aff_n = aff[newest, 0]
        exp_n = exp[newest]
        flags = [False] * F
        cnt = 0
        for i in range(F):
            n_in = (pt_in[i] + imm_in[i]).to(torch.float32)
            n_out = torch.tensor(float(host_out[i]))
            a_rel = torch.exp(aff_n - aff[i, 0]) * exp[i] \
                / torch.clamp(exp_n, min=1e-9)
            c = (bool(n_in < s.min_points_remaining * (n_in + n_out))
                 or bool(torch.abs(torch.log(torch.clamp(a_rel, min=1e-9)))
                         > s.max_log_aff_fac_in_window)) \
                and (n - cnt) > s.min_frames and i < n
            flags[i] = c
            cnt += int(c)
        if (n + 1 - cnt) >= s.max_frames:
            t = T_cw[:, :3, 3]
            Dm = torch.linalg.norm(t[:, None] - t[None, :], dim=-1)
            idx = torch.arange(F)
            tgt_ok = (idx < n - 1)[None, :] & (idx[:, None] != idx[None, :])
            inv_sum = torch.sum(torch.where(tgt_ok, 1.0 / (1e-5 + Dm),
                                            torch.zeros_like(Dm)), 1)
            d_latest = torch.linalg.norm(t - t[newest][None, :], dim=-1)
            score = inv_sum * -torch.sqrt(torch.clamp(d_latest, min=1e-9))
            skip0 = n_kf <= s.max_frames
            eligible = (idx < n - 1) & ~torch.tensor(flags) \
                & ~((idx == 0) & skip0)
            score = torch.where(eligible, score, torch.full_like(score, 2.0))
            best = int(torch.argmin(score))
            if float(score[best]) < 1.0:
                flags[best] = True
        return sorted((i for i in range(F) if flags[i]), reverse=True)

    def _activate(self, ba, imm, dI, min_act_dist):
        """activatePointsMT (FullSystem.cpp:375-531): density adaptation of
        the activation distance, candidate gating with an exact brute-force
        distance map, batched 1-DoF activation GN (K4) and scatter into
        the window. Returns (ba, imm, new_min_act_dist)."""
        s = self.settings
        dev = self.device
        d = float(s.desired_point_density)
        n = np.float32(int(torch.sum(ba.pt_valid)))
        f = np.float32
        delta = (f(-0.8) * f(n < 0.66 * d)
                 + (f(-0.5) if n < 0.8 * d else f(-0.2) if n < 0.9 * d
                    else f(-0.1) if n < d else f(0.0))
                 + f(0.8) * f(n > 1.5 * d) + f(0.5) * f(n > 1.3 * d)
                 + f(0.2) * f(n > 1.15 * d) + f(0.1) * f(n > d))
        min_act = f(np.clip(f(min_act_dist) + delta, f(0.0), f(4.0)))

        w, h = self.w, self.h
        newest = int(torch.sum(ba.frame_valid)) - 1
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
        Rn = pre.R[ih, newest]
        tn = pre.t[ih, newest]
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
        Rm = pre.R[bh, newest]
        tm = pre.t[bh, newest]
        KliPm = torch.stack([(ba.u - cx) / fx, (ba.v - cy) / fy,
                             torch.ones_like(ba.u)], -1)
        ptm = torch.einsum("nij,nj->ni", Rm, KliPm) + tm * ba.idepth[:, None]
        mu = (ptm[:, 0] / ptm[:, 2] * fx + cx) * 0.5
        mv = (ptm[:, 1] / ptm[:, 2] * fy + cy) * 0.5
        m_ok = ba.pt_valid & (ptm[:, 2] > 0)
        dd = (pu[:, None] - mu[None, :]) ** 2 + (pv[:, None] - mv[None, :]) ** 2
        dd = torch.where(m_ok[None, :], dd, torch.full_like(dd, float("inf")))
        dist = torch.sqrt(torch.amin(dd, -1))
        want = can & (dist >= float(min_act) * imm.my_type)

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

    def _marg_points(self, ba, dI, HdiF, flagged_hosts):
        """flagPointsForRemoval (FullSystem.cpp:533-614) + marginalizePointsF
        + dropPointsF. Returns (ba, marg mask, died-per-host numpy)."""
        s = self.settings
        n = int(torch.sum(ba.frame_valid))
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
        if n >= 3:
            re_new = ba.res_exist[:, max(newest, 0)]
            re_prev = ba.res_exist[:, max(newest - 1, 0)]
            oob |= ba.pt_valid & ~re_new & ~re_prev & (n_res >= 2)
        inlier = n_res >= mg
        hess_ok = torch.where(HdiF > 0, 1.0 / torch.clamp(HdiF, min=1e-12),
                              torch.zeros_like(HdiF)) > s.min_idepth_h_marg
        marg = oob & inlier & hess_ok & ~drop
        drop = drop | (oob & ~(inlier & hess_ok))
        died = torch.zeros(ba.F, dtype=torch.int64, device=self.device) \
            .index_add_(0, bh, (marg | drop).to(torch.int64))
        ba = E.marginalize_points(ba, dI, marg, s, self.w, self.h)
        ba = E.drop_points(ba, drop)
        return ba, marg, _np(died)

    def _select_insert(self, imm, dI0, slot, key, pot):
        """makeNewTraces: 3-level gradient pyramid, block thresholds,
        hierarchical selection, density subsample, immature construction
        and pool scatter. Returns (imm, pre-subsample count)."""
        s = self.settings
        n_slots = min(s.max_immature, imm.u.shape[0])
        _, absgrads = build_pyramid(dI0[..., 0], 3)
        ths = selector.block_thresholds(absgrads[0], s.min_grad_hist_cut,
                                        s.min_grad_hist_add)
        status, _ = selector.select(dI0, absgrads[0], absgrads[1],
                                    absgrads[2], ths, pot, 2.0,
                                    s.grad_downweight_per_level, key)
        n_have = int(torch.sum(status != 0))
        quotia = np.float32(s.desired_immature_density) \
            / np.float32(max(n_have, 1))
        if quotia < 0.95:
            keep = torch.as_tensor(rng.uniform(rng.fold_in(key, 99),
                                               tuple(status.shape)) < quotia,
                                   device=self.device)
            status = torch.where(keep, status, torch.zeros_like(status))
        u, v, my_type = selector.extract_points(status, n_slots)
        new = TR.init_immature(u, v, torch.full_like(my_type, slot), my_type,
                               dI0, s, n_slots)
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

    def _marg_frame(self, ba, imm, k: int):
        """One frame marginalization (`_maybe_marg_frame_lean_jit`'s do
        branch): straggler drop, residual-column kill, immature-host remap
        and the frame Schur fold. The image stack is compacted once after
        all of them (`_kf_chain`)."""
        stragglers = ba.pt_valid & (ba.host == k)
        kcol = torch.arange(ba.F, device=self.device) == k
        ba = ba._replace(
            pt_valid=ba.pt_valid & ~stragglers,
            res_exist=torch.where(kcol[None, :], torch.zeros_like(
                ba.res_exist), ba.res_exist & ~stragglers[:, None]))
        imm = imm._replace(valid=imm.valid & (imm.host != k),
                           host=torch.where(imm.host > k, imm.host - 1,
                                            imm.host))
        return E.marginalize_frame(ba, k), imm
