"""Configuration for sos_slam_tpu_torch (the port's own copy of
sos_slam_tpu/utils/config.py: same names, defaults and presets).

Mirrors the reference's three-tier flag system (reference:
src/util/settings.{h,cpp}, src/main.cpp:27-195) as a single frozen dataclass.
Parameter *names and defaults* follow the reference so launch files / YAML
configs written for the C++ node keep working; the derived enable switches
(`enable_imu = weight_imu_dso > 0` etc., main.cpp:116-189) are computed in
`finalize()`.

Unlike the reference, everything is immutable: the settings object is
passed to every function that needs a knob.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Compile-time constants (reference: settings.h:34,187-189, NumType.h:36-45)
# ---------------------------------------------------------------------------

PYR_LEVELS = 6          # max pyramid levels (settings.h:34)
PATTERN_NUM = 8         # residual pattern size (settings.h:187)
PATTERN_PADDING = 2     # border padding required by the pattern
CPARS = 4               # calibration parameters fx fy cx cy (NumType.h:45)

# The 8-point residual pattern actually used by the reference
# ("8 for SSE efficiency", settings.cpp pattern index 8).  (dx, dy) offsets.
PATTERN_OFFSETS = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    dtype=np.float32,
)

# Per-frame state dims: 8 = 6 pose + 2 affine; 29 adds the 21-dim IMU spline
# state [ba(3), bg(3), l_rot(3), q(6), c(6)] (HessianBlocks.h:319-328).
FRAME_DIM_NOIMU = 8
IMU_DIM = 21
FRAME_DIM_IMU = FRAME_DIM_NOIMU + IMU_DIM  # 29


@dataclass(frozen=True)
class Settings:
    """All runtime knobs. Names mirror the reference's `setting_*` globals."""

    # ---- keyframe selection (settings.cpp:31-42) ----
    kf_per_second: float = 0.0
    real_time_max_kf: bool = False
    max_shift_weight_t: float = 0.04 * (640 + 480)
    max_shift_weight_r: float = 0.0 * (640 + 480)
    max_shift_weight_rt: float = 0.02 * (640 + 480)
    kf_global_weight: float = 1.0
    max_affine_weight: float = 2.0

    # ---- priors on unobservable dims (settings.cpp:47-53) ----
    idepth_fix_prior: float = 50.0 * 50.0
    idepth_fix_prior_marg_fac: float = 600.0 * 600.0
    initial_rot_prior: float = 1e11
    initial_trans_prior: float = 1e10
    initial_aff_b_prior: float = 1e14
    initial_aff_a_prior: float = 1e14
    initial_calib_hessian: float = 5e9

    solver_mode_delta: float = 1e-5
    force_accept_step: bool = True

    # ---- point activation / marginalization (settings.cpp:61-79) ----
    min_idepth_h_act: float = 100.0
    min_idepth_h_marg: float = 50.0
    desired_immature_density: float = 1500.0
    desired_point_density: float = 2000.0
    min_points_remaining: float = 0.05
    max_log_aff_fac_in_window: float = 0.7
    min_frames: int = 5
    max_frames: int = 7
    min_frame_age: int = 1
    max_opt_iterations: int = 6
    min_opt_iterations: int = 1
    th_opt_iterations: float = 1.2

    # ---- outliers / robust loss (settings.cpp:82-119) ----
    outlier_th: float = 12.0 * 12.0
    outlier_th_sum_component: float = 50.0 * 50.0
    marg_weight_fac: float = 0.5 * 0.5
    re_track_threshold: float = 1.5
    # TPU addition: after the fused step's on-device standard-hypothesis
    # retry, the best result is accepted up to this factor over the achieve
    # threshold (the reference would run its 78 rotation restarts and, in
    # practice, keep the same best; escalating to that host phase only pays
    # when tracking has genuinely broken — see FullSystem._frame_step)
    re_track_escalation: float = 4.0
    min_good_active_res_for_marg: int = 3
    min_good_res_for_marg: int = 4
    photometric_calibration: int = 2
    use_exposure: bool = True
    affine_opt_mode_a: float = 1e12
    affine_opt_mode_b: float = 1e8
    gamma_weights_pixel_select: int = 1
    huber_th: float = 9.0
    frame_energy_th_const_weight: float = 0.5
    frame_energy_th_n: float = 0.7
    frame_energy_th_fac_median: float = 1.5
    overall_energy_th_weight: float = 1.0
    coarse_cutoff_th: float = 20.0

    # ---- pixel selection (settings.cpp:122-125) ----
    min_grad_hist_cut: float = 0.5
    min_grad_hist_add: float = 7.0
    grad_downweight_per_level: float = 0.75
    select_direction_distribution: bool = True

    # ---- immature point trace (settings.cpp:128-143) ----
    max_pix_search: float = 0.027
    min_trace_quality: float = 3.0
    min_trace_test_radius: int = 2
    gn_its_on_point_activation: int = 3
    trace_stepsize: float = 1.0
    trace_gn_iterations: int = 3
    trace_gn_threshold: float = 0.1
    trace_extra_slack_on_th: float = 1.2
    trace_slack_interval: float = 1.5
    trace_min_improvement_factor: float = 2.0

    # ---- SOS additions: IMU / scale / loop (settings.cpp:184-204) ----
    min_g_imu: int = 40
    max_imu_interval: float = 0.5
    scale_trap_thres: float = 1e-4
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    rot_imu_cam: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)  # row-major 3x3
    weight_imu_dso: float = -1.0      # <=0 disables IMU (main.cpp:116-117)
    imu_acc_nd: float = 2.0e-3        # accelerometer noise density
    imu_acc_rw: float = 3.0e-3        # accelerometer bias random walk
    imu_gyro_nd: float = 1.7e-4       # gyroscope noise density
    imu_gyro_rw: float = 2.0e-5       # gyroscope bias random walk
    imu_freq: float = 200.0

    scale_opt_thres: float = -1.0     # <=0 disables stereo scale opt (main.cpp:157)
    scale_accept_th: float = 15.0     # accepted avg residual for scale opt

    loop_lidar_range: float = -1.0    # <=0 disables loop closure (main.cpp:173)
    loop_cam_mode: str = "forward"    # "forward" | "downward"
    scan_context_thres: float = 0.33
    loop_direct_thres: float = 12.0   # direct-alignment acceptance residual
    loop_force_icp: bool = False
    loop_icp_thres: float = 1.0

    # ---- fixed-shape budgets (pad-and-mask sizes) ----
    max_window_frames: int = 8        # padded sliding-window size (>= max_frames+1)
    max_points: int = 2048            # padded active-point budget
    max_immature: int = 2048          # padded immature-point budget
    max_track_pts: int = 16384        # padded semi-dense tracker template size
    trace_steps: int = 100            # max discrete epipolar search steps
    pyr_levels: int = PYR_LEVELS

    # ---- presets (main.cpp:27-64): 0 = default, 2 = fast ----
    preset: int = 0

    # derived switches — set by finalize()
    enable_imu: bool = False
    enable_scale_opt: bool = False
    enable_loop_closure: bool = False

    def finalize(self) -> "Settings":
        """Apply preset + derive enable switches (reference main.cpp:27-189)."""
        d = {}
        if self.preset == 2:  # fast preset (main.cpp:48-64)
            d.update(
                desired_point_density=800.0,
                desired_immature_density=600.0,
                min_frames=4,
                max_frames=6,
                max_opt_iterations=4,
                min_opt_iterations=1,
            )
        d["enable_imu"] = self.weight_imu_dso > 0
        d["enable_scale_opt"] = self.scale_opt_thres > 0
        d["enable_loop_closure"] = self.loop_lidar_range > 0
        if d["enable_loop_closure"] and not d["enable_scale_opt"]:
            # mono loop closure rejected by the reference (main.cpp:174-178)
            raise ValueError("loop closure requires stereo scale optimization")
        return dataclasses.replace(self, **d)

    # IMU information weights from noise densities (main.cpp:139-150)
    def imu_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        sqf = float(np.sqrt(self.imu_freq))
        acc_sd = self.imu_acc_nd * sqf
        gyr_sd = self.imu_gyro_nd * sqf
        w = np.zeros((6, 6), np.float64)
        w[:3, :3] = np.eye(3) / (acc_sd * acc_sd)
        w[3:, 3:] = np.eye(3) / (gyr_sd * gyr_sd)
        acc_rw = self.imu_acc_rw * sqf
        gyr_rw = self.imu_gyro_rw * sqf
        wb = np.zeros((6, 6), np.float64)
        wb[:3, :3] = np.eye(3) / (acc_rw * acc_rw)
        wb[3:, 3:] = np.eye(3) / (gyr_rw * gyr_rw)
        return w * self.weight_imu_dso, wb * self.weight_imu_dso


def default_settings(**overrides) -> Settings:
    """Build finalized settings, applying keyword overrides first."""
    return Settings(**overrides).finalize()
