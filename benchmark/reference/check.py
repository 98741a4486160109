"""The comparison that decides `correct`, in NumPy float64. It imports
nothing of the program: it reads what the program published or left in
its window (poses, affines, undistorted frames, points, the gyro bias)
and holds them to what the benchmark made (the raw frames, the flight,
the plane).

The reference of each stage:
- intake: the raw 8-bit frame rectified by the plain remap of
  reference/camera.py (its own `crop` calibration);
- the frame step: the flight's exact pose of every frame, compared
  frame to frame (the relative rotation, and the relative translation at
  the run's one scale) and over the whole window (Sim(3)-aligned); its
  affine brightness against the scene's, which is a = b = 0 (every frame
  is rendered at one exposure);
- the keyframe chain: the plane's exact inverse depth at every active
  point of the final window (the spread of its ratio to the estimate),
  every keyframe's position against the flight (Sim(3), and with stereo +
  VIO the metric scale), and the planted gyro bias.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from benchmark.reference import camera as CAM
from benchmark.reference import evaluate as EV


@dataclass
class Outputs:
    """What the program produced, copied to the host after the window."""
    window: List[int]                     # frame ids handed in, in order
    poses: Dict[int, np.ndarray]          # published cam_to_world by id
    affs: Dict[int, np.ndarray]           # published affine (a, b) by id
    intake: Dict[int, tuple]              # id -> (left, right) rectified
    points: Optional[dict] = None         # u, v, idepth, host_id (active)
    keyframes: Optional[np.ndarray] = None  # (N,4) id x y z, metric if VIO
    gyro_bias: Optional[np.ndarray] = None


@dataclass
class Truth:
    """What the benchmark made: the served frames and the flight's poses
    by run frame (`ring.frame(k, cam)`, `ring.gt_pose(k)`)."""
    ring: object
    cams: list                            # CameraModel per camera
    plane_z: float
    gyro_bias: Optional[np.ndarray] = None
    _remaps: dict = field(default_factory=dict)

    def gt(self, k: int) -> np.ndarray:
        return self.ring.gt_pose(k)

    def remap(self, cam: int):
        if cam not in self._remaps:
            c = self.cams[cam]
            K = c.crop_K()
            self._remaps[cam] = (K, *c.remap_coords(K))
        return self._remaps[cam]


TF32_MANTISSA = 10


def intake_err(out: Outputs, truth: Truth, control: bool) -> float:
    """The largest gap, in intensity units, between the program's
    rectified frame and the plain remap of the raw frame, over the sampled
    frames and cameras. With `control`, the plain remap computed with its
    coordinates and weights in TF32 stands in the program's place."""
    worst = 0.0
    for k, imgs in out.intake.items():
        for cam, img in enumerate(imgs):
            if img is None:
                continue
            raw = truth.ring.frame(k, cam)
            _, rx, ry, valid = truth.remap(cam)
            ref = CAM.remap(raw, rx, ry, valid)
            got = CAM.remap(raw, rx, ry, valid, TF32_MANTISSA) if control \
                else img
            worst = max(worst, float(np.max(np.abs(got - ref))))
    return worst


def _pairs(out: Outputs):
    ids = [k for k in out.window if k in out.poses]
    return [(a, b) for a, b in zip(ids, ids[1:]) if b == a + 1]


def frame_steps(out: Outputs, truth: Truth) -> Dict[str, float]:
    """The frame step against the flight, frame to frame: the worst
    relative-rotation error (mrad) and the worst relative-translation
    error (mm) at the one scale that best maps the run's steps onto the
    flight's."""
    pairs = _pairs(out)
    if not pairs:
        return {n: float("inf") for n in (
            "first_bad_step", "rot_step_mrad", "trans_step_mm",
            "rot_step_p50_mrad", "trans_step_p50_mm", "rot_step_p90_mrad",
            "trans_step_p90_mm")}
    rot, dte, dtg = [], [], []
    for a, b in pairs:
        Ea, Eb = out.poses[a], out.poses[b]
        Ga, Gb = truth.gt(a), truth.gt(b)
        dE = np.linalg.inv(Ea) @ Eb
        dG = np.linalg.inv(Ga) @ Gb
        rot.append(EV.angle(dG[:3, :3].T @ dE[:3, :3]))
        dte.append(dE[:3, 3])
        dtg.append(dG[:3, 3])
    dte, dtg = np.asarray(dte), np.asarray(dtg)
    s = float(np.sum(dte * dtg) / max(np.sum(dte * dte), 1e-300))
    terr = np.linalg.norm(s * dte - dtg, axis=1)
    bad = np.nonzero(np.asarray(rot) > 5e-3)[0]
    return dict(first_bad_step=float(pairs[bad[0]][1] if len(bad) else -1),
                rot_step_mrad=1e3 * float(np.max(rot)),
                trans_step_mm=1e3 * float(np.max(terr)),
                rot_step_p50_mrad=1e3 * float(np.median(rot)),
                trans_step_p50_mm=1e3 * float(np.median(terr)),
                rot_step_p90_mrad=1e3 * float(np.percentile(rot, 90)),
                trans_step_p90_mm=1e3 * float(np.percentile(terr, 90)))


def window_ate_mm(out: Outputs, truth: Truth) -> float:
    """Sim(3)-aligned RMSE (mm) of every published pose of the window."""
    ids = [k for k in out.window if k in out.poses]
    if len(ids) < 3:
        return float("inf")
    est = np.stack([out.poses[k][:3, 3] for k in ids])
    gt = np.stack([truth.gt(k)[:3, 3] for k in ids])
    return 1e3 * EV.ate_rmse(est, gt, align_scale=True)


def affine_err(out: Outputs) -> Dict[str, float]:
    """The largest |a| (in thousandths) and |b| (intensity units) of the
    affine brightness published with the window's frames."""
    ids = [k for k in out.window if k in out.affs]
    if not ids:
        return dict(aff_a_max=float("inf"), aff_b_max=float("inf"))
    ab = np.abs(np.stack([out.affs[k] for k in ids]))
    return dict(aff_a_max=1e3 * float(np.max(ab[:, 0])),
                aff_b_max=float(np.max(ab[:, 1])))


def idepth_spread(out: Outputs, truth: Truth) -> float:
    """The 90th percentile of |log(idepth / exact) - its median| over the
    active points of the final window (one scale for all points; a point
    with idepth <= 0 counts as a spread of 10)."""
    p = out.points
    if p is None or len(p["u"]) == 0:
        return float("inf"), float("inf")
    K = truth.remap(0)[0]
    rays = np.stack([(p["u"] - K[0, 2]) / K[0, 0],
                     (p["v"] - K[1, 2]) / K[1, 1], np.ones_like(p["u"])], -1)
    G = np.stack([truth.gt(int(h)) for h in p["host_id"]])
    rw = np.einsum("nij,nj->ni", G[:, :3, :3], rays)
    depth = (truth.plane_z - G[:, 2, 3]) / rw[:, 2]
    good = p["idepth"] > 0
    r = np.log(np.where(good, p["idepth"], 1.0) * depth)
    dev = np.where(good, np.abs(r - np.median(r[good])) if good.any()
                   else 10.0, 10.0)
    return float(np.percentile(dev, 90)), float(np.percentile(dev, 50))


def keyframe_scale_err_pct(out: Outputs, truth: Truth) -> float:
    """|s - 1| in % of the Sim(3) scale that maps the metric keyframe
    positions of the window onto the flight."""
    kf = out.keyframes
    if kf is None:
        return float("inf")
    first = out.window[0] if out.window else 0
    kf = kf[kf[:, 0] >= first]
    if len(kf) < 3:
        return float("inf")
    gt = np.stack([truth.gt(int(i))[:3, 3] for i in kf[:, 0]])
    _, _, s = EV.umeyama(kf[:, 1:4], gt, True)
    return 100.0 * abs(s - 1.0)


def gyro_bias_err(out: Outputs, truth: Truth) -> float:
    """The largest component (mrad/s) of the estimated gyro bias minus the
    planted one."""
    if out.gyro_bias is None or truth.gyro_bias is None:
        return float("inf")
    return 1e3 * float(np.max(np.abs(np.asarray(out.gyro_bias)
                                     - np.asarray(truth.gyro_bias))))


def numbers(out: Outputs, truth: Truth, vio: bool,
            control: bool = False) -> Dict[str, float]:
    """Every number the comparison can hold to a limit."""
    got = dict(intake_err=intake_err(out, truth, control))
    got.update(frame_steps(out, truth))
    got["window_ate_mm"] = window_ate_mm(out, truth)
    got.update(affine_err(out))
    got["idepth_spread"], got["idepth_p50"] = idepth_spread(out, truth)
    if vio:
        got["scale_err_pct"] = keyframe_scale_err_pct(out, truth)
        got["gyro_bias_err"] = gyro_bias_err(out, truth)
    return got


def judge(got: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers that have a
    limit; a number that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = got.get(name, float("nan"))
        good = bool(np.isfinite(v)) and v <= limit
        ok &= good
        rows.append((name, v, limit))
    return ok, rows
