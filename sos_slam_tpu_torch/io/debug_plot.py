"""Window / tracking debug visualizations (port of
sos_slam_tpu/io/debug_plot.py).

Host-side analogs of the reference's debug renderers
(FullSystemDebugStuff.cpp:47 debugPlotTracking, :104 debugPlot): numpy
images rendered from the window state, which is copied to the host in one
go (every listed tensor queued, one synchronization) — no per-point
device traffic, no GUI dependency (images are returned as uint8 arrays;
DebugPlotDumper writes PNGs through io/png.py).

Modes mirror the reference's freeDebugParam5 switch where the state
exists in the fixed-shape window:
  0 — active points colored by a rainbow of scaled idepth
  3 — immature points at their (idepth_min+idepth_max)/2 rainbow
  4 — immature points colored by last trace status
(The reference's marginalized/out point overlays have no analog: dead
points leave the fixed-shape window arrays immediately.)
"""

import os
from typing import List, Optional

import numpy as np
import torch

from sos_slam_tpu_torch.io.png import write_png
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import trace as TR


def _fetch(tensors) -> List[np.ndarray]:
    """The tensors as numpy arrays: the copies off a card are queued
    together into page-locked memory and waited for once."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    return [h.numpy() for h in host]


def rainbow(idepth: np.ndarray) -> np.ndarray:
    """Cyclic 3-phase rainbow of (N,) values -> (N,3) uint8
    (makeRainbow3B, util/globalFuncs.h:349 — non-positive ids are white)."""
    idepth = np.asarray(idepth, np.float64)
    out = np.full((idepth.shape[0], 3), 255, np.uint8)
    pos = idepth > 0
    ic = np.floor(idepth[pos]).astype(np.int64)
    fp = idepth[pos] - ic
    ic = ic % 3
    rgb = np.zeros((fp.shape[0], 3))
    rgb[ic == 0] = np.stack([1 - fp, fp, np.zeros_like(fp)], 1)[ic == 0]
    rgb[ic == 1] = np.stack([np.zeros_like(fp), 1 - fp, fp], 1)[ic == 1]
    rgb[ic == 2] = np.stack([fp, np.zeros_like(fp), 1 - fp], 1)[ic == 2]
    out[pos] = (255 * rgb).astype(np.uint8)
    return out


def _splat(img: np.ndarray, u: np.ndarray, v: np.ndarray,
           rgb: np.ndarray, rad: int = 1) -> None:
    """Scatter (rad*2+1)^2 blocks (setPixelCirc/setPixel9 analog)."""
    h, w = img.shape[:2]
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok = (ui >= rad) & (ui < w - rad) & (vi >= rad) & (vi < h - rad)
    ui, vi, rgb = ui[ok], vi[ok], rgb[ok]
    for dv in range(-rad, rad + 1):
        for du in range(-rad, rad + 1):
            img[vi + dv, ui + du] = rgb


def _gray_base(dI_np: np.ndarray) -> np.ndarray:
    """Intensity plane -> (H,W,3) uint8 at 0.9 gain (debugPlot's base)."""
    g = np.clip(dI_np[..., 0] * 0.9, 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=2)


def render_window(fs, mode: int = 0) -> List[np.ndarray]:
    """Per-keyframe window images (debugPlot, FullSystemDebugStuff.cpp:104).

    Returns one (H,W,3) uint8 image per valid window slot."""
    (dI_np, fv, pt_valid, host, pu, pv, pid,
     iv, ihost, iu, ivv, imin, imax, istat) = _fetch(
        (fs.dI, fs.ba.frame_valid, fs.ba.pt_valid, fs.ba.host, fs.ba.u,
         fs.ba.v, fs.ba.idepth, fs.imm.valid, fs.imm.host, fs.imm.u,
         fs.imm.v, fs.imm.idepth_min, fs.imm.idepth_max, fs.imm.status))
    n = int(fv.sum())
    imgs = []
    for k in range(n):
        img = _gray_base(dI_np[k])
        if mode == 0:
            sel = pt_valid & (host == k)
            scale = max(getattr(fs, "current_scale", 1.0), 1e-9)
            _splat(img, pu[sel], pv[sel], rainbow(pid[sel] / scale))
        elif mode == 3:
            sel = iv & (ihost == k) & np.isin(
                istat, (TR.IPS_GOOD, TR.IPS_SKIPPED, TR.IPS_BADCONDITION))
            mid = 0.5 * (imin[sel] + imax[sel])
            rgb = rainbow(mid)
            rgb[~np.isfinite(imax[sel])] = 0
            _splat(img, iu[sel], ivv[sel], rgb)
        elif mode == 4:
            colors = {TR.IPS_GOOD: (0, 255, 0), TR.IPS_OOB: (255, 0, 0),
                      TR.IPS_OUTLIER: (0, 0, 255),
                      TR.IPS_SKIPPED: (255, 255, 0),
                      TR.IPS_BADCONDITION: (255, 255, 255),
                      TR.IPS_UNINITIALIZED: (0, 0, 0)}
            for st, c in colors.items():
                sel = iv & (ihost == k) & (istat == st)
                _splat(img, iu[sel], ivv[sel],
                       np.tile(np.array(c, np.uint8), (int(sel.sum()), 1)))
        imgs.append(img)
    return imgs


def render_tracking(fs) -> List[np.ndarray]:
    """Per-target residual-projection overlays (debugPlotTracking,
    FullSystemDebugStuff.cpp:47 + PointFrameResidual::debugPlot,
    Residuals.cpp:273): every active point projected into every other
    window frame with the current poses, colored by residual state
    (IN red / OUTLIER blue / missing white). Returns one image per
    valid target slot."""
    (dI_np, fv, pt_valid, host, pu, pv, pid, res_exist, res_state) = _fetch(
        (fs.dI, fs.ba.frame_valid, fs.ba.pt_valid, fs.ba.host, fs.ba.u,
         fs.ba.v, fs.ba.idepth, fs.ba.res_exist, fs.ba.res_state))
    n = int(fv.sum())
    fx, fy, cx, cy = (float(x) for x in fs.calib.intrinsics(0))
    Kinv_ray = np.stack([(pu - cx) / fx, (pv - cy) / fy,
                         np.ones_like(pu)], 1)          # (P,3)
    T_cw = np.stack([fs.shells[fs.frame_shell_idx[i]].cam_to_world
                     for i in range(n)])                # (n,4,4)
    imgs = []
    for t in range(n):
        img = _gray_base(dI_np[t])
        for hslot in range(n):
            if hslot == t:
                continue
            T_ht = np.linalg.inv(T_cw[t]) @ T_cw[hslot]
            sel = pt_valid & (host == hslot) & res_exist[:, t] \
                & (res_state[:, t] != B.RES_OOB)
            if not sel.any():
                continue
            idep = np.maximum(pid[sel], 1e-9)
            p_h = Kinv_ray[sel] / idep[:, None]
            p_t = p_h @ T_ht[:3, :3].T + T_ht[:3, 3]
            z = np.maximum(p_t[:, 2], 1e-9)
            uu = fx * p_t[:, 0] / z + cx
            vv = fy * p_t[:, 1] / z + cy
            st = res_state[sel, t]
            rgb = np.full((st.shape[0], 3), 255, np.uint8)
            rgb[st == B.RES_IN] = (255, 0, 0)
            rgb[st == B.RES_OUTLIER] = (0, 0, 255)
            _splat(img, uu, vv, rgb, rad=0)
        imgs.append(img)
    return imgs


class DebugPlotDumper:
    """Per-keyframe PNG dumps of the window / tracking debug images
    (the headless stand-in for the reference's displayImageStitch).
    Register with `fs.marg_callbacks` or call .dump(fs, tag) directly."""

    def __init__(self, out_dir: str, mode: int = 0,
                 tracking: bool = False):
        self.out_dir = out_dir
        self.mode = mode
        self.tracking = tracking
        os.makedirs(out_dir, exist_ok=True)
        self._i = 0

    def dump(self, fs, tag: Optional[str] = None) -> None:
        tag = tag if tag is not None else f"{self._i:05d}"
        self._i += 1
        imgs = render_window(fs, self.mode)
        for k, im in enumerate(imgs):
            write_png(os.path.join(self.out_dir, f"win_{tag}_{k}.png"), im)
        if self.tracking:
            for k, im in enumerate(render_tracking(fs)):
                write_png(os.path.join(self.out_dir, f"trk_{tag}_{k}.png"),
                          im)
