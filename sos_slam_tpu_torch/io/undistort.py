"""Camera undistortion: geometric (5 models) + photometric (port of
sos_slam_tpu/io/undistort.py).

Rebuild of src/util/Undistort.{h,cpp}: parses the reference's camera.txt
format (model name or parameter count selects {FOV, RadTan, Pinhole,
KannalaBrandt, EquiDistant}), computes the rectified output calibration
("crop" / "full" / explicit / "none"), and produces an irradiance image via
the photometric response G and vignette map.

The remap is built once on the host (NumPy, float64); the per-frame
photometric correction (response LUT + vignette) and bilinear remap run as
PyTorch on the image's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sos_slam_tpu_torch.ops.image import interp_bilinear


# ---------------------------------------------------------------------------
# distortion models: map UNDISTORTED output pixels -> DISTORTED input pixels
# (each mirrors the corresponding distortCoordinates, Undistort.cpp:902-1128)
# ---------------------------------------------------------------------------

def _norm(in_xy, K_new):
    x, y = in_xy
    ix = (x - K_new[0, 2]) / K_new[0, 0]
    iy = (y - K_new[1, 2]) / K_new[1, 1]
    return ix, iy


def distort_fov(in_xy, pars, K_new):
    fx, fy, cx, cy, dist = pars[:5]
    ix, iy = _norm(in_xy, K_new)
    d2t = 2.0 * np.tan(dist / 2.0)
    r = np.sqrt(ix * ix + iy * iy)
    fac = np.where((r == 0) | (dist == 0), 1.0,
                   np.arctan(r * d2t) / np.maximum(dist * r, 1e-12))
    return fx * fac * ix + cx, fy * fac * iy + cy


def distort_pinhole(in_xy, pars, K_new):
    fx, fy, cx, cy = pars[:4]
    ix, iy = _norm(in_xy, K_new)
    return fx * ix + cx, fy * iy + cy


def distort_radtan(in_xy, pars, K_new):
    fx, fy, cx, cy, k1, k2, r1, r2 = pars[:8]
    ix, iy = _norm(in_xy, K_new)
    mx2, my2, mxy = ix * ix, iy * iy, ix * iy
    rho2 = mx2 + my2
    rad = k1 * rho2 + k2 * rho2 * rho2
    xd = ix + ix * rad + 2 * r1 * mxy + r2 * (rho2 + 2 * mx2)
    yd = iy + iy * rad + 2 * r2 * mxy + r1 * (rho2 + 2 * my2)
    return fx * xd + cx, fy * yd + cy


def distort_equidistant(in_xy, pars, K_new):
    fx, fy, cx, cy, k1, k2, k3, k4 = pars[:8]
    ix, iy = _norm(in_xy, K_new)
    r = np.sqrt(ix * ix + iy * iy)
    th = np.arctan(r)
    th2 = th * th
    thd = th * (1 + k1 * th2 + k2 * th2 ** 2 + k3 * th2 ** 3 + k4 * th2 ** 4)
    s = np.where(r > 1e-8, thd / np.maximum(r, 1e-12), 1.0)
    return fx * ix * s + cx, fy * iy * s + cy


def distort_kb(in_xy, pars, K_new):
    fx, fy, cx, cy, k0, k1, k2, k3 = pars[:8]
    ix, iy = _norm(in_xy, K_new)
    rr = np.sqrt(ix * ix + iy * iy)
    th = np.arctan2(rr, 1.0)
    r = th + k0 * th ** 3 + k1 * th ** 5 + k2 * th ** 7 + k3 * th ** 9
    s = np.where(rr < 1e-6, 1.0, r / np.maximum(rr, 1e-12))
    return s * fx * ix + cx, s * fy * iy + cy


MODELS = {
    "FOV": (distort_fov, 5),
    "Pinhole": (distort_pinhole, 5),
    "RadTan": (distort_radtan, 8),
    "EquiDistant": (distort_equidistant, 8),
    "KannalaBrandt": (distort_kb, 8),
}


@dataclass
class Undistorter:
    model: str
    pars: np.ndarray           # original calib [fx fy cx cy (+dist)]
    w_org: int
    h_org: int
    w: int
    h: int
    K: np.ndarray              # output 3x3
    remap_x: np.ndarray        # (h, w) sample coords into the original image
    remap_y: np.ndarray
    remap_valid: np.ndarray
    # `none` with equal input and output sizes: no remap (load_undistorter)
    passthrough: bool = False
    # the remap tables on each device they were used on
    _on: Dict = field(default_factory=dict, repr=False, compare=False)

    def intrinsics(self) -> Tuple[float, float, float, float]:
        return (float(self.K[0, 0]), float(self.K[1, 1]),
                float(self.K[0, 2]), float(self.K[1, 2]))

    def undistort(self, image: torch.Tensor) -> torch.Tensor:
        """The rectified float32 image on `image`'s device (a numpy image
        is taken to the CPU)."""
        img = torch.as_tensor(image).to(torch.float32)
        if self.passthrough:
            return img
        if img.device not in self._on:
            self._on[img.device] = tuple(
                torch.as_tensor(a, device=img.device)
                for a in (self.remap_x, self.remap_y, self.remap_valid))
        return _remap(img, *self._on[img.device])


def _remap(img, rx, ry, valid):
    out = interp_bilinear(img, rx.reshape(-1), ry.reshape(-1))
    out = out.reshape(rx.shape + img.shape[2:])
    if img.dim() == 3:
        valid = valid[..., None]
    return torch.where(valid, out, torch.zeros_like(out))


def _distort_fn(model):
    return MODELS[model][0]


def make_optimal_K_crop(model, pars, w_org, h_org, w, h) -> np.ndarray:
    """The 'crop' output calibration (makeOptimalK_crop, Undistort.cpp:
    557-672): stretch center lines for an initial range, then shrink until
    no border pixel maps out of the original image."""
    fn = _distort_fn(model)
    K = np.eye(3)

    t = (np.arange(100000) - 50000.0) / 10000.0
    dx, _ = fn((t, np.zeros_like(t)), pars, K)
    ok = (dx > 0) & (dx < w_org - 1)
    xs = t[ok]
    minX, maxX = (xs.min(), xs.max()) if xs.size else (-1.0, 1.0)
    _, dy = fn((np.zeros_like(t), t), pars, K)
    ok = (dy > 0) & (dy < h_org - 1)
    ys = t[ok]
    minY, maxY = (ys.min(), ys.max()) if ys.size else (-1.0, 1.0)

    minX *= 1.01; maxX *= 1.01; minY *= 1.01; maxY *= 1.01

    for _ in range(500):
        # vertical borders
        yy = minY + (maxY - minY) * np.arange(h) / (h - 1.0)
        lx, _ = fn((np.full(h, minX), yy), pars, K)
        rx, _ = fn((np.full(h, maxX), yy), pars, K)
        oobL = np.any(~((lx > 0) & (lx < w_org - 1)))
        oobR = np.any(~((rx > 0) & (rx < w_org - 1)))
        # horizontal borders
        xx = minX + (maxX - minX) * np.arange(w) / (w - 1.0)
        _, ty = fn((xx, np.full(w, minY)), pars, K)
        _, by = fn((xx, np.full(w, maxY)), pars, K)
        oobT = np.any(~((ty > 0) & (ty < h_org - 1)))
        oobB = np.any(~((by > 0) & (by < h_org - 1)))

        if not (oobL or oobR or oobT or oobB):
            break
        if (oobL or oobR) and (oobT or oobB):
            if (maxX - minX) > (maxY - minY):
                oobT = oobB = False
            else:
                oobL = oobR = False
        if oobL: minX *= 0.995
        if oobR: maxX *= 0.995
        if oobT: minY *= 0.995
        if oobB: maxY *= 0.995

    K_out = np.eye(3)
    K_out[0, 0] = (w - 1.0) / (maxX - minX)
    K_out[1, 1] = (h - 1.0) / (maxY - minY)
    K_out[0, 2] = -minX * K_out[0, 0]
    K_out[1, 2] = -minY * K_out[1, 1]
    return K_out


def make_optimal_K_full(model, pars, w_org, h_org, w, h) -> np.ndarray:
    """The 'full' output calibration.

    The reference leaves this mode unimplemented (makeOptimalK_full,
    Undistort.cpp:674-677 is `assert(false)`) although the parser accepts
    the `full` keyword (Undistort.cpp:773-775). We implement the documented
    DSO intent instead of aborting: choose the output calibration so the
    rectified image covers the FULL field of view of the input — i.e. the
    bounding box, in normalized camera coordinates, of the undistorted
    positions of every input border pixel.

    The distortion functions map output-normalized -> input pixels; they are
    inverted per border pixel by damped Newton with finite-difference
    Jacobians (smooth, low-distortion neighbourhood, converges in <20 its).
    """
    fn = _distort_fn(model)
    K = np.eye(3)

    # border pixels of the ORIGINAL image
    xs = np.arange(w_org, dtype=np.float64)
    ys = np.arange(h_org, dtype=np.float64)
    bx = np.concatenate([xs, xs, np.zeros(h_org), np.full(h_org, w_org - 1.0)])
    by = np.concatenate([np.zeros(w_org), np.full(w_org, h_org - 1.0), ys, ys])

    # initial guess: pinhole inverse with the original calib
    fx, fy, cx, cy = pars[:4]
    ix = (bx - cx) / fx
    iy = (by - cy) / fy

    eps = 1e-7
    for _ in range(25):
        px, py = fn((ix, iy), pars, K)
        rx, ry = px - bx, py - by
        # finite-difference Jacobian of (px,py) wrt (ix,iy)
        pxx, pyx = fn((ix + eps, iy), pars, K)
        pxy, pyy = fn((ix, iy + eps), pars, K)
        j00 = (pxx - px) / eps
        j10 = (pyx - py) / eps
        j01 = (pxy - px) / eps
        j11 = (pyy - py) / eps
        det = j00 * j11 - j01 * j10
        det = np.where(np.abs(det) < 1e-12, 1e-12, det)
        dix = (j11 * rx - j01 * ry) / det
        diy = (-j10 * rx + j00 * ry) / det
        step = np.clip(np.sqrt(dix * dix + diy * diy), 0.0, None)
        damp = np.where(step > 0.5, 0.5 / np.maximum(step, 1e-12), 1.0)
        ix = ix - dix * damp
        iy = iy - diy * damp

    # keep points whose round trip actually converged
    px, py = fn((ix, iy), pars, K)
    ok = (np.abs(px - bx) < 0.01) & (np.abs(py - by) < 0.01)
    ix, iy = ix[ok], iy[ok]
    if ix.size == 0:
        raise ValueError("full-mode inversion failed for every border pixel")
    minX, maxX = ix.min(), ix.max()
    minY, maxY = iy.min(), iy.max()

    K_out = np.eye(3)
    K_out[0, 0] = (w - 1.0) / (maxX - minX)
    K_out[1, 1] = (h - 1.0) / (maxY - minY)
    K_out[0, 2] = -minX * K_out[0, 0]
    K_out[1, 2] = -minY * K_out[1, 1]
    return K_out


def load_undistorter(calib_file: str, jax_form: bool = False) -> Undistorter:
    """Parse the reference's camera.txt (Undistort::getUndistorterForFile +
    readFromFile, Undistort.cpp:240-360,679-860).

    `none` with equal input and output sizes is a passthrough: the image
    comes back as given, with no remap. This follows upstream DSO, from
    which the reference's Undistort.cpp derives, as recalled and not read
    (the reference's source is not in this repository): its readFromFile
    sets `passthrough` for `none` and requires equal sizes, and its
    undistort then copies the photometrically corrected image. The JAX
    package remaps `none` through the identity, whose validity test
    zeroes the one-pixel border; `jax_form=True` keeps that remap (for the
    parity tests only)."""
    with open(calib_file) as f:
        lines = [f.readline().strip() for _ in range(4)]

    toks = lines[0].split()
    model = None
    if toks and toks[0] in MODELS:
        model = toks[0]
        vals = [float(v) for v in toks[1:]]
    else:
        vals = [float(v) for v in toks]
        model = {5: "FOV", 8: "RadTan"}.get(len(vals), None)
        if len(vals) == 5 and abs(vals[4]) < 1e-12:
            model = "Pinhole"
    if model is None:
        raise ValueError(f"cannot determine camera model from {calib_file}")

    pars = np.array(vals, np.float64)
    w_org, h_org = (int(v) for v in lines[1].split())

    # relative-calibration rescale (readFromFile, Undistort.cpp:750-770)
    if pars[2] < 1 and pars[3] < 1:
        pars[0] *= w_org
        pars[1] *= h_org
        pars[2] = pars[2] * w_org - 0.5
        pars[3] = pars[3] * h_org - 0.5

    out_mode = lines[2].split()
    w, h = (int(v) for v in lines[3].split())

    if out_mode[0] == "crop":
        K = make_optimal_K_crop(model, pars, w_org, h_org, w, h)
    elif out_mode[0] == "full":
        K = make_optimal_K_full(model, pars, w_org, h_org, w, h)
    elif out_mode[0] == "none":
        K = np.eye(3)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = pars[:4]
    else:  # explicit fx fy cx cy (relative)
        vals3 = [float(v) for v in out_mode]
        K = np.eye(3)
        K[0, 0] = vals3[0] * w
        K[1, 1] = vals3[1] * h
        K[0, 2] = vals3[2] * w - 0.5
        K[1, 2] = vals3[3] * h - 0.5

    # build the remap
    fn = _distort_fn(model)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rx, ry = fn((xx.reshape(-1), yy.reshape(-1)), pars, K)
    rx = rx.reshape(h, w)
    ry = ry.reshape(h, w)
    valid = (rx > 0) & (rx < w_org - 1) & (ry > 0) & (ry < h_org - 1)
    return Undistorter(model=model, pars=pars, w_org=w_org, h_org=h_org,
                       w=w, h=h, K=K,
                       remap_x=rx.astype(np.float32),
                       remap_y=ry.astype(np.float32),
                       remap_valid=valid,
                       passthrough=(out_mode[0] == "none" and not jax_form
                                    and (w, h) == (w_org, h_org)))


class PhotometricUndistorter:
    """Gamma response + vignette -> irradiance (PhotometricUndistorter,
    Undistort.cpp:38-160). Produces the ImageAndExposure equivalent."""

    def __init__(self, gamma_file: Optional[str], vignette_file: Optional[str],
                 w: int, h: int, mode: int = 2):
        self.valid = False
        self.G = np.linspace(0, 255, 256, dtype=np.float32)
        self.g_depth = 256
        self.vignette_inv = np.ones((h, w), np.float32)
        if gamma_file and os.path.exists(gamma_file):
            G = np.loadtxt(gamma_file, dtype=np.float64).reshape(-1)
            if len(G) >= 256 and np.all(np.diff(G) > 0):
                G = 255.0 * (G - G[0]) / (G[-1] - G[0])
                self.G = G.astype(np.float32)
                self.g_depth = len(G)
                self.valid = True
        if mode == 0:
            self.G = np.linspace(0, 255, self.g_depth, dtype=np.float32)
        if vignette_file and os.path.exists(vignette_file) and mode == 2:
            import imageio.v2 as iio
            vm = np.asarray(iio.imread(vignette_file), np.float32)
            if vm.ndim == 3:
                vm = vm[..., 0]
            if vm.shape == (h, w):
                vm = vm / vm.max()
                self.vignette_inv = 1.0 / np.maximum(vm, 1e-3)

    def process(self, image: np.ndarray, exposure: float = 1.0):
        """8-bit (or float 0..255*) image -> irradiance float image."""
        img = np.clip(np.asarray(image), 0,
                      self.g_depth - 1).astype(np.int32)
        out = self.G[img] * self.vignette_inv[: img.shape[0], : img.shape[1]]
        return out.astype(np.float32), exposure

    def process_tensor(self, image: torch.Tensor) -> torch.Tensor:
        """`process` on `image`'s device: the response LUT and the vignette
        as one gather and one product."""
        dev = image.device
        if getattr(self, "_dev", None) != dev:
            self._G_t = torch.as_tensor(self.G, device=dev)
            self._vig_t = torch.as_tensor(self.vignette_inv, device=dev)
            self._dev = dev
        img = torch.clamp(image, 0, self.g_depth - 1).to(torch.int64)
        return self._G_t[img] \
            * self._vig_t[: img.shape[0], : img.shape[1]]
