"""Image pyramid, gradients and bilinear sampling — the per-frame hot path
(port of sos_slam_tpu/ops/image.py).

Parity with the reference's makeImages (HessianBlocks.cpp:121-176):
  * level l>0 intensity = 2x2 box average of level l-1;
  * gradients = central differences per level, zero on the border columns,
    and dx also zero on the first/last row (the reference's flat index
    range [w, w*(h-1)));
  * abs_sq_grad = dx^2 + dy^2.

Each level is an (H, W, 3) tensor [intensity, dx, dy]; a pyramid is a
tuple of levels.

Kernel K1 replaces the TPU kernel
sos_slam_tpu/ops/pallas_kernels.py:fused_pyramid_level, which the JAX
package calls once per level. Here `pyramid_levels` forms all levels of a
frame in one launch (csrc/pyramid.cu has the design); `pyramid_level` is
the counterpart of the JAX function and the one-level case of that kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sos_slam_tpu_torch.utils import cuda_build as CB


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 box-average downsample of (H, W); H, W must be even."""
    h, w = img.shape
    return img.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients with zeroed borders (dx also zero on the
    first and last row)."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[1:-1, 1:-1] = 0.5 * (img[1:-1, 2:] - img[1:-1, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return dx, dy


def pyramid_level_plain(img: torch.Tensor, down: bool = True):
    """Plain twin of one K1 level: (H,W) level -> ((H,W,3) [I,dx,dy], (H,W)
    |grad|^2, (H/2,W/2) box-downsampled next level, or None for
    `down=False`)."""
    dx, dy = image_gradients(img)
    return (torch.stack([img, dx, dy], -1), dx * dx + dy * dy,
            downsample2x(img) if down else None)


def pyramid_levels_plain(img: torch.Tensor, n_levels: int):
    """Plain twin of K1: `pyramid_level_plain` chained over n_levels.
    Returns (levels, abs_sq_grads)."""
    levels, absgrads = [], []
    cur = img
    for lvl in range(n_levels):
        dI, asg, cur = pyramid_level_plain(cur, down=lvl + 1 < n_levels)
        levels.append(dI)
        absgrads.append(asg)
    return tuple(levels), tuple(absgrads)


K1_MAX_LEVELS = 4      # levels one launch of csrc/pyramid.cu forms


class PyramidOut(ctypes.Structure):
    """`PyramidOut` of csrc/pyramid.cu, passed by value."""
    _fields_ = [("dI", ctypes.c_void_p * K1_MAX_LEVELS),
                ("asg", ctypes.c_void_p * K1_MAX_LEVELS)]


_PYR_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             PyramidOut, ctypes.c_void_p, ctypes.c_void_p]


def _check_pyramid(img: torch.Tensor, what: str, halvings: int,
                   n_levels: int):
    """Raise unless img is a contiguous (H,W) float32 map on the CPU or a
    CUDA device whose sides halve `halvings` times without remainder and
    whose last of n_levels levels keeps 4 pixels a side."""
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"{what} takes a contiguous (H,W) float32 map")
    h, w = img.shape
    if n_levels < 1:
        raise ValueError(f"a pyramid needs at least 1 level, got {n_levels}")
    if h % (1 << halvings) or w % (1 << halvings):
        raise ValueError(f"pyramid dims must be divisible by 2^{halvings}, "
                         f"got {h}x{w}")
    if min(h, w) >> (n_levels - 1) < 4:
        raise ValueError(f"level {n_levels - 1} of {h}x{w} is under 4 pixels "
                         "a side")


def _launch_pyramid(img: torch.Tensor, n_levels: int, want_down: bool):
    """One launch of csrc/pyramid.cu on a CUDA (H,W) float32 map: n_levels
    <= K1_MAX_LEVELS levels and, for want_down, the next level's input.
    The levels' [I,dx,dy] maps are views of one allocation, the |grad|^2
    maps of another (each view contiguous)."""
    h, w = img.shape
    dims = [(h >> lvl, w >> lvl) for lvl in range(n_levels)]
    levels = CB.empty_views([(hl, wl, 3) for hl, wl in dims], torch.float32,
                            img.device)
    absgrads = CB.empty_views(dims, torch.float32, img.device)
    down = torch.empty((h >> n_levels, w >> n_levels), dtype=torch.float32,
                       device=img.device) if want_down else None
    out = PyramidOut()
    for lvl in range(n_levels):
        out.dI[lvl] = levels[lvl].data_ptr()
        out.asg[lvl] = absgrads[lvl].data_ptr()
    fn = CB.function("pyramid", "launch_pyramid", _PYR_ARGS)
    CB.check(fn(CB.ptr(img), h, w, n_levels, out,
                CB.ptr(down) if want_down else None,
                CB.stream_ptr(img.device)), "pyramid_levels")
    pyramid_levels.launches += 1
    return levels, absgrads, down


def pyramid_levels(img: torch.Tensor, n_levels: int):
    """K1: all n_levels levels of one frame. Returns (levels, abs_sq_grads)
    as `build_pyramid` does. On a CPU tensor: the plain twin. On a CUDA
    tensor: one launch of csrc/pyramid.cu for up to 4 levels (one more for
    every further 4), counted in `pyramid_levels.launches`. H and W must be
    divisible by 2^(n_levels-1) and the last level at least 4 pixels a
    side."""
    _check_pyramid(img, "pyramid_levels", n_levels - 1, n_levels)
    if img.device.type == "cpu":
        return pyramid_levels_plain(img, n_levels)
    levels, absgrads = [], []
    cur = img
    while len(levels) < n_levels:
        n = min(K1_MAX_LEVELS, n_levels - len(levels))
        lv, ag, cur = _launch_pyramid(cur, n, len(levels) + n < n_levels)
        levels += lv
        absgrads += ag
    return tuple(levels), tuple(absgrads)


pyramid_levels.launches = 0


def pyramid_level(img: torch.Tensor):
    """One K1 level, the counterpart of the JAX package's
    fused_pyramid_level: (H,W) -> ((H,W,3) [I,dx,dy], (H,W) |grad|^2,
    (H/2,W/2) next level). On a CPU tensor: the plain twin. On a CUDA
    tensor: the one-level case of the `pyramid_levels` kernel with the next
    level asked for (one launch, counted in `pyramid_levels.launches`)."""
    _check_pyramid(img, "pyramid_level", 1, 1)
    if img.device.type == "cpu":
        return pyramid_level_plain(img)
    (dI,), (asg,), down = _launch_pyramid(img, 1, True)
    return dI, asg, down


def build_pyramid(image: torch.Tensor, n_levels: int):
    """(levels, abs_sq_grads): levels[l] is (H_l, W_l, 3) [I, dx, dy];
    abs_sq_grads[l] is (H_l, W_l). One K1 call."""
    return pyramid_levels(image.to(torch.float32).contiguous(), n_levels)


def _corners(u, v, h, w):
    """Clamped top-left corner indices and fractional offsets (NaN
    coordinates map to corner 0, as XLA converts NaN to int 0)."""
    fu = torch.floor(u)
    fv = torch.floor(v)
    fu = torch.where(torch.isnan(fu), torch.zeros_like(fu), fu)
    fv = torch.where(torch.isnan(fv), torch.zeros_like(fv), fv)
    x0 = torch.clamp(fu, 0, w - 2).to(torch.int64)
    y0 = torch.clamp(fv, 0, h - 2).to(torch.int64)
    dx = torch.clamp(u - x0, 0.0, 1.0)
    dy = torch.clamp(v - y0, 0.0, 1.0)
    return x0, y0, dx, dy


def interp_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample img (H, W) or (H, W, C) at continuous (u, v); out-of-
    bounds coordinates are clamped (callers mask validity)."""
    h, w = img.shape[0], img.shape[1]
    x0, y0, dx, dy = _corners(u, v, h, w)
    flat = img.reshape(h * w, -1)
    idx = y0 * w + x0
    c0, c1, c2, c3 = flat[idx], flat[idx + 1], flat[idx + w], flat[idx + w + 1]
    dxe, dye = dx[..., None], dy[..., None]
    out = (c0 * (1 - dxe) * (1 - dye) + c1 * dxe * (1 - dye)
           + c2 * (1 - dxe) * dye + c3 * dxe * dye)
    return out[..., 0] if img.dim() == 2 else out


def interp_bilinear_blin(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(color, gx, gy) of an intensity plane with FORWARD-difference cell
    gradients — the reference's getInterpolatedElement33BiLin
    (globalFuncs.h:162-182), used by the ImmaturePoint constructor."""
    h, w = img.shape[0], img.shape[1]
    x0, y0, dx, dy = _corners(u, v, h, w)
    flat = img.reshape(h * w)
    idx = y0 * w + x0
    tl, tr, bl, br = flat[idx], flat[idx + 1], flat[idx + w], flat[idx + w + 1]
    top = dx * tr + (1 - dx) * tl
    bot = dx * br + (1 - dx) * bl
    left = dy * bl + (1 - dy) * tl
    right = dy * br + (1 - dy) * tr
    color = dx * right + (1 - dx) * left
    return torch.stack([color, right - left, bot - top], -1)


def interp_bilinear_frames(dI: torch.Tensor, Ku: torch.Tensor,
                           Kv: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample stacked frames dI (F,H,W[,C]) at Ku/Kv of shape
    (..., F, K) — frame axis second-to-last. Returns (..., F, K[, C])."""
    F, H, W = dI.shape[0], dI.shape[1], dI.shape[2]
    flat = dI.reshape(F * H * W, -1)
    x0, y0, dx, dy = _corners(Ku, Kv, H, W)
    fofs = (torch.arange(F, device=dI.device, dtype=torch.int64)
            * (H * W))[:, None]
    idx = fofs + y0 * W + x0
    dx, dy = dx[..., None], dy[..., None]
    out = (flat[idx] * (1 - dx) * (1 - dy) + flat[idx + 1] * dx * (1 - dy)
           + flat[idx + W] * (1 - dx) * dy + flat[idx + W + 1] * dx * dy)
    return out[..., 0] if dI.dim() == 3 else out


def in_bounds(u, v, w: int, h: int, pad: float = 2.0):
    return (u > pad) & (u < w - pad - 1) & (v > pad) & (v < h - pad - 1)
