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

Kernel K1, `pyramid_level`, replaces the TPU kernel
sos_slam_tpu/ops/pallas_kernels.py:fused_pyramid_level (4 launches per
frame at 640x480). See csrc/pyramid.cu for its design.
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


def pyramid_level_plain(img: torch.Tensor):
    """Plain twin of K1: (H,W) level -> ((H,W,3) [I,dx,dy], (H,W) |grad|^2,
    (H/2,W/2) box-downsampled next level)."""
    dx, dy = image_gradients(img)
    return (torch.stack([img, dx, dy], -1), dx * dx + dy * dy,
            downsample2x(img))


_PYR_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def pyramid_level(img: torch.Tensor):
    """K1. On a CPU tensor: the plain twin. On a CUDA tensor: one launch of
    csrc/pyramid.cu (counted in `pyramid_level.launches`)."""
    if img.device.type == "cpu":
        return pyramid_level_plain(img)
    if img.device.type != "cuda":
        raise ValueError(f"pyramid_level: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("pyramid_level takes a contiguous (H,W) float32 map")
    h, w = img.shape
    if h % 2 or w % 2 or h < 3 or w < 3:
        raise ValueError(f"pyramid_level needs even dims >= 4, got {h}x{w}")
    dI = torch.empty((h, w, 3), dtype=torch.float32, device=img.device)
    asg = torch.empty((h, w), dtype=torch.float32, device=img.device)
    down = torch.empty((h // 2, w // 2), dtype=torch.float32,
                       device=img.device)
    fn = CB.function("pyramid", "launch_pyramid_level", _PYR_ARGS)
    CB.check(fn(CB.ptr(img), h, w, CB.ptr(dI), CB.ptr(asg), CB.ptr(down),
                CB.stream_ptr(img.device)), "pyramid_level")
    pyramid_level.launches += 1
    return dI, asg, down


pyramid_level.launches = 0


def build_pyramid(image: torch.Tensor, n_levels: int):
    """(levels, abs_sq_grads): levels[l] is (H_l, W_l, 3) [I, dx, dy];
    abs_sq_grads[l] is (H_l, W_l). One K1 launch per level."""
    levels, absgrads = [], []
    cur = image.to(torch.float32).contiguous()
    for _ in range(n_levels):
        dI, asg, cur = pyramid_level(cur)
        levels.append(dI)
        absgrads.append(asg)
    return tuple(levels), tuple(absgrads)


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
