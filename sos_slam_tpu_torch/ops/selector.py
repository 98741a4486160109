"""Gradient-based pixel selection (port of sos_slam_tpu/ops/selector.py;
reference PixelSelector2.{h,cpp} and PixelSelector.h).

  * `block_thresholds`: 32x32-block gradient-magnitude quantile thresholds
    (integer-histogram quantile), 3x3-smoothed then squared (makeHists).
  * `select`: the 3-tier potential-grid selection as masked block-argmax
    with per-block random directions drawn from the threefry twin, so the
    same key picks the same pixels as the JAX package.
  * `make_maps` / `make_pixel_status`: the host-side density adaptation.
  * the snapped potential ladder (`_snap_pot`, `pot_step`): it changes
    which pixels are picked, so the port keeps it for parity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as Fn

from sos_slam_tpu_torch.utils import rng
from sos_slam_tpu_torch.utils.config import Settings


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def compact_mask_indices(mask_flat: torch.Tensor, K: int):
    """Indices of the first K true entries of a flat bool mask, padded with
    the first false entries (the stable top_k of the mask). Returns
    (idx (K,) int64, ok (K,) bool). Requires K <= mask_flat.numel()."""
    dev = mask_flat.device
    cum_t = torch.cumsum(mask_flat.to(torch.int64), 0)
    n_t = cum_t[-1]
    j = torch.arange(1, K + 1, dtype=torch.int64, device=dev)
    idx_t = torch.searchsorted(cum_t, j, side="left")
    cum_f = torch.cumsum((~mask_flat).to(torch.int64), 0)
    idx_f = torch.searchsorted(cum_f, torch.clamp(j - n_t, min=1), side="left")
    ok = torch.arange(K, device=dev) < n_t
    return torch.where(ok, idx_t, idx_f), ok


def _box3_same(a: torch.Tensor) -> torch.Tensor:
    """3x3 box sum with zero padding ('same' convolution with ones)."""
    p = Fn.pad(a[None, None], (1, 1, 1, 1))[0, 0]
    h, w = a.shape
    out = torch.zeros_like(a)
    for dy in range(3):
        for dx in range(3):
            out = out + p[dy:dy + h, dx:dx + w]
    return out


def block_thresholds(absgrad0: torch.Tensor, cut: float, add: float):
    """Per-32x32-block smoothed squared thresholds (H//32, W//32)."""
    h, w = absgrad0.shape
    h32, w32 = h // 32, w // 32
    dev = absgrad0.device
    g = torch.clamp(torch.floor(torch.sqrt(torch.clamp(absgrad0, min=0.0))),
                    0, 48)
    xi = torch.arange(w, device=dev)
    yi = torch.arange(h, device=dev)
    valid = ((xi >= 1) & (xi <= w - 2))[None, :] \
        & ((yi >= 1) & (yi <= h - 2))[:, None]
    g = g[:h32 * 32, :w32 * 32]
    valid = valid[:h32 * 32, :w32 * 32]
    gb = g.reshape(h32, 32, w32, 32).permute(0, 2, 1, 3).reshape(h32, w32, 1024)
    vb = valid.reshape(h32, 32, w32, 32).permute(0, 2, 1, 3).reshape(
        h32, w32, 1024)
    gbi = torch.where(vb, gb, torch.full_like(gb, 49.0)).to(torch.int64)
    counts = torch.zeros((h32, w32, 50), dtype=torch.int64, device=dev)
    counts.scatter_add_(2, gbi, torch.ones_like(gbi))
    cum = torch.cumsum(counts[..., :49], -1)
    n_valid = vb.sum(-1)
    k = (n_valid.to(torch.float32) * cut + 0.5).to(torch.int64)
    found = cum > k[..., None]
    ths = torch.argmax(found.to(torch.uint8), -1).to(torch.float32)
    ths = torch.where(found.any(-1), ths, torch.full_like(ths, 48.0)) + add
    sm = _box3_same(ths) / _box3_same(torch.ones_like(ths))
    return sm * sm


def _block_pick(score: torch.Tensor, blk: int) -> torch.Tensor:
    """One-hot (H, W) bool of the per-(blk x blk)-block argmax where max>0."""
    h, w = score.shape
    hb, wb = h // blk, w // blk
    sb = score.reshape(hb, blk, wb, blk).permute(0, 2, 1, 3).reshape(
        hb, wb, blk * blk)
    best = torch.argmax(sb, -1)
    has = torch.amax(sb, -1) > 0.0
    onehot = (torch.arange(blk * blk, device=score.device) == best[..., None]) \
        & has[..., None]
    return onehot.reshape(hb, wb, blk, blk).permute(0, 2, 1, 3).reshape(h, w)


def _block_any(mask: torch.Tensor, blk: int) -> torch.Tensor:
    h, w = mask.shape
    hb, wb = h // blk, w // blk
    mb = mask.reshape(hb, blk, wb, blk).any(3).any(1)
    return mb.repeat_interleave(blk, 0).repeat_interleave(blk, 1)


def _dir_shapes(h: int, w: int, pot: int):
    """The (rows, cols) of block directions at the three tiers."""
    P = 4 * pot
    hp, wp = _cdiv(h, P) * P, _cdiv(w, P) * P
    return [(_cdiv(hp, blk), _cdiv(wp, blk)) for blk in (pot, 2 * pot, P)]


def select_draws(keys, h: int, w: int, pot: int):
    """The three tiers' uniform block-direction draws of `select`, the
    threefry twin's, made on the device of `keys` ((3, 2) int64 words of
    rng.split(key, 3))."""
    return [rng.uniform_device(keys[i], shp)
            for i, shp in enumerate(_dir_shapes(h, w, pot))]


def select(dI0, absgrad0, absgrad1, absgrad2, ths_smoothed, pot: int,
           th_factor: float, down_weight: float, key: np.ndarray,
           draws=None):
    """Hierarchical 3-tier selection. Returns (status (H,W) int8, score).
    status: 0 none, 1 level-0 pick, 2 level-1 pick, 4 level-2 pick.
    `draws`: `select_draws` of the key's split (then `key` is not read);
    None draws them here."""
    h, w = absgrad0.shape
    dev = absgrad0.device
    P = 4 * pot
    hp, wp = _cdiv(h, P) * P, _cdiv(w, P) * P
    if draws is None:
        draws = select_draws(torch.as_tensor(
            rng.split(key, 3).astype(np.int64), device=dev), h, w, pot)
    xi = torch.arange(w, device=dev)
    yi = torch.arange(h, device=dev)
    border = ((xi >= 4) & (xi < w - 5))[None, :] \
        & ((yi >= 4) & (yi <= h - 4))[:, None]

    def _upsample(a, fac):
        r = a.repeat_interleave(fac, 0).repeat_interleave(fac, 1)
        if r.shape[0] < h or r.shape[1] < w:
            r = Fn.pad(r[None, None], (0, max(w - r.shape[1], 0), 0,
                                       max(h - r.shape[0], 0)),
                       mode="replicate")[0, 0]
        return r[:h, :w]

    th0 = _upsample(ths_smoothed, 32)
    dw1 = down_weight
    dw2 = dw1 * dw1
    ag1 = _upsample(absgrad1, 2)
    ag2 = _upsample(absgrad2, 4)
    elig0 = (absgrad0 > th0 * th_factor) & border
    elig1 = (ag1 > th0 * dw1 * th_factor) & border
    elig2 = (ag2 > th0 * dw1 * dw2 * th_factor) & border

    def block_dirs(u01, blk):
        ang = u01 * math.pi
        d = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
        return d.repeat_interleave(blk, 0).repeat_interleave(blk, 1)[:hp, :wp]

    gx, gy = dI0[..., 1], dI0[..., 2]

    def pad(a):
        return Fn.pad(a, (0, wp - w, 0, hp - h))

    def dir_score(dirs, elig):
        s = torch.abs(gx * dirs[:h, :w, 0] + gy * dirs[:h, :w, 1])
        return pad(torch.where(elig, torch.clamp(s, min=1e-20),
                               torch.zeros_like(s)))

    s0 = dir_score(block_dirs(draws[0], pot), elig0)
    s1 = dir_score(block_dirs(draws[1], 2 * pot), elig1)
    s2 = dir_score(block_dirs(draws[2], 4 * pot), elig2)
    e0p = pad(elig0)
    e1p = pad(elig1)
    zero = torch.zeros_like(s1)
    sel0 = _block_pick(s0, pot)
    sel1 = _block_pick(torch.where(_block_any(e0p, 2 * pot), zero, s1),
                       2 * pot)
    sel2 = _block_pick(torch.where(_block_any(e0p | e1p, 4 * pot), zero, s2),
                       4 * pot)
    status = (sel0.to(torch.int8) * 1 + sel1.to(torch.int8) * 2
              + sel2.to(torch.int8) * 4)[:h, :w]
    score = torch.maximum(torch.maximum(s0, s1), s2)[:h, :w]
    return status, score


def extract_points(status: torch.Tensor, n_slots: int):
    """Selected pixels (status != 0) into a fixed-size list, flat row-major.
    Returns (u (n,), v (n,), my_type (n,) int32 with 0 = empty slot)."""
    h, w = status.shape
    idx, sel_ok = compact_mask_indices((status != 0).reshape(-1), n_slots)
    u = (idx % w).to(torch.float32)
    v = (idx // w).to(torch.float32)
    my_type = torch.where(sel_ok, status.reshape(-1)[idx].to(torch.int32),
                          torch.zeros_like(idx, dtype=torch.int32))
    return u, v, my_type


def grid_max_selection(dI: torch.Tensor, pot: int, th: float) -> torch.Tensor:
    """Coarse-level selection (gridMaxSelection, PixelSelector.h:111-253)."""
    h, w = dI.shape[:2]
    dev = dI.device
    gx, gy = dI[..., 1], dI[..., 2]
    sq = gx * gx + gy * gy
    ok = sq > th * th
    xi = torch.arange(w, device=dev)
    yi = torch.arange(h, device=dev)
    ok &= ((xi >= 1) & (xi < w - 1))[None, :] & ((yi >= 1) & (yi < h - 1))[:, None]
    hp, wp = _cdiv(h, pot) * pot, _cdiv(w, pot) * pot
    out = torch.zeros((hp, wp), dtype=torch.bool, device=dev)
    for ch in (torch.abs(gx), torch.abs(gy), torch.abs(gx - gy),
               torch.abs(gx + gy)):
        s = Fn.pad(torch.where(ok, torch.clamp(ch, min=1e-12),
                               torch.zeros_like(ch)), (0, wp - w, 0, hp - h))
        out |= _block_pick(s, pot)
    return out[:h, :w]


POT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16)


def _snap_pot(pot: int) -> int:
    return min(POT_LADDER, key=lambda p: abs(p - pot))


def pot_step(pot: int, up: bool) -> int:
    """Adjacent ladder rung: the density adaptation moves one rung per
    keyframe (the JAX package bounds its compiled program count this way;
    the port keeps it because it decides which pixels are picked)."""
    i = POT_LADDER.index(_snap_pot(pot))
    j = min(i + 1, len(POT_LADDER) - 1) if up else max(i - 1, 0)
    return POT_LADDER[j]


def make_pixel_status(dI: torch.Tensor, desired: float,
                      min_use_grad: float = 10.0, recursions: int = 5):
    """Adaptive-sparsity coarse selection (makePixelStatus)."""
    sparsity = 4
    th_fac = 1.0
    for rec in range(recursions + 1):
        m = grid_max_selection(dI, max(sparsity, 1),
                               th_fac * min_use_grad * 0.75)
        n = int(torch.sum(m))
        quotia = n / max(desired, 1.0)
        new_sparsity = _snap_pot(max(int(sparsity * quotia ** 0.5 + 0.7), 1))
        old_th = th_fac
        if new_sparsity == 1 and sparsity == 1:
            th_fac = 0.5
        if (abs(new_sparsity - sparsity) < 1 and th_fac == old_th) or \
                (quotia > 0.8 and quotia < 1.25) or rec == recursions:
            return m, n
        sparsity = new_sparsity
    return m, n


def make_maps(dI0, absgrads, settings: Settings, density: float, key,
              current_potential: int = 3, recursions: int = 1,
              th_factor: float = 2.0):
    """Density-adaptive selection (makeMaps, PixelSelector2.cpp:146-283).
    Returns (status (H,W) int8, n_selected, new_potential)."""
    ths = block_thresholds(absgrads[0], settings.min_grad_hist_cut,
                           settings.min_grad_hist_add)
    pot = _snap_pot(current_potential)
    for it in range(recursions + 1):
        status, _ = select(dI0, absgrads[0], absgrads[1], absgrads[2], ths,
                           pot, th_factor, settings.grad_downweight_per_level,
                           rng.fold_in(key, it))
        n_have = int(torch.sum(status != 0))
        quotia = density / max(n_have, 1)
        K = n_have * (pot + 1) ** 2
        ideal = _snap_pot(max(int((K / density) ** 0.5) - 1, 1))
        if it < recursions and quotia > 1.25 and pot > 1:
            pot = _snap_pot(min(ideal, pot - 1))
        elif it < recursions and quotia < 0.25:
            pot = _snap_pot(max(ideal, pot + 1))
        else:
            break
    if quotia < 0.95:
        u = torch.as_tensor(rng.uniform(rng.fold_in(key, 99), status.shape),
                            device=status.device)
        keep = u < np.float32(quotia).item()
        status = torch.where(keep, status, torch.zeros_like(status))
        n_have = int(torch.sum(status != 0))
    return status, n_have, ideal
