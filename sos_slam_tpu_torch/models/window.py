"""Window/pool bookkeeping and the coarse-tracker template builder (port of
sos_slam_tpu/models/window.py).

Fixed-shape slot allocation into padded pools replaces the reference's
vectors of pointers. Kernel K2 replaces the TPU kernel
sos_slam_tpu/ops/pallas_kernels.py:template_level, which the JAX package
calls once per level. Here `template_levels` takes all levels of a keyframe
in one launch (csrc/template.cu has the design); `template_level` is the
counterpart of the JAX function and the one-level case of that kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import selector
from sos_slam_tpu_torch.ops.numerics import at, bucket_sums
from sos_slam_tpu_torch.ops.tracker import LevelTemplate
from sos_slam_tpu_torch.utils import cuda_build as CB
from sos_slam_tpu_torch.utils import lie

# neighbour offsets (dy, dx) of the one-pass dilation, in the summation
# order of the JAX package's roll form (roll by (dy, dx) reads the pixel
# at (y - dy, x - dx)): diagonal on levels 0-1, 4-neighbour on coarser ones
_ROLLS_DIAG = ((1, 1), (-1, -1), (1, -1), (-1, 1))
_ROLLS_CROSS = ((0, 1), (0, -1), (1, 0), (-1, 0))


def scatter_into_free_slots(valid: torch.Tensor, ok_new: torch.Tensor):
    """Assign each ok_new candidate a free slot. Returns (slot_idx (M,),
    accepted (M,))."""
    P = valid.shape[0]
    free_order = torch.argsort(valid.to(torch.int32), stable=True)
    n_free = torch.sum(~valid)
    rank = torch.cumsum(ok_new.to(torch.int64), 0) - 1
    accepted = ok_new & (rank < n_free)
    slot = free_order[torch.clamp(rank, 0, P - 1)]
    return slot, accepted


def put_rows(arr: torch.Tensor, slot_idx, accepted, vals) -> torch.Tensor:
    """A copy of `arr` with rows slot_idx[accepted] set to vals[accepted],
    without a host read: the rows not accepted are written to a spare row
    past the end, which is then cut off (the JAX package's mode="drop")."""
    n = arr.shape[0]
    out = torch.cat([arr, arr[:1]])
    out[torch.where(accepted, slot_idx, n)] = vals.to(arr.dtype)
    return out[:n]


def _neighbour(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """a[y - dy, x - dx], zero outside the map."""
    h, w = a.shape
    p = torch.nn.functional.pad(a[None, None], (1, 1, 1, 1))[0, 0]
    return p[1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def template_level_plain(idm, wm, color, diag: bool):
    """Plain twin of K2: one dilation of the scattered idepth/weight maps
    (empty cells get the mean of their occupied neighbours), then
    idn = id/w (-1 where w <= 0) and good = 2-px border & idn > 0 &
    finite color. Returns (idn, good)."""
    s = torch.zeros_like(idm)
    c = torch.zeros_like(wm)
    n = torch.zeros_like(wm)
    zero = torch.zeros_like(idm)
    for dy, dx in (_ROLLS_DIAG if diag else _ROLLS_CROSS):
        wn = _neighbour(wm, dy, dx)
        idn_ = _neighbour(idm, dy, dx)
        has = wn > 0
        s = s + torch.where(has, idn_, zero)
        c = c + torch.where(has, wn, zero)
        n = n + has.to(wm.dtype)
    fill = (wm <= 0) & (n > 0)
    idm2 = torch.where(fill, s / torch.clamp(n, min=1), idm)
    wm2 = torch.where(fill, c / torch.clamp(n, min=1), wm)
    h, w = idm.shape
    yi = torch.arange(h, device=idm.device)
    xi = torch.arange(w, device=idm.device)
    border = ((xi >= 2) & (xi < w - 2))[None, :] \
        & ((yi >= 2) & (yi < h - 2))[:, None]
    idn = torch.where(wm2 > 0, idm2 / torch.clamp(wm2, min=1e-12),
                      torch.full_like(idm2, -1.0))
    good = border & (idn > 0) & torch.isfinite(color)
    return idn, good


def template_levels_plain(maps, colors, diags):
    """Plain twin of K2: `template_level_plain` on every level."""
    return [template_level_plain(idm, wm, color, diag)
            for (idm, wm), color, diag in zip(maps, colors, diags)]


K2_MAX_LEVELS = 6      # levels one launch of csrc/template.cu takes


class TemplateTable(ctypes.Structure):
    """`TemplateTable` of csrc/template.cu, passed by value."""
    _fields_ = [(name, ctypes.c_void_p * K2_MAX_LEVELS)
                for name in ("idm", "wm", "color", "idn", "good")] \
        + [(name, ctypes.c_int * K2_MAX_LEVELS)
           for name in ("h", "w", "diag", "color_stride", "first_block")]


_TMPL_ARGS = [TemplateTable, ctypes.c_int, ctypes.c_void_p]


def template_levels(maps, colors, diags):
    """K2: the dilated, normalised idepth map and the good-pixel mask of
    every template level. maps[l] is the (idm, wm) pair of level l,
    colors[l] its (H_l, W_l) colour plane (contiguous, or the channel-0 view
    of an interleaved (H_l, W_l, C) level: it is read in place), diags[l]
    whether the level dilates over diagonal or cross neighbours. Returns
    [(idn, good)] per level. On CPU tensors: the plain twin. On CUDA
    tensors: one launch of csrc/template.cu for all levels (counted in
    `template_levels.launches`); the idn maps are views of one allocation,
    the masks of another (each view contiguous)."""
    if not (0 < len(maps) <= K2_MAX_LEVELS
            and len(maps) == len(colors) == len(diags)):
        raise ValueError(f"template_levels takes 1..{K2_MAX_LEVELS} levels of "
                         "maps, colours and neighbourhoods")
    dev = maps[0][0].device
    if dev.type == "cpu":
        return template_levels_plain(maps, colors, diags)
    if dev.type != "cuda":
        raise ValueError(f"template_levels: unsupported device {dev}")
    table = TemplateTable()
    for lvl, ((idm, wm), color, diag) in enumerate(zip(maps, colors, diags)):
        for t in (idm, wm):
            if t.device != dev or t.dtype != torch.float32 or t.dim() != 2 \
                    or t.shape != idm.shape or not t.is_contiguous():
                raise ValueError("template_levels takes contiguous (H,W) "
                                 "float32 maps on one device")
        h, w = idm.shape
        if color.device != dev or color.dtype != torch.float32 \
                or color.shape != idm.shape or color.stride(1) < 1 \
                or color.stride(0) != w * color.stride(1):
            raise ValueError("template_levels takes an (H,W) float32 colour "
                             "plane with one stride between all its pixels")
        table.idm[lvl], table.wm[lvl] = idm.data_ptr(), wm.data_ptr()
        table.color[lvl] = color.data_ptr()
        table.h[lvl], table.w[lvl], table.diag[lvl] = h, w, int(diag)
        table.color_stride[lvl] = color.stride(1)
    shapes = [idm.shape for idm, _ in maps]
    idns = CB.empty_views(shapes, torch.float32, dev)
    goods = CB.empty_views(shapes, torch.bool, dev)
    for lvl, (idn, good) in enumerate(zip(idns, goods)):
        table.idn[lvl], table.good[lvl] = idn.data_ptr(), good.data_ptr()
    fn = CB.function("template", "launch_template_levels", _TMPL_ARGS)
    CB.check(fn(table, len(maps), CB.stream_ptr(dev)), "template_levels")
    template_levels.launches += 1
    return list(zip(idns, goods))


template_levels.launches = 0


def template_level(idm, wm, color, diag: bool):
    """One K2 level, the counterpart of the JAX package's template_level:
    the one-level case of `template_levels`."""
    return template_levels([(idm, wm)], [color], [diag])[0]


def template_maps(ba: B.BAState, HdiF: torch.Tensor, n_levels: int,
                  w: int, h: int):
    """The scattered per-level (idepth-sum, weight-sum) maps of
    makeCoarseDepthL0: points with a residual into the newest frame,
    projected into it, weighted by sqrt(1e-3 / HdiF). Level l scatters the
    same level-0 cells at (u >> l, v >> l), which is exactly the 2x2
    block-sum downsample of the level-0 map."""
    newest = B.newest_slot(ba.frame_valid)
    fx, fy, cx, cy = B.calib_real(ba)
    T_cw = B.state_to_pose(ba.T_cw_eval, ba.state)
    T_wc_new = lie.se3_inv(at(T_cw, newest))
    rel = torch.einsum("ij,hjk->hik", T_wc_new, T_cw)
    relp = rel[ba.host.long()]
    Rc = relp[:, :3, :3]
    tc = relp[:, :3, 3]
    KliP = torch.stack([(ba.u - cx) / fx, (ba.v - cy) / fy,
                        torch.ones_like(ba.u)], -1)
    ptp = torch.einsum("pij,pj->pi", Rc, KliP) + tc * ba.idepth[:, None]
    drescale = 1.0 / ptp[:, 2]
    new_idepth = ba.idepth * drescale
    Ku = ptp[:, 0] * drescale * fx + cx
    Kv = ptp[:, 1] * drescale * fy + cy
    has_res = at(ba.res_exist, newest, 1) & ba.pt_valid
    ok = has_res & (drescale > 0) & (Ku > 1) & (Kv > 1) & (Ku < w - 2) \
        & (Kv < h - 2)
    ui = torch.clamp(torch.nan_to_num(Ku + 0.5).to(torch.int64), 0, w - 1)
    vi = torch.clamp(torch.nan_to_num(Kv + 0.5).to(torch.int64), 0, h - 1)
    # multiply (not select) by ok, as the JAX form does: a non-finite
    # new_idepth of a masked point still reaches its cell as NaN there too
    wgt = torch.sqrt(1e-3 / (HdiF + 1e-12)) * ok
    if h % (1 << (n_levels - 1)) or w % (1 << (n_levels - 1)):
        raise ValueError(f"template levels need dims divisible by "
                         f"2^{n_levels - 1}, got {w}x{h}")
    maps = []
    val = new_idepth * wgt
    for lvl in range(n_levels):
        hl, wl = h >> lvl, w >> lvl
        flat = (vi >> lvl) * wl + (ui >> lvl)
        maps.append((bucket_sums(flat, val, hl * wl).reshape(hl, wl),
                     bucket_sums(flat, wgt, hl * wl).reshape(hl, wl)))
    return maps


def build_track_template(ba: B.BAState, HdiF: torch.Tensor, pyr_ref,
                         n_levels: int, sizes: Tuple[int, ...], w: int, h: int):
    """makeCoarseDepthL0 (reference CoarseTracker.cpp:56-230): scattered
    maps, one K2 call for the dilation+normalisation of all levels (diagonal
    neighbours on levels 0-1, cross on coarser ones), then fixed-size
    per-level point lists. Also returns the level-0 (u, v, idepth, ok)
    cloud."""
    maps = template_maps(ba, HdiF, n_levels, w, h)
    dilated = template_levels(maps, [pyr_ref[lvl][..., 0]
                                     for lvl in range(n_levels)],
                              [lvl < 2 for lvl in range(n_levels)])
    templates = []
    pc_l0 = None
    for lvl, (idn, good) in enumerate(dilated):
        wl = idn.shape[1]
        idx, sel_ok = selector.compact_mask_indices(good.reshape(-1),
                                                    sizes[lvl])
        u_t = (idx % wl).to(torch.float32)
        v_t = (idx // wl).to(torch.float32)
        tid = idn.reshape(-1)[idx]
        color = pyr_ref[lvl].reshape(-1, pyr_ref[lvl].shape[-1])[idx, 0]
        templates.append(LevelTemplate(u=u_t, v=v_t, idepth=tid, color=color,
                                       valid=sel_ok))
        if lvl == 0:
            pc_l0 = (u_t, v_t, tid, sel_ok)
    return tuple(templates), pc_l0


def insert_frame(ba: B.BAState, T_cw_new, aff_new, exposure, prior_row):
    """Append a frame at the first free slot (EF insertFrame + the new
    cross-residual creation of makeKeyFrame, FullSystem.cpp:820-834). The
    slot stays on the device."""
    F = ba.F
    dev = ba.state.device
    slot = torch.sum(ba.frame_valid)
    sel = torch.arange(F, device=dev) == slot
    aff_state = aff_new / B.state8_scale(dev)[6:8]
    row = torch.cat([torch.zeros(6, device=dev), aff_state])
    state_new = torch.where(sel[:, None], row[None, :], ba.state)
    res_new = torch.where(sel[None, :],
                          (ba.pt_valid & (ba.host != slot))[:, None],
                          ba.res_exist)
    prev_th = at(ba.energy_th, torch.clamp(slot - 1, min=0))
    return ba._replace(
        frame_valid=ba.frame_valid | sel,
        T_cw_eval=torch.where(sel[:, None, None], T_cw_new, ba.T_cw_eval),
        state=state_new,
        state_zero=state_new,
        exposure=torch.where(sel, exposure, ba.exposure),
        energy_th=torch.where(sel, prev_th, ba.energy_th),
        prior=torch.where(sel[:, None], prior_row[None, :], ba.prior),
        res_exist=res_new,
        res_state=torch.where(sel[None, :],
                              torch.full_like(ba.res_state, B.RES_IN),
                              ba.res_state),
    )


def insert_points(ba: B.BAState, slot_idx, accepted, host, u, v, color,
                  weight, idepth, prior_w) -> B.BAState:
    """Scatter accepted candidate points into free point slots (no host
    read: `put_rows`)."""
    dev = ba.u.device

    def put(arr, vals):
        return put_rows(arr, slot_idx, accepted, vals)

    res_row = (torch.arange(ba.F, device=dev)[None, :] != host[:, None]) \
        & ba.frame_valid[None, :]
    return ba._replace(
        pt_valid=put(ba.pt_valid, torch.ones_like(accepted)),
        host=put(ba.host, host.to(torch.int32)),
        u=put(ba.u, u), v=put(ba.v, v),
        color=put(ba.color, color), weight=put(ba.weight, weight),
        idepth=put(ba.idepth, idepth), idepth_zero=put(ba.idepth_zero, idepth),
        pt_prior=put(ba.pt_prior, prior_w),
        res_exist=put(ba.res_exist, res_row),
        res_state=put(ba.res_state, torch.full_like(
            res_row, B.RES_IN, dtype=torch.int8)),
    )
