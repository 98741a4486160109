"""Direct coarse tracking: frame-to-keyframe photometric alignment
(port of sos_slam_tpu/ops/tracker.py; reference CoarseTracker::
trackNewestCoarse / calcResPose / calcGSSSEPose, CoarseTracker.cpp:366-764).

Motion hypotheses are a leading batch axis K throughout: one call tracks K
initial poses at once (the JAX package's vmap). The Levenberg loop runs
while any hypothesis is still active; finished hypotheses are frozen by
masks, which is exactly the batched while-loop semantics of the JAX form.

Every control point (the cutoff-doubling loop, the re-pass at a raised
cutoff, the LM loop, the level repeat) runs in one of two forms:
  * eager (the default): the host reads the condition, one sync a trip,
    and leaves a loop early;
  * bounded (`bounded=True`), with no host read: each loop is an
    `ops/control.py` `while_loop` and each branch a `cond`, which inside a
    CUDA graph's capture are conditional nodes (the JAX package's
    `lax.while_loop` and `lax.cond`: the loop leaves, the branch is
    skipped, on the device) and elsewhere run each loop to its bound and
    each branch always. Each update is chosen by the masks (`go`, `redo`,
    `active`, `do_rep`), so a trip past the early exit changes no bit:
    both give the eager form's bits (as the JAX package's `SOS_TRACK_UNROLL`
    cond unroll gives its while loop's).

On a card every pass over a level's template and every LM trip goes
through K5 (csrc/tracker.cu): `track_res`, one launch a pass (residual,
Jacobian, normal sums), and `track_step`, one launch for the rest of a
trip (accept, lambda, selects, the next trial's damped solve and SE(3)
exponential), which writes the LM state in place and the loop's condition
as one device bool: an LM trip is two launches (`tracker_trip`). On the CPU
the same functions run their plain twins (`res_and_hb_plain`,
`_solve_damped`, `lie.se3_exp`) on the same packed buffers, so one
definition serves both.

Parity: Jacobian, Huber/cutoff energy, (1/n) normalization, DSO's
conditioning rescale S = [1,1,1,.5,.5,.5,10,1000], lambda schedule
(x0.5 / x4), extrapolation factor, inc-norm break at 1e-3, the
cutoff-doubling loop and the per-level iteration caps {10,20,50,50,50}.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops.numerics import solve
from sos_slam_tpu_torch.ops.image import interp_bilinear
from sos_slam_tpu_torch.utils import cuda_build as CB
from sos_slam_tpu_torch.utils import lie

_SCALE8 = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)
MAX_ITERS_PER_LEVEL = (10, 20, 50, 50, 50, 50)
LAMBDA_EXTRAPOLATION_LIMIT = 1e-3
CUTOFF_DOUBLINGS = 6   # the repeat runs 1 -> 64 under repeat < 50

# the buffers of csrc/tracker.cu, floats a hypothesis (tests/
# test_torch_kernel_abi.py holds them to its #defines): a pass's record
REC, R_E, R_IN, R_SAT, R_FT, R_FRT, R_B, R_H = 80, 0, 1, 2, 3, 4, 5, 13
# the LM state
ST, S_IT, S_DONE, S_LAM, S_E, S_NUM, S_RMS, S_AFF, S_T, S_B, S_H = (
    96, 0, 1, 2, 3, 4, 5, 6, 8, 24, 32)
# the trial the next pass reads: pose, affine parameters, |increment|
TRI, X_T, X_AFF, X_INC = 20, 0, 16, 18
K5_PART = 51            # floats of a block's row of partials
K5_POINTS = 256 * 2     # template points a block takes
OPEN, TRIP = 0, 1       # track_step's modes


def _set(d: dict, bounded: bool, **new) -> None:
    """Update a loop's state: in place in the bounded forms (a CUDA graph
    keeps the buffers it captured), by rebinding in the eager one."""
    if bounded:
        for k, v in new.items():
            d[k].copy_(v)
    else:
        d.update(new)


def _any(mask: torch.Tensor) -> torch.Tensor:
    """Whether any lane of a device bool mask holds, as a one-element
    tensor (a mask of one lane is its own answer: no reduction)."""
    return mask if mask.numel() == 1 else mask.any()


def _loop(bounded: bool, go_fn, body, cap: int) -> int:
    """`body()` while the device bool lane mask `go_fn()` holds on any
    lane, at most `cap` times: a `control.while_loop` in the bounded form
    (returns 0), read on the host each trip in the eager one (returns the
    trips made)."""
    if bounded:
        control.while_loop(lambda: _any(go_fn()), body, cap)
        return 0
    k = 0
    while k < cap and bool(_any(go_fn())):
        body()
        k += 1
    return k


def _branch(bounded: bool, pred, fn, out: dict) -> None:
    """`out.update(fn())` where the lane mask `pred` holds on any lane (fn
    selects by the lanes itself): a `control.cond` into `out`'s tensors
    in the bounded form, read on the host in the eager one."""
    if bounded:
        control.cond(_any(pred), fn, None, out=out)
    elif bool(_any(pred)):
        out.update(fn())


class LevelTemplate(NamedTuple):
    """Padded semi-dense tracking template at one pyramid level."""

    u: torch.Tensor       # (N,) pixel x in the reference KF
    v: torch.Tensor       # (N,) pixel y
    idepth: torch.Tensor  # (N,) inverse depth in the reference KF
    color: torch.Tensor   # (N,) reference intensity
    valid: torch.Tensor   # (N,) bool


def aff_from_to(exp_f, exp_t, aff_f, aff_t) -> torch.Tensor:
    """Exposure-aware affine transfer (a, b): I_t ~= a * I_f + b.
    aff_* carry [a, b] on their leading axis."""
    exp_f = torch.where(exp_f == 0, torch.ones_like(exp_f), exp_f)
    exp_t = torch.where(exp_t == 0, torch.ones_like(exp_t), exp_t)
    a = torch.exp(aff_t[0] - aff_f[0]) * exp_t / exp_f
    b = aff_t[1] - a * aff_f[1]
    return torch.stack([a, b])


def res_and_hb(dI_new, tmpl: LevelTemplate, T: torch.Tensor, aff_ab, ref_b0,
               intr, cutoff, huber: float, compute_flow: bool = False):
    """One fused residual + Gauss-Newton pass at one level, for K poses.

    T (K,4,4); aff_ab (K,2) transfer [a, b]; ref_b0 scalar; cutoff (K,).
    Returns dict of (K,...) E, num_in, num_sat, H (8,8), b (8,) and
    optionally the flow indicators. On CPU tensors the plain twin
    (`res_and_hb_plain`); on CUDA tensors one K5 launch."""
    if dI_new.device.type == "cpu":
        return res_and_hb_plain(dI_new, tmpl, T, aff_ab, ref_b0, intr,
                                cutoff, huber, compute_flow)
    return _res_and_hb_k5(dI_new, tmpl, T, aff_ab, ref_b0, intr, cutoff,
                          huber, compute_flow)


def res_and_hb_plain(dI_new, tmpl: LevelTemplate, T: torch.Tensor, aff_ab,
                     ref_b0, intr, cutoff, huber: float,
                     compute_flow: bool = False):
    """Plain twin of K5's pass (`res_and_hb`'s arguments and dict)."""
    fx, fy, cx, cy = intr
    h, w = dI_new.shape[0], dI_new.shape[1]
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    xn = torch.stack([(tmpl.u - cx) / fx, (tmpl.v - cy) / fy,
                      torch.ones_like(tmpl.u)], -1)           # (N,3)
    pt = torch.einsum("nj,kij->kni", xn, R) \
        + t[:, None, :] * tmpl.idepth[None, :, None]          # (K,N,3)
    u_ = pt[..., 0] / pt[..., 2]
    v_ = pt[..., 1] / pt[..., 2]
    Ku = fx * u_ + cx
    Kv = fy * v_ + cy
    new_idepth = tmpl.idepth[None] / pt[..., 2]
    inb = (tmpl.valid[None] & (Ku > 2) & (Kv > 2) & (Ku < w - 3)
           & (Kv < h - 3) & (new_idepth > 0))
    hit = interp_bilinear(dI_new, Ku, Kv)                     # (K,N,3)
    inb = inb & torch.isfinite(hit[..., 0])

    a_t = aff_ab[:, 0:1]
    r = hit[..., 0] - (a_t * tmpl.color[None] + aff_ab[:, 1:2])
    abs_r = torch.abs(r)
    hw = torch.where(abs_r < huber, torch.ones_like(abs_r),
                     huber / torch.clamp(abs_r, min=1e-9))
    cut = cutoff[:, None]
    saturated = inb & (abs_r > cut)
    active = inb & ~saturated
    max_energy = 2.0 * huber * cut - huber * huber
    zero = torch.zeros_like(r)
    E = torch.sum(torch.where(saturated, max_energy.expand_as(r), zero)
                  + torch.where(active, hw * r * r * (2.0 - hw), zero), -1)
    num_in = torch.sum(inb, -1)
    num_sat = torch.sum(saturated, -1)

    dxf = hit[..., 1] * fx
    dyf = hit[..., 2] * fy
    idp = new_idepth
    J = torch.stack([
        idp * dxf,
        idp * dyf,
        -idp * (u_ * dxf + v_ * dyf),
        -(u_ * v_ * dxf + dyf * (1.0 + v_ * v_)),
        u_ * v_ * dyf + dxf * (1.0 + u_ * u_),
        u_ * dyf - v_ * dxf,
        (a_t * (ref_b0 - tmpl.color[None])).expand_as(u_),
        -torch.ones_like(u_),
    ], -1)
    Jr = torch.cat([J, r[..., None]], -1)                     # (K,N,9)
    wts = torch.where(active, hw, zero)
    M = torch.einsum("kni,knj->kij", Jr * wts[..., None], Jr)
    n_act = torch.clamp(torch.sum(active, -1).to(torch.float32), min=1.0)
    H = M[:, :8, :8] / n_act[:, None, None]
    b = M[:, :8, 8] / n_act[:, None]
    out = dict(E=E, num_in=num_in, num_sat=num_sat, H=H, b=b)

    if compute_flow:
        N = tmpl.u.shape[0]
        stride = tmpl.valid & (torch.arange(N, device=tmpl.u.device) % 32 == 0)
        tid = t[:, None, :] * tmpl.idepth[None, :, None]

        def shift(pp):
            uu = fx * (pp[..., 0] / pp[..., 2]) + cx
            vv = fy * (pp[..., 1] / pp[..., 2]) + cy
            return (uu - tmpl.u) ** 2 + (vv - tmpl.v) ** 2

        ptT = xn[None] + tid
        ptT2 = xn[None] - tid
        pt3 = torch.einsum("nj,kij->kni", xn, R) - tid
        zf = torch.zeros_like(u_)
        ssT = torch.sum(torch.where(stride, shift(ptT) + shift(ptT2), zf), -1)
        ssRT = torch.sum(torch.where(stride, shift(pt) + shift(pt3), zf), -1)
        n_flow = 2.0 * torch.sum(stride)
        out["flow_t"] = ssT / (n_flow + 0.1)
        out["flow_rt"] = ssRT / (n_flow + 0.1)
    return out


# made once per device and shared (read-only): making one is a host-to-device
# copy, which a CUDA graph cannot capture and which stalls the eager form
@functools.lru_cache(maxsize=None)
def _scale_and_mask(device, dtype, fix_a: bool, fix_b: bool):
    """The conditioning scale S and the fixed-affine mask of the damped
    solve."""
    S = torch.tensor(_SCALE8, dtype=dtype, device=device)
    mask = torch.tensor([1.0] * 6 + [0.0 if fix_a else 1.0,
                                     0.0 if fix_b else 1.0],
                        dtype=dtype, device=device)
    return S, mask


def _solve_damped(H, b, lam, fix_a: bool, fix_b: bool):
    """Scaled, damped 8x8 solve for K systems. Returns (scaled step, raw
    inc for the norm check), both (K,8)."""
    S, mask = _scale_and_mask(H.device, H.dtype, fix_a, fix_b)
    Hs = H * S[:, None] * S[None, :]
    bs = b * S
    Hl = Hs + torch.diag_embed(torch.diagonal(Hs, dim1=-2, dim2=-1)) \
        * lam[:, None, None]
    Hl = Hl * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    bs = bs * mask
    inc = solve(Hl, -bs)
    extrap = torch.where(
        lam < LAMBDA_EXTRAPOLATION_LIMIT,
        torch.sqrt(torch.sqrt(LAMBDA_EXTRAPOLATION_LIMIT
                              / torch.clamp(lam, min=1e-12))),
        torch.ones_like(lam))
    inc = inc * extrap[:, None]
    inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
    return inc * S * mask, inc


def _sel(m, a, b):
    """Per-hypothesis select: m (K,) against a/b (K, ...)."""
    return torch.where(m.reshape(m.shape + (1,) * (a.dim() - 1)), a, b)


class Level(NamedTuple):
    """What every pass over one level's template shares: the (h,w,3)
    [I,dx,dy] map, the template, the reference's affine parameters (2,),
    the exposures (2,) [reference, new], the intrinsics (fx, fy, cx, cy),
    the Huber threshold and, on a card, K5's scratch: the partials and the
    tickets (zero between launches) of K hypotheses."""

    dI: torch.Tensor
    tmpl: LevelTemplate
    ref_aff: torch.Tensor
    exposures: torch.Tensor
    intr: tuple
    huber: float
    partials: torch.Tensor | None
    tickets: torch.Tensor | None


def level(dI_new, tmpl: LevelTemplate, ref_aff, exposures, intr,
          huber: float, K: int) -> Level:
    """A `Level` for K hypotheses (its tensors contiguous, its scratch made
    once here: a level's passes run in stream order and share it)."""
    partials = tickets = None
    if dI_new.device.type == "cuda":
        blocks = -(-tmpl.u.shape[0] // K5_POINTS)
        partials = torch.empty(K * blocks * K5_PART, dtype=torch.float32,
                               device=dI_new.device)
        tickets = torch.zeros(K, dtype=torch.int32, device=dI_new.device)
    return Level(dI_new.contiguous(),
                 LevelTemplate(*(t.contiguous() for t in tmpl)),
                 ref_aff.contiguous(), exposures.contiguous(),
                 tuple(float(x) for x in intr), float(huber), partials,
                 tickets)


def _record(r: dict) -> torch.Tensor:
    """`res_and_hb`'s dict as K5's (K, REC) record (the plain twin)."""
    K = r["E"].shape[0]
    rec = torch.zeros((K, REC), dtype=torch.float32, device=r["E"].device)
    for col, key in ((R_E, "E"), (R_IN, "num_in"), (R_SAT, "num_sat"),
                     (R_FT, "flow_t"), (R_FRT, "flow_rt")):
        if key in r:
            rec[:, col].copy_(r[key])
    rec[:, R_B:R_B + 8].copy_(r["b"])
    rec[:, R_H:R_H + 64].copy_(r["H"].reshape(K, 64))
    return rec


def _rows(t: torch.Tensor, what: str, shape: tuple):
    """t, a float32 (K, *shape) card tensor, with contiguous rows (copied
    only where they are not), and its row stride in floats."""
    if t.dtype != torch.float32 or tuple(t.shape[1:]) != shape:
        raise ValueError(f"K5 {what}: expected float32 (K, {shape}), got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


# csrc/tracker.cu's entry points and their argument types
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_RES_ARGS = [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I,
             _P, _I, _F, _F, _F, _F, _F, _F, _I, _P, _P, _P, _P]
_STEP_ARGS = [_I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P]


def _launch_res(lv: Level, T, aff, cutoff, flow: bool,
                transfer: bool) -> torch.Tensor:
    """One launch of `track_res_kernel`: the (K, REC) record. `transfer`:
    aff is the affine transfer [a, b] itself."""
    dev = lv.dI.device
    if dev.type != "cuda":
        raise ValueError(f"K5 track_res: unsupported device {dev}")
    h, w = lv.dI.shape[0], lv.dI.shape[1]
    if lv.dI.dtype != torch.float32 or lv.dI.shape[2] != 3:
        raise ValueError("K5 track_res takes an (h,w,3) float32 [I,dx,dy] "
                         "map")
    T, t_stride = _rows(T, "pose", (4, 4))
    aff, aff_stride = _rows(aff, "affine", (2,))
    K = T.shape[0]
    if aff.shape[0] != K or cutoff.shape != (K,) or lv.tickets is None \
            or lv.tickets.shape[0] < K:
        raise ValueError("K5 track_res: K hypotheses need K affine rows, "
                         "K cutoffs and the scratch of K")
    tm = lv.tmpl
    cutoff = cutoff.contiguous()
    rec = torch.empty((K, REC), dtype=torch.float32, device=dev)
    fx, fy, cx, cy = lv.intr
    fn = CB.function("tracker", "launch_track_res", _RES_ARGS)
    CB.check(fn(CB.ptr(lv.dI), h, w, CB.ptr(tm.u), CB.ptr(tm.v),
                CB.ptr(tm.idepth), CB.ptr(tm.color), CB.ptr(tm.valid),
                tm.u.shape[0], CB.ptr(T), t_stride, CB.ptr(aff), aff_stride,
                CB.ptr(lv.ref_aff), CB.ptr(lv.exposures), int(transfer),
                CB.ptr(cutoff), K, fx, fy, cx, cy, lv.huber,
                lv.huber * lv.huber, int(flow), CB.ptr(lv.partials),
                CB.ptr(lv.tickets), CB.ptr(rec), CB.stream_ptr(dev)),
             "track_res")
    tracker_trip.launches += 1
    return rec


def track_res(lv: Level, T, aff, cutoff, flow: bool = False) -> torch.Tensor:
    """K5's pass: `res_and_hb` at poses T (K,4,4) and affine parameters aff
    (K,2) (the transfer formed from them, the reference's and the
    exposures), cutoff (K,), as a (K, REC) record. On the CPU the plain
    twin; on a card one launch of csrc/tracker.cu (counted in
    `tracker_trip.launches`). T and aff may be row views of a buffer."""
    if lv.dI.device.type == "cpu":
        aff_ab = aff_from_to(lv.exposures[0], lv.exposures[1],
                             lv.ref_aff[:, None], aff.T).T
        return _record(res_and_hb_plain(lv.dI, lv.tmpl, T, aff_ab,
                                        lv.ref_aff[1], lv.intr, cutoff,
                                        lv.huber, compute_flow=flow))
    return _launch_res(lv, T, aff, cutoff, flow, False)


def _res_and_hb_k5(dI_new, tmpl, T, aff_ab, ref_b0, intr, cutoff, huber,
                   compute_flow):
    """`res_and_hb` on a card: one K5 pass with the transfer given."""
    K = T.shape[0]
    ref = torch.stack([torch.zeros_like(ref_b0), ref_b0]).reshape(2)
    lv = level(dI_new, tmpl, ref, ref, intr, huber, K)
    rec = _launch_res(lv, T, aff_ab, cutoff, compute_flow, True)
    out = dict(E=rec[:, R_E], num_in=rec[:, R_IN].to(torch.int64),
               num_sat=rec[:, R_SAT].to(torch.int64),
               H=rec[:, R_H:R_H + 64].reshape(K, 8, 8),
               b=rec[:, R_B:R_B + 8])
    if compute_flow:
        out["flow_t"], out["flow_rt"] = rec[:, R_FT], rec[:, R_FRT]
    return out


class LM(NamedTuple):
    """The LM loop's buffers, written in place: the state (K, ST), the
    trial (K, TRI) and the loop's condition (1,) bool."""

    st: torch.Tensor
    tri: torch.Tensor
    go: torch.Tensor

    def view(self, key: str) -> torch.Tensor:
        """A field of the state as a view: it, done, lam, E, num, rms
        (K,); aff (K,2); T (K,4,4); b (K,8); H (K,8,8)."""
        col, n, shape = _FIELDS[key]
        v = self.st[:, col] if n == 0 else self.st[:, col:col + n]
        return v.unflatten(1, shape) if shape else v

    def trial(self):
        """The trial's pose (K,4,4) and affine parameters (K,2), views."""
        return (self.tri[:, X_T:X_T + 16].unflatten(1, (4, 4)),
                self.tri[:, X_AFF:X_AFF + 2])


_FIELDS = dict(it=(S_IT, 0, None), done=(S_DONE, 0, None),
               lam=(S_LAM, 0, None), E=(S_E, 0, None), num=(S_NUM, 0, None),
               rms=(S_RMS, 0, None), aff=(S_AFF, 2, None),
               T=(S_T, 16, (4, 4)), b=(S_B, 8, None), H=(S_H, 64, (8, 8)))


def _step_plain(mode: int, rec, lm: LM, max_iters: int, fix_a: bool,
                fix_b: bool, T_in=None, aff_in=None) -> None:
    """Plain twin of `track_step`, op for op the unfused LM body."""
    v = {k: lm.view(k) for k in _FIELDS}
    if mode == OPEN:
        for k in ("it", "done"):
            v[k].fill_(0.0)
        v["lam"].fill_(0.01)
        new = dict(E=rec[:, R_E], num=rec[:, R_IN], T=T_in, aff=aff_in,
                   H=rec[:, R_H:R_H + 64].unflatten(1, (8, 8)),
                   b=rec[:, R_B:R_B + 8])
    else:
        T_new, aff_new = lm.trial()
        active = (v["done"] == 0) & (v["it"] < max_iters)
        nan = torch.full_like(v["E"], float("nan"))
        mean_new = torch.where(rec[:, R_IN] > 0, rec[:, R_E] / rec[:, R_IN],
                               nan)
        mean_old = torch.where(v["num"] > 0, v["E"] / v["num"], nan)
        accept = active & (mean_new < mean_old)
        new_lam = torch.where(accept, v["lam"] * 0.5,
                              torch.clamp(v["lam"] * 4.0,
                                          min=LAMBDA_EXTRAPOLATION_LIMIT))
        done = (v["done"] != 0) | (active & (lm.tri[:, X_INC] <= 1e-3))
        new = dict(it=v["it"] + active.to(torch.float32),
                   T=_sel(accept, T_new, v["T"]),
                   aff=_sel(accept, aff_new, v["aff"]),
                   E=_sel(accept, rec[:, R_E], v["E"]),
                   num=_sel(accept, rec[:, R_IN], v["num"]),
                   H=_sel(accept, rec[:, R_H:R_H + 64].unflatten(1, (8, 8)),
                          v["H"]),
                   b=_sel(accept, rec[:, R_B:R_B + 8], v["b"]),
                   lam=torch.where(active, new_lam, v["lam"]),
                   done=done.to(torch.float32))
    for k, x in new.items():
        v[k].copy_(x)
    num = v["num"]
    v["rms"].copy_(torch.sqrt(torch.where(
        num > 0, v["E"] / torch.clamp(num, min=1),
        torch.full_like(num, float("nan")))))
    lm.go.copy_(((v["done"] == 0) & (v["it"] < max_iters)).any()
                .reshape(1))
    step, inc_raw = _solve_damped(v["H"], v["b"], v["lam"], fix_a, fix_b)
    T_tri, aff_tri = lm.trial()
    T_tri.copy_(lie.se3_exp(step[:, :6]) @ v["T"])
    aff_tri.copy_(v["aff"] + step[:, 6:8])
    lm.tri[:, X_INC].copy_(torch.linalg.norm(inc_raw, dim=-1))


def track_step(mode: int, rec, lm: LM, max_iters: int, fix_a: bool,
               fix_b: bool, T_in=None, aff_in=None) -> None:
    """K5's rest of an LM trip (mode TRIP: the trial's pass `rec` accepted
    where its mean energy falls, lambda, `it`, `done`, the selects) or the
    loop's opening (mode OPEN: the state from the pass `rec` at T_in
    (K,4,4), aff_in (K,2)); then the loop's condition and the next trial
    (the damped solve, its increment's norm, exp(step) @ T, aff + step),
    all written into `lm` in place. On the CPU the plain twin; on a card
    one launch of csrc/tracker.cu (counted in `tracker_trip.launches`)."""
    dev = lm.st.device
    if dev.type == "cpu":
        return _step_plain(mode, rec, lm, max_iters, fix_a, fix_b, T_in,
                           aff_in)
    if dev.type != "cuda":
        raise ValueError(f"K5 track_step: unsupported device {dev}")
    K = lm.st.shape[0]
    t_ptr = a_ptr = None
    t_stride = a_stride = 0
    if mode == OPEN:
        T_in, t_stride = _rows(T_in, "pose", (4, 4))
        aff_in, a_stride = _rows(aff_in, "affine", (2,))
        t_ptr, a_ptr = CB.ptr(T_in), CB.ptr(aff_in)
    fn = CB.function("tracker", "launch_track_step", _STEP_ARGS)
    CB.check(fn(mode, K, CB.ptr(rec), t_ptr, t_stride, a_ptr, a_stride,
                CB.ptr(lm.st), CB.ptr(lm.tri), CB.ptr(lm.go), int(max_iters),
                int(fix_a), int(fix_b), CB.stream_ptr(dev)), "track_step")
    tracker_trip.launches += 1


def tracker_trip(lv: Level, lm: LM, cutoff, max_iters: int, fix_a: bool,
                 fix_b: bool) -> None:
    """One LM trip: the trial's pass and the rest of the trip, two K5
    launches on a card. `tracker_trip.launches` counts every K5 launch
    (the passes outside the loop and the loop's opening too): "K5" in
    `control.counters()`."""
    T, aff = lm.trial()
    rec = track_res(lv, T, aff, cutoff)
    track_step(TRIP, rec, lm, max_iters, fix_a, fix_b)


tracker_trip.launches = 0


def track_level(dI_new, tmpl: LevelTemplate, T0, aff0, ref_aff, exposures,
                intr, max_iters: int, coarse_cutoff_th: float, huber: float,
                fix_a: bool = False, fix_b: bool = False,
                bounded: bool = False):
    """LM at one pyramid level for K hypotheses. T0 (K,4,4), aff0 (K,2).
    Returns (T, aff, rms, cutoff_repeat, flow_t, flow_rt, iterations),
    each (K,...). `bounded`: the bounded form (module docstring)."""
    K = T0.shape[0]
    dev = T0.device
    lv = level(dI_new, tmpl, ref_aff, exposures, intr, huber, K)

    def sat_of(rec):
        return rec[:, R_SAT] / torch.clamp(rec[:, R_IN], min=1)

    cut0 = torch.full((K,), coarse_cutoff_th, dtype=torch.float32, device=dev)
    r0 = track_res(lv, T0, aff0, cut0, flow=True)
    c = dict(rep=torch.ones(K, dtype=torch.float32, device=dev),
             sat=sat_of(r0))

    def c_go():
        return (c["sat"] > 0.6) & (c["rep"] < 50.0)

    def c_body():
        go = c_go()
        rep = torch.where(go, c["rep"] * 2.0, c["rep"])
        r = track_res(lv, T0, aff0, coarse_cutoff_th * rep)
        _set(c, bounded, rep=rep, sat=torch.where(go, sat_of(r), c["sat"]))

    _loop(bounded, c_go, c_body, CUTOFF_DOUBLINGS)
    rep = c["rep"]
    cutoff = coarse_cutoff_th * rep
    redo = rep > 1.0
    out = dict(r0=r0)

    def repass():
        r1 = track_res(lv, T0, aff0, cutoff, flow=True)
        return dict(r0=_sel(redo, r1, out["r0"]))

    _branch(bounded, redo, repass, out)
    r0 = out["r0"]

    lm = LM(torch.empty((K, ST), dtype=torch.float32, device=dev),
            torch.empty((K, TRI), dtype=torch.float32, device=dev),
            torch.empty(1, dtype=torch.bool, device=dev))
    track_step(OPEN, r0, lm, max_iters, fix_a, fix_b, T0, aff0)
    _loop(bounded, lambda: lm.go,
          lambda: tracker_trip(lv, lm, cutoff, max_iters, fix_a, fix_b),
          max_iters)
    return (lm.view("T"), lm.view("aff"), lm.view("rms"), rep,
            r0[:, R_FT], r0[:, R_FRT], lm.view("it").to(torch.int32))


def track_newest_coarse(pyramid_new, templates, T_init, aff_init, ref_aff,
                        exposures, min_res_for_abort, intrinsics,
                        n_levels: int, coarse_cutoff_th: float = 20.0,
                        huber: float = 9.0, fix_a: bool = False,
                        fix_b: bool = False, min_level: int = 0,
                        bounded: bool = False, iters=None):
    """Coarse-to-fine track of K hypotheses down to `min_level`.

    T_init (K,4,4); aff_init (2,); min_res_for_abort (6,) with NaN = no
    bound. Returns dict of (K,...) T, aff, residuals (6,), flow (2,),
    good. `bounded`: the form (module docstring). `iters`: None, or a
    (K, n_levels) int32 tensor that the LM iterations run at each level
    (the repeat's included) are added to."""
    K = T_init.shape[0]
    dev = T_init.device
    T = T_init
    aff = aff_init[None].expand(K, 2).clone()
    residuals = torch.full((K, 6), float("nan"), dtype=torch.float32,
                           device=dev)
    flow = torch.zeros((K, 2), dtype=torch.float32, device=dev)
    good = torch.ones(K, dtype=torch.bool, device=dev)
    have_repeated = torch.zeros(K, dtype=torch.bool, device=dev)

    for lvl in range(n_levels - 1, min_level - 1, -1):
        max_it = MAX_ITERS_PER_LEVEL[min(lvl, len(MAX_ITERS_PER_LEVEL) - 1)]

        def run(T_, aff_, lvl=lvl, max_it=max_it):
            return track_level(pyramid_new[lvl], templates[lvl], T_, aff_,
                               ref_aff, exposures, intrinsics[lvl], max_it,
                               coarse_cutoff_th, huber, fix_a, fix_b,
                               bounded)

        T1, aff1, rms, cut_rep, ft, frt, it1 = run(T, aff)
        lv = dict(T=T1, aff=aff1, rms=rms, ft=ft, frt=frt)
        do_rep = (cut_rep > 1.0) & ~have_repeated
        have_repeated = have_repeated | do_rep
        if iters is not None:
            iters[:, lvl] += it1
            lv["it"] = iters[:, lvl]

        def repeat(T1=T1, aff1=aff1, rms=rms, ft=ft, frt=frt, do_rep=do_rep,
                   lv=lv, run=run):
            T2, aff2, rms2, _, ft2, frt2, it2 = run(T1, aff1)
            new = dict(T=_sel(do_rep, T2, T1), aff=_sel(do_rep, aff2, aff1),
                       rms=_sel(do_rep, rms2, rms), ft=_sel(do_rep, ft2, ft),
                       frt=_sel(do_rep, frt2, frt))
            if "it" in lv:
                new["it"] = lv["it"] + torch.where(do_rep, it2,
                                                   torch.zeros_like(it2))
            return new

        _branch(bounded, do_rep, repeat, lv)
        if iters is not None and not bounded:
            iters[:, lvl] = lv["it"]
        T1, aff1, rms, ft, frt = (lv[k] for k in ("T", "aff", "rms", "ft",
                                                  "frt"))

        bound = min_res_for_abort[lvl]
        lvl_ok = torch.isnan(bound) | (rms <= 1.5 * bound)
        good = good & lvl_ok & torch.isfinite(rms)
        T = _sel(good, T1, T)
        aff = _sel(good, aff1, aff)
        residuals[:, lvl] = torch.where(good, rms, torch.full_like(rms,
                                                                   float("nan")))
        if lvl == 0:
            flow = torch.stack([torch.where(good, ft, flow[:, 0]),
                                torch.where(good, frt, flow[:, 1])], -1)

    good = good & (torch.abs(aff[:, 0]) < 1.2) & (torch.abs(aff[:, 1]) < 200.0)
    good = good & torch.isfinite(T).reshape(K, -1).all(-1)
    return dict(T=T, aff=aff, residuals=residuals, flow=flow, good=good)


def track_hypotheses(pyramid_new, templates, T_inits, aff_init, ref_aff,
                     exposures, intrinsics, n_levels: int, min_level: int = 0,
                     **kw):
    """The batched multi-hypothesis track (FullSystem::trackNewCoarse's
    restarts as one batch, FullSystem.cpp:188-270)."""
    nan6 = torch.full((6,), float("nan"), dtype=torch.float32,
                      device=T_inits.device)
    return track_newest_coarse(pyramid_new, templates, T_inits, aff_init,
                               ref_aff, exposures, nan6, tuple(intrinsics),
                               n_levels, min_level=min_level, **kw)
