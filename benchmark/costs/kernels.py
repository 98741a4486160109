"""What each kernel must move and compute at given shapes, and the H100's
peaks: the yardstick of the `<kernel>_roofline` metrics. Copied from the
program's chip_smoke.py (k1_bytes, k3_bytes, k3_flops, bound), where the
counts were derived from csrc/pyramid.cu and csrc/ba_fused.cu: each input
read once, each output written once, whatever a kernel reads again."""

from __future__ import annotations

from typing import Tuple

# NVIDIA's data sheet, H100 SXM at its 700 W limit: HBM3 bandwidth and
# float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time the card could take, and which of the two bounds it."""
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_f = flops / H100_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def k1_bytes(w: int, h: int, n_levels: int) -> int:
    """K1 (csrc/pyramid.cu), one call for n_levels of a w x h frame: the
    frame read once (the coarser levels are formed from it and never cross
    device memory) and, per pixel of every level, [I, dx, dy] and |grad|^2
    written once."""
    px = sum((w >> lv) * (h >> lv) for lv in range(n_levels))
    return 4 * (w * h + px * (3 + 1))


def k1_flops(w: int, h: int, n_levels: int) -> int:
    """K1's operations: 12 a pixel of every level (chip_smoke.py's
    count); bytes bound it by far."""
    return 12 * sum((w >> lv) * (h >> lv) for lv in range(n_levels))


def k3_bytes(P: int, F: int, D: int) -> int:
    """K3 (csrc/ba_fused.cu) at P points, F frames: in: taps [I,dx,dy] +
    ok (P,F,8,4) f32; 24 f32 per point; res_exist + OOB (P,F); 150 f32 per
    (host, target); b0, energy_th, frame_valid; out: v (D,P), srows (4,P),
    energy + energy_raw (F,P) f32, state (F,P) int8, acc (F,F,13,13) and
    [H_sc | b_sc] (D,D+1) f32."""
    n_in = P * F * 8 * 4 + P * 24 + 2 * P * F + F * F * 150 + 3 * F
    n_out = D * P + 4 * P + 2 * F * P + F * F * 169 + D * (D + 1)
    return 4 * (n_in + n_out) + F * P


def k3_flops(P: int, F: int, D: int) -> int:
    """K3's floating-point operations in GN mode: 1034 a (point, frame) in
    the residual pass, 1456 for its 13x13 cell sums, and the Schur sums a
    point (chip_smoke.py's count, taken from csrc/ba_fused.cu)."""
    return P * F * (1034 + 1456) + P * (D + 2 * (D * (D + 1) // 2 + D) + 6)
