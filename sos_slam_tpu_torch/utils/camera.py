"""Camera calibration pyramid.

Port's copy of sos_slam_tpu/utils/camera.py: the reference's global calib pyramid
(reference: src/util/globalCalib.cpp:39-99): per-level image sizes and
intrinsics, with the same level-count rule (halve while divisible by 2 and
area > 5000 px, capped at PYR_LEVELS) and the same synthetic per-level K:
    fx_l = fx_0 / 2^l,  cx_l = (cx_0 + 0.5) / 2^l - 0.5.

Held as a small frozen host-side object; per-level scalars are passed to
the device code as Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from sos_slam_tpu_torch.utils.config import PYR_LEVELS


def num_pyramid_levels(w: int, h: int, max_levels: int = PYR_LEVELS) -> int:
    """Level-count rule from globalCalib.cpp:39-48."""
    levels = 1
    wl, hl = w, h
    while wl % 2 == 0 and hl % 2 == 0 and wl * hl > 5000 and levels < max_levels:
        wl //= 2
        hl //= 2
        levels += 1
    return levels


@dataclass(frozen=True)
class CalibPyramid:
    """Per-level (w, h, fx, fy, cx, cy). All plain Python/NumPy (static)."""

    widths: Tuple[int, ...]
    heights: Tuple[int, ...]
    fx: Tuple[float, ...]
    fy: Tuple[float, ...]
    cx: Tuple[float, ...]
    cy: Tuple[float, ...]

    @property
    def levels(self) -> int:
        return len(self.widths)

    def K(self, lvl: int) -> np.ndarray:
        return np.array(
            [
                [self.fx[lvl], 0.0, self.cx[lvl]],
                [0.0, self.fy[lvl], self.cy[lvl]],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )

    def Ki(self, lvl: int) -> np.ndarray:
        return np.linalg.inv(self.K(lvl)).astype(np.float32)

    def intrinsics(self, lvl: int) -> Tuple[float, float, float, float]:
        return (self.fx[lvl], self.fy[lvl], self.cx[lvl], self.cy[lvl])


def make_calib_pyramid(
    w: int, h: int, fx: float, fy: float, cx: float, cy: float,
    max_levels: int = PYR_LEVELS,
) -> CalibPyramid:
    n = num_pyramid_levels(w, h, max_levels)
    ws, hs = [w], [h]
    fxs, fys, cxs, cys = [float(fx)], [float(fy)], [float(cx)], [float(cy)]
    for lvl in range(1, n):
        ws.append(w >> lvl)
        hs.append(h >> lvl)
        fxs.append(fxs[lvl - 1] * 0.5)
        fys.append(fys[lvl - 1] * 0.5)
        cxs.append((cx + 0.5) / (1 << lvl) - 0.5)
        cys.append((cy + 0.5) / (1 << lvl) - 0.5)
    return CalibPyramid(tuple(ws), tuple(hs), tuple(fxs), tuple(fys),
                        tuple(cxs), tuple(cys))
