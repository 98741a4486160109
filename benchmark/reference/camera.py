"""The camera model the benchmark renders with and checks the intake
against: a plain NumPy float64 reading of the camera.txt format (RadTan
model, raw size, `crop`, output size), the `crop` output calibration, and
the rectifying remap of a raw 8-bit frame.

A frozen copy of the plain forms (DSO's Undistort: readFromFile,
makeOptimalK_crop, distortCoordinates for RadTan, and a bilinear remap
that zeroes pixels whose source lies outside the raw frame), kept here so
the yardstick does not follow the program. It imports nothing of the
program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class CameraModel:
    pars: np.ndarray      # fx fy cx cy k1 k2 p1 p2 of the raw camera
    w_raw: int
    h_raw: int
    w: int
    h: int

    @staticmethod
    def load(path: str) -> "CameraModel":
        with open(path) as f:
            lines = [f.readline().split() for _ in range(4)]
        if lines[0][0] != "RadTan" or len(lines[0]) != 9:
            raise ValueError(f"{path}: expected 'RadTan fx fy cx cy k1 k2 "
                             "p1 p2'")
        if lines[2] != ["crop"]:
            raise ValueError(f"{path}: expected the output mode 'crop'")
        pars = np.array([float(v) for v in lines[0][1:]], np.float64)
        w_raw, h_raw = (int(v) for v in lines[1])
        w, h = (int(v) for v in lines[3])
        return CameraModel(pars, w_raw, h_raw, w, h)

    def distort_normalized(self, x, y):
        """RadTan: undistorted normalized -> distorted normalized."""
        k1, k2, p1, p2 = self.pars[4:8]
        x2, y2, xy = x * x, y * y, x * y
        r2 = x2 + y2
        rad = k1 * r2 + k2 * r2 * r2
        return (x + x * rad + 2 * p1 * xy + p2 * (r2 + 2 * x2),
                y + y * rad + 2 * p2 * xy + p1 * (r2 + 2 * y2))

    def undistort_normalized(self, xd, yd, iters: int = 40):
        """The inverse of `distort_normalized` by fixed-point iterations."""
        k1, k2, p1, p2 = self.pars[4:8]
        x, y = xd.copy(), yd.copy()
        for _ in range(iters):
            x2, y2, xy = x * x, y * y, x * y
            r2 = x2 + y2
            rad = 1 + k1 * r2 + k2 * r2 * r2
            x = (xd - 2 * p1 * xy - p2 * (r2 + 2 * x2)) / rad
            y = (yd - 2 * p2 * xy - p1 * (r2 + 2 * y2)) / rad
        return x, y

    def _to_raw(self, x, y):
        fx, fy, cx, cy = self.pars[:4]
        xd, yd = self.distort_normalized(x, y)
        return fx * xd + cx, fy * yd + cy

    def crop_K(self) -> np.ndarray:
        """makeOptimalK_crop: the widest rectangle of normalized
        coordinates whose border maps inside the raw frame."""
        W, H = self.w_raw, self.h_raw
        t = (np.arange(100000) - 50000.0) / 10000.0
        dx, _ = self._to_raw(t, np.zeros_like(t))
        xs = t[(dx > 0) & (dx < W - 1)]
        minX, maxX = xs.min(), xs.max()
        _, dy = self._to_raw(np.zeros_like(t), t)
        ys = t[(dy > 0) & (dy < H - 1)]
        minY, maxY = ys.min(), ys.max()
        minX *= 1.01; maxX *= 1.01; minY *= 1.01; maxY *= 1.01
        w, h = self.w, self.h
        for _ in range(500):
            yy = minY + (maxY - minY) * np.arange(h) / (h - 1.0)
            lx, _ = self._to_raw(np.full(h, minX), yy)
            rx, _ = self._to_raw(np.full(h, maxX), yy)
            oobL = np.any(~((lx > 0) & (lx < W - 1)))
            oobR = np.any(~((rx > 0) & (rx < W - 1)))
            xx = minX + (maxX - minX) * np.arange(w) / (w - 1.0)
            _, ty = self._to_raw(xx, np.full(w, minY))
            _, by = self._to_raw(xx, np.full(w, maxY))
            oobT = np.any(~((ty > 0) & (ty < H - 1)))
            oobB = np.any(~((by > 0) & (by < H - 1)))
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
        K = np.eye(3)
        K[0, 0] = (w - 1.0) / (maxX - minX)
        K[1, 1] = (h - 1.0) / (maxY - minY)
        K[0, 2] = -minX * K[0, 0]
        K[1, 2] = -minY * K[1, 1]
        return K

    def remap_coords(self, K: np.ndarray):
        """(rx, ry, valid) (h, w): where each output pixel samples the raw
        frame."""
        xx, yy = np.meshgrid(np.arange(self.w, dtype=np.float64),
                             np.arange(self.h, dtype=np.float64))
        rx, ry = self._to_raw((xx - K[0, 2]) / K[0, 0],
                              (yy - K[1, 2]) / K[1, 1])
        valid = (rx > 0) & (rx < self.w_raw - 1) & (ry > 0) \
            & (ry < self.h_raw - 1)
        return rx, ry, valid


def remap(raw: np.ndarray, rx: np.ndarray, ry: np.ndarray,
          valid: np.ndarray, mantissa: Optional[int] = None) -> np.ndarray:
    """Bilinear samples of `raw` (float64) at (rx, ry); 0 where invalid.
    With `mantissa`, the coordinates and the weights are rounded to that
    many mantissa bits first (TF32: 10), as a lower-precision remap would
    hold them."""
    img = np.asarray(raw, np.float64)
    H, W = img.shape
    if mantissa is not None:
        rx, ry = round_mantissa(rx, mantissa), round_mantissa(ry, mantissa)
    x0 = np.clip(np.floor(rx), 0, W - 2).astype(np.int64)
    y0 = np.clip(np.floor(ry), 0, H - 2).astype(np.int64)
    dx = np.clip(rx - x0, 0.0, 1.0)
    dy = np.clip(ry - y0, 0.0, 1.0)
    if mantissa is not None:
        dx, dy = round_mantissa(dx, mantissa), round_mantissa(dy, mantissa)
    out = (img[y0, x0] * (1 - dx) * (1 - dy) + img[y0, x0 + 1] * dx * (1 - dy)
           + img[y0 + 1, x0] * (1 - dx) * dy + img[y0 + 1, x0 + 1] * dx * dy)
    return np.where(valid, out, 0.0)


def round_mantissa(x: np.ndarray, bits: int) -> np.ndarray:
    """`x` rounded to `bits` explicit mantissa bits (TF32: 10), to nearest."""
    m, e = np.frexp(np.asarray(x, np.float64))
    scale = float(1 << (bits + 1))
    return np.ldexp(np.round(m * scale) / scale, e)
