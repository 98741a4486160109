"""A PNG writer on the standard library's zlib and struct.

The headless viewer, the debug plots and the depth dumper write their
frames as PNG. The JAX package writes them through imageio; the port
writes them without it (it reads dataset images and vignettes through
imageio, and nothing else), so a run with a viewer needs no imaging
package. RGB8 only (colour type 2, bit depth 8), filter type 0 on every
row, one IDAT chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of an (H, W, 3) uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"an (H, W, 3) uint8 image is needed, not "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)     # filter byte 0 per row
    rows[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
