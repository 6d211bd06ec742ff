"""Minimal PNG writer (mirrors ``tinyslam_tpu/data/png.py``).

Writes 8-bit gray and RGB and 16-bit gray, the formats TUM RGB-D ships
(rgb/*.png 8-bit RGB, depth/*.png 16-bit gray); byte-identical to the JAX
package's files.  The native decoder (``native/decode.cpp``) is tested
against it round trip.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """img: (H, W) uint8/uint16 or (H, W, 3) uint8."""
    img = np.asarray(img)
    if img.ndim == 2:
        color, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, channels = 2, 3
    else:
        raise ValueError(f"unsupported shape {img.shape}")
    if img.dtype == np.uint8:
        depth, raw = 8, img
    elif img.dtype == np.uint16:
        if color != 0:
            raise ValueError("16-bit only for grayscale")
        depth, raw = 16, img.astype(">u2")   # PNG 16-bit samples are big-endian
    else:
        raise ValueError(f"unsupported dtype {img.dtype}")

    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    rows = raw.reshape(h, -1).view(np.uint8).reshape(h, w * channels * (depth // 8))
    scan = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(scan, 6)))
        f.write(_chunk(b"IEND", b""))
