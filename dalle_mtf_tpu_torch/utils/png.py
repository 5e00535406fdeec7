"""PNG encoding with the standard library alone (zlib + struct): the
server's image replies and the trainer's image summaries."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] (RGB) or [H, W, 1] (grey) floats in [0, 1] -> an 8-bit PNG."""
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2}[c]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))  # filter 0
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw))
        + _chunk(b"IEND", b"")
    )
