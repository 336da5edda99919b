"""Minimal PNG output (pure stdlib: zlib + struct).

The reference presents frames to a window; headless rendering
writes them to disk instead.  8-bit RGB/RGBA/grayscale, no filters.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 3: 2, 4: 6}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """Encode (H, W), (H, W, 3) or (H, W, 4) uint8 as PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"unsupported channel count {c}")

    raw = b"".join(
        b"\x00" + img[row].tobytes() for row in range(h)
    )
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str | os.PathLike, image: np.ndarray) -> None:
    """Write (H, W), (H, W, 3) or (H, W, 4) uint8 to a PNG file."""
    with open(path, "wb") as fh:
        fh.write(encode_png(image))
