"""ctypes bindings for the native scene-build kernels (libvoxnative).

The reference's host runtime is native Rust; here the host-side hot
loops (grid fill, XYZI decode) have a C++
implementation built with ``make -C native``.  Everything degrades
gracefully: if the library is absent and cannot be built, callers use
the numpy implementations, which produce identical bits.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger("voxtracer.native")

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libvoxnative.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception as e:
        log.info("native build unavailable (%s); using numpy paths", e)
        return False


def get() -> Optional[ctypes.CDLL]:
    """The loaded library, built from the committed ``native/voxnative.cpp``
    on first use (``make`` is a no-op when the library is current, and
    rebuilds a stale one); None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)

    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    lib.vox_fill_grid.argtypes = [
        _i16p, _i32p, i64, i32, i32, i32, i64, i64, i64, _i32p,
    ]
    lib.vox_fill_grid.restype = None
    lib.vox_decode_xyzi.argtypes = [_u8p, i64, _i16p, _u8p]
    lib.vox_decode_xyzi.restype = None
    _lib = lib
    return _lib


def fill_grid(pos, leaves, origin, dims) -> Optional[np.ndarray]:
    lib = get()
    if lib is None:
        return None
    grid = np.zeros(int(np.prod(dims)), np.int32)
    lib.vox_fill_grid(
        np.ascontiguousarray(pos, np.int16),
        np.ascontiguousarray(leaves, np.int32),
        len(leaves),
        int(origin[0]), int(origin[1]), int(origin[2]),
        int(dims[0]), int(dims[1]), int(dims[2]),
        grid,
    )
    return grid.reshape(dims)


def decode_xyzi(raw: np.ndarray) -> Optional[tuple]:
    lib = get()
    if lib is None:
        return None
    n = len(raw)
    pos = np.zeros((n, 3), np.int16)
    ci = np.zeros(n, np.uint8)
    lib.vox_decode_xyzi(
        np.ascontiguousarray(raw.reshape(-1), np.uint8), n, pos, ci
    )
    return pos, ci
