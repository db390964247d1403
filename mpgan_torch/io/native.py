"""ctypes bindings of the port's native ``.uni`` codec — counterpart of
``mpgan_tpu/io/native.py``.

The source is the port's own copy, ``mpgan_torch/csrc/uni_native.cpp``.
It is compiled with g++ at first use into the git-ignored
``mpgan_torch/_build/`` (:func:`mpgan_torch._build.build_host`); the JAX
package's library in ``native/`` is never loaded. Without a toolchain or
zlib, :func:`get_lib` returns None and the callers (the loader,
:func:`mpgan_torch.infer.load.read_uni_volume`) decode with the pure-Python
codec, :mod:`mpgan_torch.io.uni`. ctypes calls release the GIL, so
:func:`read_many` decodes files in parallel on a thread pool — the
dataset-load hot path. This is a host codec: no tensor and no card is
involved.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from mpgan_torch import _build
from mpgan_torch.io import uni

_lib = None
_lib_lock = threading.Lock()


def get_lib() -> Any | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib or None
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        try:
            lib = ctypes.CDLL(str(_build.build_host("uni_native")))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _lib = False
            return None
        lib.uni_read_header.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int32)]
        lib.uni_read_header.restype = ctypes.c_int
        lib.uni_read_data.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int64]
        lib.uni_read_data.restype = ctypes.c_int64
        lib.uni_write.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int]
        lib.uni_write.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    return get_lib() is not None


def _need_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native uni codec unavailable")
    return lib


def read_header(path: str) -> dict:
    dims = (ctypes.c_int32 * 7)()
    rc = _need_lib().uni_read_header(path.encode(), dims)
    if rc != 0:
        raise IOError(f"uni_read_header({path}) failed: {rc}")
    return dict(dimZ=dims[0], dimY=dims[1], dimX=dims[2], channels=dims[3],
                elementType=dims[4], dimT=dims[5], gridType=dims[6])


def read_gridtype(path: str) -> int:
    """gridType bits via the native header probe (no Python gzip decode).

    A gridType of 0 (TypeNone, which mantaflow never writes for a real
    grid) is checked with the pure-Python header peek, as the JAX package
    does for libraries built before the probe exported it."""
    gt = read_header(path)["gridType"]
    if gt == 0:
        return uni.read_gridtype(path)
    return gt


def read(path: str) -> np.ndarray:
    """Decode one .uni file → (Z, Y, X, C) array (float32 or int32), with a
    leading T axis when ``dimT > 1``."""
    lib = _need_lib()
    h = read_header(path)
    dtype = np.int32 if h["elementType"] == uni.ELEM_INT else np.float32
    shape = (h["dimZ"], h["dimY"], h["dimX"], h["channels"])
    if h["dimT"] > 1:
        shape = (h["dimT"],) + shape
    out = np.empty(shape, dtype=dtype)
    n = lib.uni_read_data(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                          out.nbytes)
    if n != out.nbytes:
        raise IOError(f"uni_read_data({path}) returned {n}, want {out.nbytes}")
    return out


def write(path: str, arr: np.ndarray, grid_type: int, element_type: int,
          info: bytes = b"mpgan_torch", timestamp: int = 0,
          level: int = 1) -> None:
    """Encode a (Z, Y, X, C) array as an MNT3 .uni file, atomically (a
    temporary file, then ``os.replace``), as :func:`uni.writeUni` does: an
    existing file is always a complete one for restart logic."""
    lib = _need_lib()
    arr = np.ascontiguousarray(
        arr, dtype=np.int32 if element_type == uni.ELEM_INT else np.float32)
    dims = (ctypes.c_int32 * 4)(*arr.shape)
    tmp = path + ".tmp"
    rc = lib.uni_write(tmp.encode(), dims, grid_type, element_type,
                       arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes,
                       info, timestamp, level)
    if rc != 0:
        raise IOError(f"uni_write({path}) failed: {rc}")
    os.replace(tmp, path)


def read_many(paths: list[str], workers: int = 8) -> list[np.ndarray]:
    """Parallel decode (ctypes releases the GIL → real thread parallelism)."""
    _need_lib()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(read, paths))
