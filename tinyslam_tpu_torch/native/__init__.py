"""ctypes bindings to the native image decoder and prefetching frame loader
(mirrors ``tinyslam_tpu/native/__init__.py``: ``decode_image``,
``FrameLoader``).

``decode.cpp`` and ``loader.cpp`` are compiled with ``g++`` at first use
into one shared library under ``build/tinyslam_tpu_torch/`` at the
repository root, keyed by a hash of the sources and flags, as
``ops/cuda_build.py`` builds the CUDA kernels.  Several processes may
build at once: each compiles to a name of its own and renames it into
place.  Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tinyslam_tpu_torch"
SOURCES = ("decode.cpp", "loader.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")

_I32P = ctypes.POINTER(ctypes.c_int32)
# ts_loader_* return codes.
END, DECODE_FAILED, TOO_SMALL = -1, -2, -3


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libtinyslam_native_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> Path:
    """Compile the library unless this source hash is built already; a
    failed build raises with the compiler's output."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native frame loader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, *(str(SRC / s) for s in SOURCES),
                           "-lz", "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the native frame loader:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    lib = ctypes.CDLL(str(build()))
    lib.ts_decode_image.restype = ctypes.c_int
    lib.ts_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                                    _I32P, _I32P, _I32P, _I32P]
    lib.ts_loader_create.restype = ctypes.c_void_p
    lib.ts_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int32]
    lib.ts_loader_peek.restype = ctypes.c_int64
    lib.ts_loader_peek.argtypes = [ctypes.c_void_p, _I32P, _I32P, _I32P, _I32P]
    lib.ts_loader_next.restype = ctypes.c_int64
    lib.ts_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                   _I32P, _I32P, _I32P, _I32P]
    lib.ts_loader_destroy.restype = None
    lib.ts_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _image(buf: np.ndarray, h, w, c) -> np.ndarray:
    img = buf.reshape(h.value, w.value, c.value)
    return img[..., 0] if c.value == 1 else img


def decode_image(path: str | os.PathLike) -> np.ndarray:
    """Decode PNG/PGM/PPM to (H, W) or (H, W, C) uint8/uint16."""
    lib = get_lib()
    w, h, c, bd = (ctypes.c_int32() for _ in range(4))
    p = str(path).encode()
    rc = lib.ts_decode_image(p, None, 0, w, h, c, bd)
    if rc != 0:
        raise IOError(f"cannot decode {path} (rc={rc})")
    buf = np.empty(h.value * w.value * c.value, np.uint16 if bd.value == 16 else np.uint8)
    rc = lib.ts_decode_image(p, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes, w, h, c, bd)
    if rc != 0:
        raise IOError(f"decode failed for {path} (rc={rc})")
    return _image(buf, h, w, c)


class FrameLoader:
    """Iterator over decoded image files, in order, prefetched by a native
    thread pool (``capacity`` frames in flight).  A frame that fails to
    decode raises ``IOError`` (the stream goes on after it); the end of the
    stream, or ``close()``, stops the workers."""

    def __init__(self, paths: list[str | os.PathLike], capacity: int = 8, threads: int = 4):
        self._lib = get_lib()
        self._h = None
        self._next = 0
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h = self._lib.ts_loader_create(arr, len(self._paths), capacity, threads)
        if not self._h:
            raise RuntimeError("loader creation failed")

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is None:
            raise StopIteration
        w, h, c, bd = (ctypes.c_int32() for _ in range(4))
        if self._lib.ts_loader_peek(self._h, w, h, c, bd) == END:
            self.close()
            raise StopIteration
        buf = np.empty(h.value * w.value * c.value, np.uint16 if bd.value == 16 else np.uint8)
        rc = self._lib.ts_loader_next(self._h, buf.ctypes.data_as(ctypes.c_void_p),
                                      buf.nbytes, w, h, c, bd)
        if rc == END:
            self.close()
            raise StopIteration
        path, self._next = self._paths[self._next].decode(), self._next + 1
        if rc == DECODE_FAILED:
            raise IOError(f"frame decode failed: {path}")
        if rc == TOO_SMALL:
            raise IOError(f"buffer too small: {path}")
        return _image(buf, h, w, c)

    def close(self):
        if self._h is not None:
            self._lib.ts_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
