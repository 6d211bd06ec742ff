"""Build and load the package's CUDA kernels.

The sources under ``tinyslam_tpu_torch/csrc/`` export plain C entry points;
``nvcc`` compiles them for Hopper (``sm_90a``) into one shared library under
``build/tinyslam_tpu_torch/`` at the repository root, keyed by a hash of the
sources and flags, at first use.  The library is loaded with ``ctypes``:
every pointer and the CUDA stream are passed as ``c_void_p``, and each
entry point returns ``cudaGetLastError()`` after its launch.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tinyslam_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# Argument types of every C entry point (see the headers of csrc/*.cu).
_SIGNATURES = {
    "tinyslam_fast_maps": [
        _P, _P, _P, _P, _P, _P, _P,        # img, threshold, 5 outputs
        _I, _I, _I, _I,                    # h, w, border, streak
        _F, _F, _F, _F, _F, _F, _F,        # 7 blur taps
        _P,                                # stream
    ],
    "tinyslam_match_reduce": [
        _P, _P, _P, _P, _P, _P,            # desc_a, valid_a, xy_a, desc_b, valid_b, proj_b
        _I, _I, _I, _F, _I,                # n, m, guided, r2, nshift
        _P, _P, _P, _P,                    # best, second, idx, colcode
        _P,                                # stream
    ],
    "tinyslam_cuda_error_string": [_I],
}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "tinyslam_tpu_torch cannot be built")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtinyslam_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, str, float]:
    """Compile the kernels unless this source hash is built already.
    Returns (library path, compiler output, seconds spent compiling)."""
    out = library_path()
    if out.exists():
        return out, "", 0.0
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tinyslam_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at its launch."""
    if err != 0:
        msg = load_library().tinyslam_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
