"""Build and load the package's CUDA kernels.

The sources under ``tinyslam_tpu_torch/csrc/`` export plain C entry points;
``nvcc`` compiles them for Hopper (``sm_90a``), one process a source, all
started together, and links them into one shared library under
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# Argument types of every C entry point (see the headers of csrc/*.cu).
_SIGNATURES = {
    "tinyslam_fast_pyramid": [
        _P, _P, _I, _I,                    # level pointers, level dims, n_levels, batch
        _P, _I, _I, _I, _P,                # threshold, its stride, border, streak, blur taps
        _P,                                # stream
    ],
    "tinyslam_match_reduce": [
        _P, _P, _P, _P, _P, _P,            # desc_a, valid_a, xy_a, desc_b, valid_b, proj_b
        _P, _I,                            # packed pair mask, its words a row
        _I, _I, _I, _I, _F, _I, _I, _I, _I,  # batch, n, m, mode, r2, nshift, cbits,
                                             # slices, tps
        _P, _P, _P, _P,                    # best, second, idx, col_idx
        _P, _P, _P,                        # row_part, colcode, counters
        _P,                                # stream
    ],
    "tinyslam_match_ctas_per_sm": [_I],   # mode
    "tinyslam_pack_mask": [_P, _I, _I, _I, _P, _P],   # mask, rows, m, words, out, stream
    "tinyslam_ordered_scatter": [
        _P, _P, _P, _P, _I, _I,            # vals, perm, ptr, out, size, float64
        _P,                                # stream
    ],
    "tinyslam_graph_if_begin": [_P, _P, _I, _P],   # stream, pred, negate, body stream
    "tinyslam_graph_if_end": [_P],                 # body stream
    "tinyslam_graph_while_begin": [_P, _P, _P, _P],  # stream, pred, body stream, handle out
    "tinyslam_graph_while_end": [_P, ctypes.c_ulonglong, _P],  # body stream, handle, pred
    "tinyslam_stamp_mark": [_P, _P],               # slot, stream
    "tinyslam_stamp_add": [_P, _P, _P],            # begin, accumulator, stream
    "tinyslam_stamp_step": [_P, _P, _I, _P],       # begin, replay ring, its pairs, stream
    "tinyslam_stamp_calibrate": [_P, _I, _P],      # stream, trials, out (3 int64)
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
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [(p, p.communicate()[0]) for p in procs]
    failed = [log for p, log in logs if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(link.stdout + link.stderr)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out, "".join(log for _, log in logs), seconds


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
