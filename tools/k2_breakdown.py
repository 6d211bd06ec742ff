"""Where K2's time goes on the card: the committed kernel against copies
with one part taken out, at the main path's shapes.

Each variant is ``tinyslam_tpu_torch/csrc/match.cu`` with a text patch
(no epilogue, no wgmma, no unpacking of the column tiles, no merge tail, an
empty kernel), built with ``nvcc`` under ``build/k2_breakdown/`` and timed
through the port's own wrapper with the profiler's device time.  Only the
unpatched kernel computes the right answer; it is checked against the plain
version first.  Run it on the card from the repository root:

    python tools/k2_breakdown.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tinyslam_tpu_torch.ops import cuda_build, match_cuda  # noqa: E402
from tinyslam_tpu_torch.ops.hamming import match_reduce_plain  # noqa: E402

OUT = ROOT / "build" / "k2_breakdown"
EPILOGUE = ("    unsigned cm2[BN / 8];   // per j, the column codes' minima over this thread's rows\n"
            "#pragma unroll\n    for (int j = 0; j < BN / 8; ++j) {")
PATCHES = {
    "kernel": [],
    "no epilogue": [(EPILOGUE, EPILOGUE.replace(
        "#pragma unroll\n    for", "    for (int k = 0; k < 32; ++k) {\n"
        "      lo2[0] = __vminu2(lo2[0], acc[0][k]);\n"
        "      lo2[1] = __vminu2(lo2[1], acc[1][k]);\n    }\n"
        "    for (int j = 0; j < BN / 8; ++j) cm2[j] = lo2[j & 1];\n    if (0)\n    for"))],
    "no wgmma": [("        wgmma_m64n64k32(acc[mb]", "        if (0) wgmma_m64n64k32(acc[mb]")],
    "no tile unpack": [("    store_signs(smem, OFF_B + buf * BN * KB, BN, col, w, (w >> 2), word);",
                        "    if (word == 0x12345678u)\n"
                        "    store_signs(smem, OFF_B + buf * BN * KB, BN, col, w, (w >> 2), word);"),
                       ("    store_signs(smem, OFF_B + buf * BN * KB, BN, col, w, 1 - (w >> 2), word);",
                        "    if (word == 0x12345678u)\n"
                        "    store_signs(smem, OFF_B + buf * BN * KB, BN, col, w, 1 - (w >> 2), word);")],
    "no merge tail": [("  __syncthreads();\n  if (tid == 0) s_flag[0] = arrive(",
                       "  return;\n  __syncthreads();\n  if (tid == 0) s_flag[0] = arrive(")],
    "empty kernel": [("  extern __shared__ unsigned char smem_raw[];\n  const uint32_t raw",
                      "  return;\n  extern __shared__ unsigned char smem_raw[];\n  const uint32_t raw")],
}
SHAPES = [(2048, 8192, 20.0), (2048, 8192, 0.0), (2048, 2048, 0.0)]


def _build() -> dict:
    src = (cuda_build.CSRC / "match.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, patch) in enumerate(PATCHES.items()):
        text = src
        for old, new in patch:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch no longer matches csrc/match.cu")
            text = text.replace(old, new)
        cu, so = OUT / f"match_{i}.cu", OUT / f"match_{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [cuda_build._find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu),
             *(str(p) for p in cuda_build._sources() if p.name != "match.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in cuda_build._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.tinyslam_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _case(rng, n, m, radius):
    def desc(k):
        return torch.from_numpy(rng.integers(-2**31, 2**31, (k, 8)).astype(np.int32))
    c = {"desc_a": desc(n), "valid_a": torch.from_numpy(rng.random(n) < 0.9),
         "desc_b": desc(m), "valid_b": torch.from_numpy(rng.random(m) < 0.9)}
    if radius > 0:
        c["xy_a"] = torch.from_numpy((rng.random((n, 2)) * [640, 480]).astype(np.float32))
        c["proj_b"] = torch.from_numpy((rng.random((m, 2)) * [640, 480]).astype(np.float32))
    return {k: v.cuda() for k, v in c.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_breakdown: needs a CUDA device")
    smi = chip_smoke._smi()
    libs = _build()
    rng = np.random.default_rng(0)
    cases = [(_case(rng, n, m, r), r) for n, m, r in SHAPES]
    ms = {name: [] for name in libs}
    for name, lib in libs.items():
        cuda_build.load_library = lambda lib=lib: lib
        if name == "kernel":
            for case, r in cases:
                got = match_cuda.match_reduce(**case, radius_px=r)
                want = match_reduce_plain(**case, radius_px=r)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError("the unpatched kernel disagrees with the plain version")
        for case, r in cases:
            ms[name].append(chip_smoke._device_ms(
                lambda case=case, r=r: match_cuda.match_reduce(**case, radius_px=r), reps=50))
    head = " | ".join(f"{n}x{m} {'guided r=%g' % r if r else 'unguided'}" for n, m, r in SHAPES)
    print(f"K2 device us, {head}  [{smi}]")
    for name, row in ms.items():
        print(f"  {name:15s} " + " | ".join("not measured" if v is None else f"{1e3 * v:.2f}"
                                             for v in row))


if __name__ == "__main__":
    main()
