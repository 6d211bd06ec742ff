"""Where the pose graph's assembly kernel spends a launch, phase by phase.

    python tools/scatter_phases.py [--nodes 11 40 200]

Builds a copy of ``tinyslam_tpu_torch/csrc/scatter.cu`` in which thread 0
of every block writes the SM clock (``clock64``) and the global timer at
the kernel's phase boundaries, under ``build/scatter_phases/``, and runs it
on the first Gauss-Newton iteration's terms of a solve of
``tools/profile_pose_graph.py``'s chain of each ``--nodes`` keyframes (as
``solve_graph`` pads it).  Prints the launch's span (first block's start
to last block's end), its blocks (empty and not), and for the blocks that
end last the clock at each boundary: 0 start, 1 offsets read and positions
issued, 2 positions landed and long segments listed, 3 short segments'
copies issued, 4 long segments' copies issued, 5 terms landed, 6 sums
added, 7 end.  The traced copy is checked bit-equal to the kernel first;
the kernel's and one ``index_add_``'s device time (queued CUDA events)
are printed beside it.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

OUT = ROOT / "build" / "scatter_phases"
BLOCKS = 65536
STAMP = ("#define STAMP(i) do { if (threadIdx.x == 0 && blockIdx.x < %d) {"
         " unsigned long long g; asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(g));"
         " stamp_ns[blockIdx.x * 8 + (i)] = g; stamp_clock[blockIdx.x * 8 + (i)] = clock64(); }"
         " } while (0)\n" % BLOCKS)
PATCHES = [
    ("namespace {\n", f"__device__ unsigned long long stamp_ns[{BLOCKS * 8}], "
                      f"stamp_clock[{BLOCKS * 8}];\n" + STAMP + "namespace {\n"),
    ("  const int tid = threadIdx.x;\n  const long long s0",
     "  STAMP(0);\n  const int tid = threadIdx.x;\n  const long long s0"),
    ("    for (int i = tid; i < span; i += NT) out[s0 + i] = T(0);\n    return;",
     "    for (int i = tid; i < span; i += NT) out[s0 + i] = T(0);\n    STAMP(7);\n    return;"),
    ("    __syncthreads();                     // seg and n_long in place\n",
     "    __syncthreads();                     // seg and n_long in place\n    STAMP(1);\n"),
    ("    __syncthreads();                     // the positions and the long segments in place\n",
     "    __syncthreads();                     // the positions and the long segments in place\n"
     "    STAMP(2);\n"),
    ("      const int nl = n_long;\n", "      STAMP(3);\n      const int nl = n_long;\n"),
    ("      copy_async_wait_all();\n      __syncthreads();\n      for (int i = tid; i < span; i += NT)\n"
     "        out[s0 + i] = add_in_order(T(0), stage + seg[i], seg[i + 1] - seg[i]);\n      return;",
     "      STAMP(4);\n      copy_async_wait_all();\n      __syncthreads();\n      STAMP(5);\n"
     "      for (int i = tid; i < span; i += NT)\n"
     "        out[s0 + i] = add_in_order(T(0), stage + seg[i], seg[i + 1] - seg[i]);\n"
     "      STAMP(6);\n      STAMP(7);\n      return;"),
]
READ = """
extern "C" int stamps_read(void* ns, void* clock) {
  cudaMemcpyFromSymbol(ns, stamp_ns, sizeof(stamp_ns));
  cudaMemcpyFromSymbol(clock, stamp_clock, sizeof(stamp_clock));
  return (int)cudaGetLastError();
}
extern "C" int stamps_clear() {
  void *ns = nullptr, *clock = nullptr;
  cudaGetSymbolAddress(&ns, stamp_ns);
  cudaGetSymbolAddress(&clock, stamp_clock);
  cudaMemset(ns, 0, sizeof(stamp_ns));
  cudaMemset(clock, 0, sizeof(stamp_clock));
  return (int)cudaGetLastError();
}
"""


def _build():
    from tinyslam_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC / "scatter.cu").read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"the patch no longer matches csrc/scatter.cu:\n{old}")
        text = text.replace(old, new)
    text += READ
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "scatter_phases.cu", OUT / "scatter_phases.so"
    cu.write_text(text)
    proc = subprocess.run([cuda_build._find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    lib.stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.stamps_clear.argtypes = []
    fn = lib.tinyslam_ordered_scatter
    fn.argtypes = cuda_build._SIGNATURES["tinyslam_ordered_scatter"]
    fn.restype = ctypes.c_int
    return lib, fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[11, 40, 200])
    args = ap.parse_args()

    import torch

    import profile_pose_graph
    from chip_smoke import _FirstAssembly, _queued_ms, _smi
    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.models.slam import solve_graph
    from tinyslam_tpu_torch.ops import scatter_cuda

    if not torch.cuda.is_available():
        raise SystemExit("scatter_phases: needs the card")
    dev, smi = torch.device("cuda"), _smi()
    lib, fn = _build()

    def traced(plan, vals):
        out = torch.empty(plan.size, dtype=vals.dtype, device=dev)
        err = fn(vals.data_ptr(), plan.perm.data_ptr(), plan.ptr.data_ptr(), out.data_ptr(),
                 plan.size, int(vals.dtype == torch.float64),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"traced kernel: CUDA error {err}")
        return out

    for nodes in args.nodes:
        with _FirstAssembly() as assembly:
            solve_graph(SlamConfig(), profile_pose_graph.snapshot(nodes), dev)
        plan, vals = assembly.first
        want = scatter_cuda.ordered_scatter_add(plan, vals)
        if not torch.equal(traced(plan, vals), want):
            raise AssertionError(f"{nodes} nodes: the traced copy differs from the kernel")
        kernel_us = _queued_ms(lambda: scatter_cuda.ordered_scatter_add(plan, vals)) * 1e3
        library_us = _queued_ms(lambda: torch.zeros(plan.size, dtype=vals.dtype, device=dev)
                                .index_add_(0, plan.at, vals)) * 1e3
        for _ in range(5):
            traced(plan, vals)
        torch.cuda.synchronize()
        lib.stamps_clear()
        traced(plan, vals)
        torch.cuda.synchronize()
        ns = np.zeros(BLOCKS * 8, np.uint64)
        clock = np.zeros(BLOCKS * 8, np.uint64)
        if lib.stamps_read(ns.ctypes.data, clock.ctypes.data):
            raise RuntimeError("reading the stamps failed")
        ns, clock = ns.reshape(-1, 8).astype(np.int64), clock.reshape(-1, 8).astype(np.int64)
        ran = ns[:, 0] > 0
        t0 = ns[ran, 0].min()
        busy = ran & (ns[:, 1] > 0)
        longest = int((plan.ptr[1:] - plan.ptr[:-1]).max())
        print(f"{nodes} nodes: {plan.size} slots, {vals.numel()} terms, longest segment {longest}; "
              f"kernel {kernel_us:.2f} us, index_add_ {library_us:.2f} us (queued CUDA events); "
              f"traced launch: span {ns[ran, 7].max() - t0} ns, {int(ran.sum())} blocks "
              f"({int((ran & ~busy).sum())} empty), blocks started over "
              f"{ns[ran, 0].max() - t0} ns  [{smi}]", flush=True)
        for b in np.argsort(-np.where(busy, ns[:, 7], 0))[:3]:
            print(f"  block {b}: clock at the phase boundaries "
                  f"{[int(c - clock[b, 0]) for c in clock[b]]} cycles, ends "
                  f"{ns[b, 7] - t0} ns after the first block's start", flush=True)


if __name__ == "__main__":
    main()
