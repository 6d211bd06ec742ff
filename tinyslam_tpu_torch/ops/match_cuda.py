"""Streaming Hamming matcher on Hopper: the wrapper of ``csrc/match.cu``.

Replaces the TPU kernel ``tinyslam_tpu/ops/match_pallas.py:
match_reduce_streaming``.  All-pairs Hamming distances between N features
and M map points are reduced without ever storing the (N, M) matrix: per
row the best distance, its argmin and the second best excluding exactly
the argmin column; per column the argmin over rows, for the cross-check.
Each distance is XOR + popcount over the 8 packed words; an invalid row or
column, or a pair outside the guided gate ``|xy - proj|^2 < r^2``, is
replaced by ``BIG`` = 2^14, which is the plain version's
(``ops/hamming.py:match_reduce_plain``) semantics for every shape and every
``MatcherConfig``, so the two agree exactly (integers).

At N=2048 x M=8192 the kernel is bound by integer throughput (16.8 M pairs
x 8 words of XOR/popcount), not by bytes (0.33 MB of descriptors).  A block
keeps 16 rows in shared memory and streams every column through registers,
each thread keeping per-row best/argmin/second in registers; the per-column
argmin is reduced over the block's rows and merged across blocks with an
atomicMin on ``dist << nshift | row``, which is deterministic because min
does not depend on order.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.ops import cuda_build
from tinyslam_tpu_torch.ops.hamming import (
    BIG, gate_radius2, match_reduce_plain,
)

LAUNCHES = 0
_INT32_MAX = 2**31 - 1


def _shift_for(n: int) -> int:
    s = 1
    while (1 << s) < n:
        s += 1
    return s


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous storage on a 16-byte boundary: the kernel reads descriptor
    rows as 16-byte vectors and coordinates as 8-byte pairs."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def match_reduce(desc_a, valid_a, desc_b, valid_b, xy_a=None, proj_b=None,
                 radius_px: float = 0.0, pair_mask=None):
    """Streamed all-pairs Hamming reduction; see ``match_reduce_plain`` for
    the outputs (best, second, idx_b, col_idx), all int32.

    desc_* (N|M, 8) int32 packed; valid_* bool; xy_a (N, 2) / proj_b (M, 2)
    float32 enable the guided gate.  An explicit ``pair_mask`` is CPU only.
    """
    if desc_a.device.type == "cpu":
        return match_reduce_plain(desc_a, valid_a, desc_b, valid_b, xy_a=xy_a,
                                  proj_b=proj_b, radius_px=radius_px,
                                  pair_mask=pair_mask)
    if desc_a.device.type != "cuda":
        raise ValueError(f"match_reduce: unsupported device {desc_a.device}")
    if pair_mask is not None:
        raise NotImplementedError(
            "match_reduce: an explicit pair_mask has no CUDA kernel; pass "
            "xy_a/proj_b/radius_px for guided matching")
    global LAUNCHES
    n, m = desc_a.shape[0], desc_b.shape[0]
    nshift = _shift_for(n)
    if not (1 <= n and 1 <= m and ((BIG << nshift) | (n - 1)) < _INT32_MAX):
        raise ValueError(f"match_reduce: unsupported shape N={n}, M={m}")
    guided = xy_a is not None and proj_b is not None
    dev = desc_a.device
    tensors = [desc_a, valid_a, desc_b, valid_b] + ([xy_a, proj_b] if guided else [])
    if any(x.device != dev for x in tensors):
        raise ValueError("match_reduce: all inputs must be on one device")
    if desc_a.shape != (n, 8) or desc_b.shape != (m, 8) \
            or desc_a.dtype != torch.int32 or desc_b.dtype != torch.int32:
        raise ValueError("match_reduce: descriptors must be (N, 8) int32")
    if valid_a.shape != (n,) or valid_b.shape != (m,) \
            or valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise ValueError("match_reduce: valid masks must be (N,) bool")
    if guided and (xy_a.shape != (n, 2) or proj_b.shape != (m, 2)
                   or xy_a.dtype != torch.float32 or proj_b.dtype != torch.float32):
        raise ValueError("match_reduce: xy_a/proj_b must be (N|M, 2) float32")
    desc_a, desc_b = _aligned(desc_a), _aligned(desc_b)
    valid_a, valid_b = valid_a.contiguous(), valid_b.contiguous()
    if guided:
        xy_a, proj_b = _aligned(xy_a), _aligned(proj_b)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty(n, dtype=torch.int32, device=dev)
    idx_b = torch.empty(n, dtype=torch.int32, device=dev)
    colcode = torch.full((m,), _INT32_MAX, dtype=torch.int32, device=dev)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        err = lib.tinyslam_match_reduce(
            desc_a.data_ptr(), valid_a.data_ptr(),
            xy_a.data_ptr() if guided else None,
            desc_b.data_ptr(), valid_b.data_ptr(),
            proj_b.data_ptr() if guided else None,
            n, m, int(guided), gate_radius2(radius_px), nshift,
            best.data_ptr(), second.data_ptr(), idx_b.data_ptr(),
            colcode.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "tinyslam_match_reduce")
    LAUNCHES += 1
    return best, second, idx_b, colcode & ((1 << nshift) - 1)
