"""Streaming Hamming matcher on Hopper's int8 tensor cores: the wrapper of
``csrc/match.cu``.

Replaces the TPU kernel ``tinyslam_tpu/ops/match_pallas.py:
match_reduce_streaming``.  All-pairs Hamming distances between N features
and M map points are reduced without ever storing the (N, M) matrix: per
row the best distance, its argmin and the second best excluding exactly
the argmin column; per column the argmin over rows, for the cross-check.
An invalid row or column, a pair outside the guided gate
``|xy - proj|^2 < r^2``, or a pair an explicit ``pair_mask`` clears, is
replaced by ``BIG`` = 2^14, which is the plain version's (``ops/hamming.py:match_reduce_plain``) semantics for every shape
and every ``MatcherConfig``, so the two agree exactly (integers).

Each distance is (256 - sa.sb) / 2 over the +-1 unpacking of the
descriptors, from ``wgmma`` int8 products (2 x 2048 x 8192 x 256 = 8.6 G
operations at the tracked frame's shape, the bound); the epilogue keeps per
row the two smallest codes ``dist << cbits | col`` and per column the
smallest ``dist << nshift | row``, on the accumulator fragments (as 16-bit
codes, two columns to a register, until they leave the CTA).  The grid
splits rows into tiles of 128 and columns into slices; the last CTA of a
row tile merges the per-slice partials from a scratch, and the last CTA of
a slice reads its columns' codes (merged by ``atomicMin``) and resets them,
so one launch does everything and nothing is filled beforehand.  B
sequences (camera streams, each its own features, map and gate) go in one
launch, the sequence the grid's z.  An explicit (N, M) ``pair_mask`` is
bit-packed on the card (one launch of ``tinyslam_pack_mask``) and read in
the epilogue beside the codes.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tinyslam_tpu_torch.ops import cuda_build
from tinyslam_tpu_torch.ops.hamming import (
    BIG, gate_radius2, match_reduce_plain,
)

LAUNCHES = 0
_INT32_MAX = 2**31 - 1
ROW_TILE, COL_TILE = 128, 64       # csrc/match.cu: BM, BN
MAX_TPS = 16                       # csrc/match.cu: MAX_TPS, column tiles a slice
_SCRATCH: dict = {}                # per device: the kernel's counters and column codes
_RETIRED: list = []                # scratch a larger one replaced (see _scratch)
_OCCUPANCY: dict = {}              # per (device, mode): SMs, CTAs resident an SM


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
    float32 enable the guided gate; ``pair_mask`` (N, M) bool, when
    given, replaces it.  Every input may carry a leading B: B sequences,
    each its own rows, columns and gate or mask, in one launch (the
    sequence is the grid's z); the outputs are then (B, N) and (B, M).
    """
    if desc_a.device.type == "cpu":
        return match_reduce_plain(desc_a, valid_a, desc_b, valid_b, xy_a=xy_a,
                                  proj_b=proj_b, radius_px=radius_px,
                                  pair_mask=pair_mask)
    if desc_a.device.type != "cuda":
        raise ValueError(f"match_reduce: unsupported device {desc_a.device}")
    global LAUNCHES
    batched = desc_a.dim() == 3
    lead = desc_a.shape[:1] if batched else ()
    batch = desc_a.shape[0] if batched else 1
    n, m = desc_a.shape[-2], desc_b.shape[-2]
    row_tiles, col_tiles = -(-n // ROW_TILE), -(-m // COL_TILE)
    # Codes are packed over the padded shape: the kernel's padded rows and
    # columns get codes of their own (see csrc/match.cu).
    nshift, cbits = _shift_for(row_tiles * ROW_TILE), _shift_for(col_tiles * COL_TILE)
    if not (1 <= n and 1 <= m and 1 <= batch <= 65535
            and ((BIG << nshift) | ((1 << nshift) - 1)) < _INT32_MAX
            and ((BIG << cbits) | ((1 << cbits) - 1)) < _INT32_MAX):
        raise ValueError(f"match_reduce: unsupported shape B={batch}, N={n}, M={m}: the "
                         f"packed codes do not fit in int32")
    masked = pair_mask is not None
    guided = not masked and xy_a is not None and proj_b is not None
    mode = 2 if masked else int(guided)
    dev = desc_a.device
    tensors = ([desc_a, valid_a, desc_b, valid_b] + ([xy_a, proj_b] if guided else [])
               + ([pair_mask] if masked else []))
    if any(x.device != dev for x in tensors):
        raise ValueError("match_reduce: all inputs must be on one device")
    if desc_a.shape != (*lead, n, 8) or desc_b.shape != (*lead, m, 8) \
            or desc_a.dtype != torch.int32 or desc_b.dtype != torch.int32:
        raise ValueError("match_reduce: descriptors must be ([B,] N, 8) int32")
    if valid_a.shape != (*lead, n) or valid_b.shape != (*lead, m) \
            or valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise ValueError("match_reduce: valid masks must be ([B,] N) bool")
    if guided and (xy_a.shape != (*lead, n, 2) or proj_b.shape != (*lead, m, 2)
                   or xy_a.dtype != torch.float32 or proj_b.dtype != torch.float32):
        raise ValueError("match_reduce: xy_a/proj_b must be ([B,] N|M, 2) float32")
    if masked and (pair_mask.shape != (*lead, n, m) or pair_mask.dtype != torch.bool):
        raise ValueError("match_reduce: pair_mask must be ([B,] N, M) bool")
    # A sequence's columns start 16-byte aligned (valid bytes, projections):
    # more than one sequence pads M to a multiple of 16 with invalid
    # columns, which lose to every real one, as the kernel's own padding.
    mp = m if batch == 1 else -(-m // 16) * 16
    if mp != m:
        desc_b = F.pad(desc_b, (0, 0, 0, mp - m))
        valid_b = F.pad(valid_b, (0, mp - m), value=False)
        if guided:
            proj_b = F.pad(proj_b, (0, 0, 0, mp - m))
    desc_a, desc_b = _aligned(desc_a), _aligned(desc_b)
    valid_a, valid_b = valid_a.contiguous(), _aligned(valid_b)
    if guided:
        xy_a, proj_b = _aligned(xy_a), _aligned(proj_b)
    lib = cuda_build.load_library()
    mask_words = 2 * -(-mp // COL_TILE)
    mask = _pack_mask(lib, pair_mask, batch * n, m, mask_words) if masked else None
    slices, tps = grid_split(batch * row_tiles, col_tiles, *_occupancy(lib, dev, mode))
    out = torch.empty((3, *lead, n), dtype=torch.int32, device=dev)
    col_idx = torch.empty((*lead, mp), dtype=torch.int32, device=dev)
    row_part = torch.empty((batch, slices, n, 2), dtype=torch.int32, device=dev)
    counters, colcode = _scratch(dev, batch * (row_tiles + slices), batch * mp)
    with torch.cuda.device(dev):
        err = lib.tinyslam_match_reduce(
            desc_a.data_ptr(), valid_a.data_ptr(),
            xy_a.data_ptr() if guided else None,
            desc_b.data_ptr(), valid_b.data_ptr(),
            proj_b.data_ptr() if guided else None,
            mask.data_ptr() if masked else None, mask_words,
            batch, n, mp, mode, gate_radius2(radius_px), nshift, cbits, slices, tps,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), col_idx.data_ptr(),
            row_part.data_ptr(), colcode.data_ptr(), counters.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "tinyslam_match_reduce")
    LAUNCHES += 1
    return out[0], out[1], out[2], col_idx[..., :m]


def grid_split(row_tiles: int, col_tiles: int, sms: int, per_sm: int) -> tuple[int, int]:
    """(slices, tiles a slice) for the kernel's grid of row tiles (of all
    sequences) x column slices: the split whose busiest SM walks the fewest
    column tiles, with every CTA resident at once where any split allows
    it; ties go to shorter slices.  At 2048 x 8192 on 132 SMs holding 3
    CTAs each that is 16 slices of 8 tiles (2 CTAs an SM), not 22 of 6 (3
    on some SMs).  Where no split keeps every CTA resident (four sequences
    of 2048 x 8192 and more), the longest slices: a CTA pays for unpacking
    its rows and for its share of the merge whatever its slice, so the
    fewest CTAs win (``tools/k2_batch_splits.py``)."""
    options = []
    for tps in range(1, min(MAX_TPS, col_tiles) + 1):
        slices = -(-col_tiles // tps)
        per = -(-row_tiles * slices // sms)      # CTAs on the busiest SM
        options.append((per > per_sm, per * tps if per <= per_sm else -tps, tps, slices))
    _, _, tps, slices = min(options)
    return slices, tps


def _pack_mask(lib, pair_mask: torch.Tensor, rows: int, m: int, words: int) -> torch.Tensor:
    """The ([B,] N, M) bool mask as (rows, words) int32 words on its device,
    column c at bit c % 32 of word c // 32 (the rest clear): one launch."""
    pair_mask = pair_mask.contiguous()
    out = torch.empty((rows, words), dtype=torch.int32, device=pair_mask.device)
    with torch.cuda.device(pair_mask.device):
        err = lib.tinyslam_pack_mask(pair_mask.data_ptr(), rows, m, words, out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "tinyslam_pack_mask")
    return out


def _occupancy(lib, dev: torch.device, mode: int) -> tuple[int, int]:
    """(SMs, CTAs of the kernel resident on one SM at once), by mode: 0
    unguided, 1 guided, 2 masked."""
    key = (dev, mode)
    if key not in _OCCUPANCY:
        with torch.cuda.device(dev):
            per_sm = lib.tinyslam_match_ctas_per_sm(mode)
        if per_sm < 1:
            raise RuntimeError("match_reduce: the kernel does not fit on an SM")
        _OCCUPANCY[key] = torch.cuda.get_device_properties(dev).multi_processor_count, per_sm
    return _OCCUPANCY[key]


def _scratch(dev: torch.device, n_counters: int, m: int):
    """The kernel's merge counters and per-column codes on ``dev`` (one
    slice of each a sequence): set (0, INT_MAX) once when allocated, and
    every launch returns the entries it used to those values.  Launches on
    one device run in stream order (the port issues K2 on the current
    stream only), so one pair of buffers serves them all.  A buffer that a
    larger one replaces stays allocated for the process: a captured CUDA
    graph replays its launches with the addresses it was captured with, and
    freed memory would be handed to other tensors."""
    counters, colcode = _SCRATCH.get(dev, (None, None))
    if counters is None or counters.numel() < n_counters:
        _RETIRED.append(counters)
        counters = torch.zeros(max(n_counters, 1024), dtype=torch.int32, device=dev)
    if colcode is None or colcode.numel() < m:
        _RETIRED.append(colcode)
        colcode = torch.full((max(m, 8192),), _INT32_MAX, dtype=torch.int32, device=dev)
    _SCRATCH[dev] = counters, colcode
    return counters, colcode
