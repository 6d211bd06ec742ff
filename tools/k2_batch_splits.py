"""K2 over a batch of sequences at every column split, on the card.

    python tools/k2_batch_splits.py

For B = 1, 2, 4 and 8 sequences of 2048 features against 8192 map points,
guided at r=20 (random descriptors, features near their points'
projections), times ``match_cuda.match_reduce`` at column slices of 1, 2,
4, 6, 8, 12 and 16 tiles, each result checked exactly against
``match_reduce_plain``, and prints the split ``grid_split`` picks.  Device
time from queued launches between CUDA events (``chip_smoke._queued_ms``).
Also times the bf16 ``torch.bmm`` of the eight distance matrices, the
library yardstick (never called by the port).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from tinyslam_tpu_torch.ops import hamming, match_cuda  # noqa: E402
from tinyslam_tpu_torch.types import descriptor_signs  # noqa: E402


def _case(rng, B: int, dev, n: int = 2048, m: int = 8192) -> dict:
    db = rng.integers(0, 2**32 - 1, (B, m, 8), np.uint32)
    da = np.stack([d[rng.integers(0, m, n)] for d in db])
    da[..., 0] ^= rng.integers(0, 256, (B, n)).astype(np.uint32)
    proj = rng.uniform(0, 640, (B, m, 2)).astype(np.float32)
    src = rng.integers(0, m, (B, n))
    xy = np.take_along_axis(proj, src[..., None], 1) + rng.normal(0, 5, (B, n, 2))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(desc_a=T(da.view(np.int32)), valid_a=T(rng.random((B, n)) > 0.1),
                desc_b=T(db.view(np.int32)), valid_b=T(rng.random((B, m)) > 0.1),
                xy_a=T(xy.astype(np.float32)), proj_b=T(proj))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_batch_splits: needs the card")
    dev = torch.device("cuda")
    print(cs._smi())
    rng = np.random.default_rng(5)
    pick = match_cuda.grid_split
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B in (1, 2, 4, 8):
        case = _case(rng, B, dev)
        want = hamming.match_reduce_plain(**case, radius_px=20.0)
        rows = []
        try:
            for tps in (1, 2, 4, 6, 8, 12, 16):
                slices = -(-128 // tps)
                match_cuda.grid_split = lambda *a, s=slices, t=tps: (s, t)
                got = match_cuda.match_reduce(**case, radius_px=20.0)
                exact = all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want))
                us = 1e3 * cs._queued_ms(lambda: match_cuda.match_reduce(**case, radius_px=20.0))
                rows.append((tps, slices, round(us, 2), exact))
        finally:
            match_cuda.grid_split = pick
        per_sm = match_cuda._occupancy(match_cuda.cuda_build.load_library(), dev, 1)[1]
        print(f"B={B}: grid_split picks {pick(B * 16, 128, sms, per_sm)} (slices, tiles a "
              f"slice); (tiles a slice, slices, device us, exact): {rows}", flush=True)
        if not all(r[3] for r in rows):
            raise SystemExit("k2_batch_splits: a split is not exact")
    a16 = descriptor_signs(case["desc_a"]).to(torch.bfloat16)
    b16 = descriptor_signs(case["desc_b"]).to(torch.bfloat16)
    us = 1e3 * cs._queued_ms(lambda: a16 @ b16.transpose(-1, -2))
    print(f"bf16 torch.bmm of the {B} distance matrices: {us:.2f} device us")


if __name__ == "__main__":
    main()
