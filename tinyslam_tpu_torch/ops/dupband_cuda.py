"""The keyframe triangulation's duplicate test and local depth band on
Hopper: the wrapper of ``csrc/dupband.cu``.

Not the port of a TPU kernel: the JAX package leaves this block of
``_triangulate_and_insert`` to XLA.  For N features against M map points
it gives, per feature: whether a map point with a similar descriptor
(Hamming <= 40) projects within ``dup_radius_px`` (a duplicate), how many
map points in view project within 40 px, and the median depth of those
(the local depth band).  The plain version ``dup_band_plain`` builds the
(N, M) matrices of distances and masks and sorts every row's depths; the
kernel streams the map once a block of rows and selects each row's median
from a short list, with an exact pass over the map for a row whose list
overflows.  Every output is an integer, a comparison or a median of
unchanged depths, so the two agree bit for bit.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``LAUNCHES`` counts kernel launches; ``overflow_rows(device)`` is
the card's count of rows that took the overflow pass (a 0-d int64 tensor,
read by the caller when it synchronizes anyway).
"""

from __future__ import annotations

import numpy as np
import torch

from tinyslam_tpu_torch.ops import cuda_build
from tinyslam_tpu_torch.ops.hamming import hamming_distance_matrix
from tinyslam_tpu_torch.ops.stats import nanmedian

LAUNCHES = 0
_OVERFLOW: dict = {}    # per device: the count of rows that took the overflow pass


def dup_band_plain(xy, desc, u_m, v_m, z_map, desc_m, valid, in_view,
                   dup_radius_px: float):
    """The block as (N, M) matrices.  Returns (dup (N,) bool: a similar
    descriptor projects near the feature; z_local (N,) float32: the median
    depth of the map points in view within 40 px, NaN where none; n_neigh
    (N,) int32: their number)."""
    nan = torch.full((), float("nan"), device=xy.device)
    d_map = hamming_distance_matrix(desc, desc_m)                   # (N, M)
    proj_m = torch.stack([u_m, v_m], dim=-1)
    pdist2 = ((xy[:, None, :] - proj_m[None, :, :]) ** 2).sum(-1)
    similar = (d_map <= 40) & valid[None, :]
    if dup_radius_px > 0:
        similar &= (pdist2 < dup_radius_px ** 2) & in_view[None, :]
    neigh = (pdist2 < 40.0 ** 2) & in_view[None, :]
    z_local = nanmedian(torch.where(neigh, z_map[None, :], nan), dim=1)
    return similar.any(dim=1), z_local, neigh.sum(1, dtype=torch.int32)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous storage on a 16-byte boundary: the kernel reads
    descriptor rows as 16-byte vectors and pixels as 8-byte pairs."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def list_cap() -> int:
    """The neighbour depths a row's list holds in the kernel (``CAP`` in
    ``csrc/dupband.cu``): a row with more takes the overflow pass."""
    return int(cuda_build.load_library().tinyslam_dupband_cap())


def overflow_rows(device) -> torch.Tensor:
    """The count on ``device`` of rows that took the kernel's overflow
    pass (a 0-d int64 tensor that every launch there adds to).  Made the
    first time the kernel runs on the device, outside a capture: a captured
    launch keeps its address."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _OVERFLOW:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("dup_band: first launch on a device inside a capture; "
                               "warm the step first")
        _OVERFLOW[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return _OVERFLOW[dev]


def dup_band(xy, desc, u_m, v_m, z_map, desc_m, valid, in_view, dup_radius_px: float):
    """``dup_band_plain``'s (dup, z_local, n_neigh) for N features (xy
    (N, 2) float32, desc (N, 8) int32) against M map points (u_m, v_m,
    z_map (M,) float32, desc_m (M, 8) int32, valid and in_view (M,) bool)."""
    if xy.device.type == "cpu":
        return dup_band_plain(xy, desc, u_m, v_m, z_map, desc_m, valid, in_view,
                              dup_radius_px)
    if xy.device.type != "cuda":
        raise ValueError(f"dup_band: unsupported device {xy.device}")
    global LAUNCHES
    n, m = xy.shape[0], u_m.shape[0]
    dev = xy.device
    tensors = (xy, desc, u_m, v_m, z_map, desc_m, valid, in_view)
    if any(x.device != dev for x in tensors):
        raise ValueError("dup_band: all inputs must be on one device")
    if xy.shape != (n, 2) or desc.shape != (n, 8) or xy.dtype != torch.float32 \
            or desc.dtype != torch.int32:
        raise ValueError("dup_band: xy must be (N, 2) float32 and desc (N, 8) int32")
    if any(x.shape != (m,) or x.dtype != torch.float32 for x in (u_m, v_m, z_map)) \
            or desc_m.shape != (m, 8) or desc_m.dtype != torch.int32 \
            or any(x.shape != (m,) or x.dtype != torch.bool for x in (valid, in_view)):
        raise ValueError("dup_band: the map must be (M,) float32 projections and depths, "
                         "(M, 8) int32 descriptors and (M,) bool masks")
    if not 1 <= n < 2**30 or m >= 2**30:
        raise ValueError(f"dup_band: unsupported shape N={n}, M={m}")
    dup = torch.empty(n, dtype=torch.bool, device=dev)
    z_local = torch.empty(n, dtype=torch.float32, device=dev)
    n_neigh = torch.empty(n, dtype=torch.int32, device=dev)
    overflow = overflow_rows(dev)
    xy, desc, desc_m = _aligned(xy), _aligned(desc), _aligned(desc_m)
    u_m, v_m, z_map = u_m.contiguous(), v_m.contiguous(), z_map.contiguous()
    valid, in_view = valid.contiguous(), in_view.contiguous()
    gate = dup_radius_px > 0
    r2 = float(np.float32(dup_radius_px ** 2)) if gate else 0.0
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        err = lib.tinyslam_dupband(
            xy.data_ptr(), desc.data_ptr(), u_m.data_ptr(), v_m.data_ptr(), z_map.data_ptr(),
            desc_m.data_ptr(), valid.data_ptr(), in_view.data_ptr(), n, m, int(gate), r2,
            dup.data_ptr(), z_local.data_ptr(), n_neigh.data_ptr(), overflow.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "tinyslam_dupband")
    LAUNCHES += 1
    return dup, z_local, n_neigh
