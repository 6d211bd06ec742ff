"""Order-fixed scatter-add on Hopper: the wrapper of ``csrc/scatter.cu``.

Not the port of a TPU kernel: the pose graph's normal equations are a
scatter-add of edge blocks into (nD, nD) slots, which the JAX package
writes as ``.at[].add`` and the port as ``index_add_``.  On the CPU
``index_add_`` adds in the listed order; on CUDA it adds by atomics, in an
order, and so with a rounding, that changes from run to run.  The kernel
sums each slot's contributions in their listed order instead, so the card
gives the CPU's result bit for bit, every run.

``scatter_plan(at, size)`` fixes the slots once (a stable sort of ``at``
and each slot's segment in it, on CUDA); ``ordered_scatter_add(plan,
vals)`` then returns the (size,) sums of ``vals`` at ``at``.  CPU tensors
take ``index_add_`` (the plain version); CUDA tensors launch the kernel or
raise.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tinyslam_tpu_torch.ops import cuda_build

LAUNCHES = 0
_INT32_MAX = 2**31 - 1


class ScatterPlan(NamedTuple):
    """The slots ``at`` (K,) int64 of K contributions into a (size,) output;
    on CUDA also ``perm`` (K,) int32, a stable sort of ``at``, and ``ptr``
    (size + 1,) int32, slot s's contributions at perm[ptr[s]:ptr[s + 1]]."""

    at: torch.Tensor
    size: int
    perm: torch.Tensor | None = None
    ptr: torch.Tensor | None = None


def segments(at: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, ptr) int32 of ``ScatterPlan``: the contributions grouped by
    slot, in their listed order within a slot."""
    if at.numel() > _INT32_MAX or size + 1 > _INT32_MAX:
        raise ValueError(f"scatter_plan: {at.numel()} contributions into {size} slots "
                         f"do not fit int32 offsets")
    sorted_at, perm = torch.sort(at.reshape(-1), stable=True)
    ptr = torch.searchsorted(sorted_at, torch.arange(size + 1, device=at.device))
    return perm.to(torch.int32), ptr.to(torch.int32)


def scatter_plan(at: torch.Tensor, size: int) -> ScatterPlan:
    """The plan of a scatter-add at the flat slots ``at`` into ``size``
    slots; the sort runs only where the kernel will (CUDA)."""
    at = at.reshape(-1).long()
    if at.device.type == "cuda":
        return ScatterPlan(at, size, *segments(at, size))
    return ScatterPlan(at, size)


def ordered_scatter_add(plan: ScatterPlan, vals: torch.Tensor) -> torch.Tensor:
    """(size,) zeros + ``vals`` (K,) added at ``plan.at``, each slot in the
    listed order: ``index_add_`` on the CPU, the kernel on CUDA."""
    global LAUNCHES
    vals = vals.reshape(-1)
    if vals.device.type == "cpu":
        return vals.new_zeros(plan.size).index_add_(0, plan.at, vals)
    if vals.device.type != "cuda":
        raise ValueError(f"ordered_scatter_add: unsupported device {vals.device}")
    if plan.perm is None or plan.perm.device != vals.device:
        raise ValueError("ordered_scatter_add: the plan was not built on this device")
    if vals.dtype not in (torch.float32, torch.float64) or vals.numel() != plan.at.numel():
        raise ValueError(f"ordered_scatter_add: vals must be {plan.at.numel()} float32 or "
                         f"float64 values, got {vals.numel()} {vals.dtype}")
    vals = vals.contiguous()
    out = torch.empty(plan.size, dtype=vals.dtype, device=vals.device)
    lib = cuda_build.load_library()
    with torch.cuda.device(vals.device):
        err = lib.tinyslam_ordered_scatter(
            vals.data_ptr(), plan.perm.data_ptr(), plan.ptr.data_ptr(), out.data_ptr(),
            plan.size, int(vals.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "tinyslam_ordered_scatter")
    LAUNCHES += 1
    return out


def ordered_scatter_segments(at: torch.Tensor, size: int, vals: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device: slot s adds its
    segment of the sorted contributions from 0, one position at a time.
    For tests of the segments against ``index_add_``."""
    perm, ptr = segments(at.reshape(-1).long(), size)
    perm, ptr = perm.long(), ptr.long()
    vals = vals.reshape(-1)
    out = vals.new_zeros(size)
    start, count = ptr[:-1], ptr[1:] - ptr[:-1]
    for k in range(int(count.max()) if size else 0):
        live = count > k
        out[live] = out[live] + vals[perm[start[live] + k]]
    return out
