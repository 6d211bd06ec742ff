"""Device mesh and multi-process start-up on ``torch.distributed`` (mirrors
``tinyslam_tpu/parallel/mesh.py``).

Axis conventions (``MeshConfig``):
  frame    data parallelism over frames (``frontend_dp``);
  landmark landmark-block sharding for distributed BA and edge or node
           sharding of the pose graph (``dist_ba``, ``dist_pose_graph``).

JAX runs one program over the whole mesh; here every rank is a process
with one device, all ranks pass the same global arrays, and each computes
its own shard, picked by its coordinate on the axis.  ``lax.psum`` becomes
``axis_sum`` (a sum over the axis group that returns a new tensor, since
``dist.all_reduce`` works in place), ``lax.axis_index`` the rank's
coordinate, and ``lax.all_gather`` ``axis_gather``.  Nothing here creates
a process group at import.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from tinyslam_tpu_torch.config import MeshConfig

AXES = ("frame", "landmark")
# A collective that waits longer than this fails instead of hanging.
TIMEOUT = datetime.timedelta(seconds=60)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None) -> None:
    """Join the process group: ``coordinator`` is ``host:port`` of rank 0's
    rendezvous.  NCCL unless the caller asks for ``"gloo"`` (the CPU, or
    several ranks on one card).  No coordinator means a single process: a
    no-op, as in the JAX package."""
    if coordinator is None:
        return
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize_multihost: NCCL needs CUDA, which is not "
                           "available; pass backend='gloo' for the CPU")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def make_mesh(cfg: MeshConfig | None = None, device_type: str = "cuda"):
    """A (frame, landmark) ``DeviceMesh`` over the process group.  With no
    config every rank goes on the landmark axis (distributed BA is the
    communication-bound stage).  A layout that does not tile the world
    keeps ``fa = min(fa, n)``, ``la = n // fa``; ranks beyond ``fa * la`` are
    outside the mesh (their ``get_coordinate()`` is None).  Every rank of
    the world must call it: it creates the axis groups."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass "
                           "device_type='cpu' for the CPU")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "initialize_multihost first")
    n = dist.get_world_size()
    fa, la = (1, n) if cfg is None else (cfg.frame_axis, cfg.landmark_axis)
    if fa * la != n:
        fa = min(fa, n)
        la = n // fa
    if device_type == "cuda":
        # DeviceMesh's own choice, made before it warns that none was made.
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if fa * la == n:
        return init_device_mesh(device_type, (fa, la), mesh_dim_names=AXES)
    return DeviceMesh(device_type, torch.arange(fa * la).reshape(fa, la),
                      mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_sum(mesh, axis: str):
    """``lax.psum`` over ``axis``: x -> the sum of x over the axis group, as
    a new tensor (x is left as it was)."""
    group = mesh.get_group(axis)

    def psum(x: torch.Tensor) -> torch.Tensor:
        # A dense copy: NCCL refuses the strided views einsum can return.
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    return psum


def axis_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_gather`` over ``axis``, tiled: the ranks' x concatenated on
    dim 0 in the order of their coordinates (the group's rank order, since
    meshes are laid out over ascending ranks)."""
    group = mesh.get_group(axis)
    src = x.contiguous().view(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.view(torch.bool) if x.dtype == torch.bool else out
