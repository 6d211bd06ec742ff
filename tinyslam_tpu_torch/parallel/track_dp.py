"""Multi-sequence tracking under frame data parallelism (the counterpart of
stage 4 of ``__graft_entry__.py``'s ``dryrun_multichip``: a ``jax.vmap`` of
``track_chunk`` with the states and frames sharded on ``frame``).

Tracking within one sequence is sequential, so the parallelism is across
sequences: B independent camera streams, each its own ``VOState``, split
over the mesh's ``frame`` axis.  Each rank tracks its contiguous B/F
sequences as one batch (``models/vo_device.py:track_chunk_batch``: one K1
launch a step for all of them, one K2 launch a guided pass; on the card
one replay of its captured ``BatchGraph`` a step), and one
gather over the axis at the end of the chunk returns every sequence's
state and outputs to every rank, as ``frontend_dp`` returns its batch.
Ranks on the ``landmark`` axis replicate.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.config import SlamConfig
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.models.vo_device import VOState, _tree_map, track_chunk_batch
from tinyslam_tpu_torch.parallel.mesh import axis_gather, axis_size
from tinyslam_tpu_torch.utils.draws import Sampler


def track_chunk_dp(mesh, cam: PinholeCamera, cfg: SlamConfig, states: VOState, frames,
                   active, samplers: list[Sampler]) -> tuple[VOState, dict]:
    """``track_chunk_batch`` of B sequences with the sequences split over
    the mesh's ``frame`` axis.

    ``states`` is the batched state of all B sequences, ``frames`` (B, C,
    H, W) and ``active`` (B, C) on this rank's device, the same on every
    rank; ``samplers`` one a sequence (a rank draws only from its own
    sequences').  B must divide by the ``frame`` axis size.  Returns the
    global batched state and {"R", "t", "summary"} of all B sequences on
    every rank.
    """
    B = states.R.shape[0]
    n_frame = axis_size(mesh, "frame")
    if B % n_frame:
        raise ValueError(f"track_chunk_dp: {B} sequences do not divide by the frame "
                         f"axis ({n_frame})")
    per = B // n_frame
    f = mesh.get_local_rank("frame")
    mine = slice(f * per, (f + 1) * per)
    local, ys = track_chunk_batch(cam, cfg, _tree_map(lambda x: x[mine], states),
                                  frames[mine], torch.as_tensor(active)[mine],
                                  samplers[mine])
    gather = lambda x: axis_gather(x, mesh, "frame")  # noqa: E731
    return _tree_map(gather, local), {k: gather(v) for k, v in ys.items()}

