"""Frame data parallelism for the ORB front-end (mirrors
``tinyslam_tpu/parallel/frontend_dp.py``).

The front-end is embarrassingly parallel per frame: a batch of frames
splits over the mesh's ``frame`` axis, each rank extracts its contiguous
B/F frames with one K1 launch (``frontend/orb.py:extract_batch``), and one
gather over the axis returns the whole batch to every rank, as the JAX
package's ``out_specs`` would hand its caller the global array.  Ranks on
the ``landmark`` axis replicate.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.config import FrontendConfig
from tinyslam_tpu_torch.frontend.orb import extract_batch
from tinyslam_tpu_torch.parallel.mesh import axis_gather, axis_size
from tinyslam_tpu_torch.types import Features


def extract_features_batch(images: torch.Tensor, threshold, cfg: FrontendConfig,
                           mesh=None) -> Features:
    """Features of a batch of frames, with a leading B.

    images: (B, H, W) or (B, H, W, 3) on this rank's device, the same on
    every rank.  Without a mesh, the batched extraction on the images'
    device; with one, B must divide by the ``frame`` axis size.
    """
    if mesh is None:
        return extract_batch(images, threshold, cfg)
    n_frame = axis_size(mesh, "frame")
    if images.shape[0] % n_frame:
        raise ValueError(f"extract_features_batch: batch {images.shape[0]} does not "
                         f"divide by the frame axis ({n_frame})")
    per = images.shape[0] // n_frame
    f = mesh.get_local_rank("frame")
    local = extract_batch(images[f * per:(f + 1) * per], threshold, cfg)
    return local.map(lambda x: axis_gather(x, mesh, "frame"))
