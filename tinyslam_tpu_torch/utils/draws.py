"""The random draws of the RANSAC estimators, as an object passed down.

The JAX package draws with ``jax.random`` from keys it derives from frame
numbers; the port takes its draws from a ``Sampler`` that the caller owns
(``DeviceVO`` makes one and hands it to the bootstrap and to
``track_step``).  Draws are made on the CPU from the sampler's own
``torch.Generator`` (never the global one), so the CPU and the card see
the same numbers for the same sequence of calls; for a CUDA target they
are drawn into pinned memory and copied without blocking, so drawing never
synchronizes with the device.

Each call names the reference's stream in ``key``: ``("two_view", seed,
"E" or "H")`` for the two-view estimate's samplers (the reference splits
``PRNGKey(seed)``, the bootstrap's seed being the frame number),
``("reloc", frame_idx)`` for the device tracker's relocalization
(``fold_in(PRNGKey(17), frame_idx)``, ``frame_idx`` a device tensor),
``("host_reloc", frame_idx)`` for ``VisualOdometry``'s (``PRNGKey(
frame_idx)``) and ``("loop", kf_id * 131 + old_id)`` for the loop probe's
PnP-RANSAC (``fold_in(PRNGKey(23), n)``).  This sampler ignores the key;
a test's sampler can use it to replay the JAX streams.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.geometry.ransac import sample_indices


class Sampler:
    """Uniform draws from a seeded CPU generator."""

    def __init__(self, seed: int = 0):
        self.generator = torch.Generator().manual_seed(seed)

    def uniform(self, shape, device, key=None) -> torch.Tensor:
        """float32 uniforms in [0, 1) of ``shape`` on ``device``."""
        dev = torch.device(device)
        u = torch.rand(shape, generator=self.generator, pin_memory=dev.type == "cuda")
        return u.to(dev, non_blocking=True)

    def choice(self, valid: torch.Tensor, shape, key=None) -> torch.Tensor:
        """Indices (long, ``shape``) drawn uniformly among the true entries
        of ``valid`` (N,), on its device (the reference draws them with
        ``jax.random.categorical`` over the valid entries)."""
        return sample_indices(self.uniform(shape, valid.device, key), valid)
