"""Distributed bundle adjustment: landmarks sharded over the mesh's
``landmark`` axis (mirrors ``tinyslam_tpu/parallel/dist_ba.py``).

The (L, K) observation grid splits on L.  Each rank builds the
normal-equation blocks of its landmark shard; the pose-side quantities (U,
gc, the Schur sum W V^-1 W^T and its right-hand side, the cost and the
counts) are summed over the axis at ``_bundle_adjust_core``'s ``preduce``;
the (6K x 6K) reduced camera solve runs on every rank alike, and the
landmark back-substitution stays local.  One LM iteration therefore sums
O(K^2) blocks, whatever the number of landmarks.  The shards of X are
gathered once, at the end, so every rank returns the whole result.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.backend.ba import _bundle_adjust_core
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.parallel.mesh import axis_gather, axis_size, axis_sum


def bundle_adjust_sharded(mesh, cam: PinholeCamera, R: torch.Tensor, t: torch.Tensor,
                          X: torch.Tensor, z: torch.Tensor, mask: torch.Tensor,
                          pose_free: torch.Tensor, point_valid: torch.Tensor | None = None,
                          max_iters: int = 10, huber: float = 5.0, lam0: float = 1e-3,
                          lam_up: float = 10.0, lam_down: float = 0.5) -> dict:
    """``backend.ba.bundle_adjust``'s contract and result (up to the order of
    the cross-shard sums), with the landmarks split over ``landmark``.

    R (K, 3, 3), t (K, 3), pose_free (K,) replicated; X (L, 3), z (L, K, 2),
    mask (L, K) and point_valid (L,) global, L divisible by the axis size.
    """
    if point_valid is not None:
        mask = mask & point_valid[:, None]
    n_shard = axis_size(mesh, "landmark")
    L = X.shape[0]
    if L % n_shard:
        raise ValueError(f"bundle_adjust_sharded: L={L} does not divide by the "
                         f"landmark axis ({n_shard})")
    per = L // n_shard
    r = mesh.get_local_rank("landmark")
    s = slice(r * per, (r + 1) * per)
    out = _bundle_adjust_core(cam, R, t, X[s], z[s], mask[s], pose_free, max_iters,
                              huber, lam0, lam_up, lam_down,
                              preduce=axis_sum(mesh, "landmark"))
    out["X"] = axis_gather(out["X"], mesh, "landmark")
    return out
