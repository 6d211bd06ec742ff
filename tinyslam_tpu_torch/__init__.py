"""tinyslam_tpu_torch — the tracker of tinyslam_tpu in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

Each module mirrors the JAX module of the same path in ``tinyslam_tpu/``,
which stays the reference; public functions keep its layouts ((H, W)
images, (N, 2) xy, (N, 8) packed descriptors).  This package imports
``torch`` and ``numpy`` and never JAX.

- ``ops``       image ops, FAST (plain + ``fast_cuda`` kernel), top-k,
                binned BRIEF, Hamming matching (plain + ``match_cuda``).
- ``frontend``  ``extract_features``, ``adapt_threshold``, ``OrbFrontend``.
- ``geometry``  pinhole camera, SE(3), Gauss-Newton PnP.
- ``models``    ``MapState``, ``VOState``, ``track_step``, ``track_chunk``,
                ``DeviceVO``.
- ``data``      the numpy room renderer and orbit trajectories.
"""

import torch as _torch

# Full float32 matmuls and convolutions on the card, as the JAX package
# pins float32 matmul precision (tinyslam_tpu/__init__.py): TF32 keeps ~10
# mantissa bits, which flips binned-BRIEF bits and moves the PnP poses away
# from the CPU reference.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from tinyslam_tpu_torch.config import (  # noqa: E402,F401
    BAConfig,
    FrontendConfig,
    MatcherConfig,
    RansacConfig,
    SlamConfig,
    VOConfig,
    slice_config,
)
from tinyslam_tpu_torch.types import Features  # noqa: E402,F401
