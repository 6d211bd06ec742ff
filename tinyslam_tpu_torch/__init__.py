"""tinyslam_tpu_torch — tinyslam_tpu in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100 (sm_90a).

Each module mirrors the JAX module of the same path in ``tinyslam_tpu/``,
which stays the reference; public functions keep its layouts ((H, W)
images, (N, 2) xy, (N, 8) packed descriptors).  This package imports
``torch`` and ``numpy`` and never JAX.

- ``ops``       image ops, FAST (plain + ``fast_cuda`` kernel), top-k,
                binned and continuous steered BRIEF, the C library's
                float trigonometry (``fmath``), Hamming matching (plain +
                ``match_cuda``).
- ``frontend``  ``extract_features``, ``adapt_threshold``, ``OrbFrontend``.
- ``geometry``  pinhole camera, SE(3), Sim(3), Gauss-Newton PnP and
                PnP-RANSAC, triangulation, the essential matrix (eight- and
                five-point), the homography, their LO-RANSAC and
                decompositions.
- ``backend``   BA residuals, the Schur-complement LM bundle adjustment,
                the SE(3) and Sim(3) pose graphs.
- ``models``    ``MapState``, ``VOState``, ``track_step`` (relocalization,
                keyframes and windowed BA included), ``track_chunk``,
                ``ChunkGraph`` (a chunk on the card as replays of one
                captured CUDA graph), ``DeviceVO`` (bootstrap and submap
                reboots),
                ``TwoViewEstimator``, ``VisualOdometry``, and ``Slam`` /
                ``DeviceSlam`` (Sim(3) loop closure).
- ``parallel``  the distributed layer on ``torch.distributed`` (the mesh,
                frame-parallel ORB, landmark-sharded BA, edge- and
                node-sharded pose graphs) and the latest-wins back-end
                worker thread.
- ``utils``     the RANSAC ``Sampler`` (keyed relocalization draws),
                ``device_cond`` and the graph capture (``cuda_graph``:
                ``lax.cond`` as conditional nodes), Umeyama alignment and ATE, the
                metrics registry, profiling (``trace``, ``named_scope``,
                ``dispatch_slope``), checkpoint and resume of every
                tracker (``.npz`` arrays, the JAX package's meta files),
                and fault handling (the back-end ``Watchdog``,
                ``SnapshotPolicy``, the device ``Heartbeat``).
- ``data``      TUM RGB-D and EuRoC sequences, radtan undistortion, the
                PNG writer, the numpy room renderer (clean or eval-grade:
                a distorted camera, photometrics, handheld and MAV
                trajectories) and the dataset writers.
- ``native``    the C++ PNG/PGM decoder and prefetching frame loader
                (``g++`` at first use, ``ctypes``).
- ``run``       the command line (``python -m tinyslam_tpu_torch.run``).
- ``eval_ate``  the accuracy eval on the rendered dataset-like sequences
                (``python -m tinyslam_tpu_torch.eval_ate``): ATE and RPE.
- ``entry``     the entry points (``entry``, ``dryrun_multichip``).
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
from tinyslam_tpu_torch.models import (  # noqa: E402,F401
    DeviceSlam,
    DeviceVO,
    Slam,
    VisualOdometry,
)
