"""Assembled systems (mirrors ``tinyslam_tpu/models/__init__.py``).

- ``TwoViewEstimator``  matching and relative pose (the bootstrap).
- ``VisualOdometry``    the host-stepped tracker: keyframes, local BA,
                        relocalization; every decision reads the device.
- ``DeviceVO``          the chunked tracker: on the card a chunk is replays
                        of one captured CUDA graph with no sync in it.
- ``Slam`` / ``DeviceSlam``  VO and Sim(3) pose-graph loop closure over
                        the host / the chunked tracker.
"""

from tinyslam_tpu_torch.frontend.orb import OrbFrontend  # noqa: F401
from tinyslam_tpu_torch.models.slam import DeviceSlam, Slam  # noqa: F401
from tinyslam_tpu_torch.models.two_view import TwoViewEstimator  # noqa: F401
from tinyslam_tpu_torch.models.vo import MapState, VisualOdometry  # noqa: F401
from tinyslam_tpu_torch.models.vo_device import DeviceVO, VOState  # noqa: F401
