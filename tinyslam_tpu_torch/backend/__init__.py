"""Windowed bundle adjustment: reprojection residuals and the
Schur-complement Levenberg-Marquardt solver."""

from tinyslam_tpu_torch.backend.ba import _bundle_adjust_core, bundle_adjust  # noqa: F401
from tinyslam_tpu_torch.backend.residuals import reprojection_residuals  # noqa: F401
