"""Image ops, FAST, compaction, BRIEF and Hamming matching, with the CUDA
kernels of the FAST stage (``fast_cuda``) and the matcher (``match_cuda``)."""

from tinyslam_tpu_torch.ops.fast import detect_streak_16  # noqa: F401
