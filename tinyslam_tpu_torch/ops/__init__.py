"""Image ops, FAST, compaction, BRIEF and Hamming matching, with the CUDA
kernels of the FAST stage (``fast_cuda``) and the matcher (``match_cuda``)."""
