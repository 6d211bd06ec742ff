"""Datasets (TUM RGB-D, EuRoC), undistortion and the synthetic renderer (numpy)."""
