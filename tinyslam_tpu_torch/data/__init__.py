"""Synthetic scenes and trajectories (numpy)."""
