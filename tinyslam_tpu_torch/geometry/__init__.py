"""Pinhole camera, SE(3) and PnP."""
