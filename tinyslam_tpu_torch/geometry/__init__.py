"""Pinhole camera, SE(3), PnP and PnP-RANSAC, two-view geometry."""
