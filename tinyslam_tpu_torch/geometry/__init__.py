"""Pinhole camera, SE(3), PnP and two-view triangulation."""
