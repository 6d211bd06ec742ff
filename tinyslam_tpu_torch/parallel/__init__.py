"""Decoupling the back-end from tracking: the latest-wins worker thread."""
