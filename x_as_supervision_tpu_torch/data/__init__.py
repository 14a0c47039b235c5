"""Data of the port: the synthetic multi-camera pose fixture."""
