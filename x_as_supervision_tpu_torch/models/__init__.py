"""Detector networks of the port."""
