"""Data of the port: the synthetic multi-camera pose fixture and the
epoch-shuffled, prefetching batch loader."""
