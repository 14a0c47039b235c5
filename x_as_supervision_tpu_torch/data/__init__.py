"""Data of the port: the Human3.6M and MPI-INF-3DHP datasets read from disk
(factory.py:basic_data), the synthetic multi-camera pose fixture, and the
epoch-shuffled, prefetching batch loader."""
