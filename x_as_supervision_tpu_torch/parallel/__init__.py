"""Data parallelism: the process group and the rank's place in it (mesh.py)
and the collectives the data-parallel step calls (collectives.py)."""
