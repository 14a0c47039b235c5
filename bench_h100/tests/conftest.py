"""The benchmark's tests import its harness (``bench_h100/``) and the
program (the repository's root) as the command does."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(HERE), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)
