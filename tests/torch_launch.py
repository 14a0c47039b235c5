"""Shared helpers of the tests that start the port's CLIs as processes
(tests/test_torch_launchers.py, tests/test_torch_resumable.py)."""

from __future__ import annotations

import os
import socket


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def without_matplotlib(root) -> str:
    """A directory that, first on PYTHONPATH, makes matplotlib fail to
    import, as on the card's machine: the trainer then counts its figure
    panels as skipped instead of drawing them (seconds on this CPU)."""
    pkg = os.path.join(str(root), "matplotlib")
    os.makedirs(pkg, exist_ok=True)
    with open(os.path.join(pkg, "__init__.py"), "w") as f:
        f.write('raise ImportError("matplotlib is hidden in this test")\n')
    return str(root)


def cpu_env(stub_dir: str, **extra) -> dict:
    """This process's environment for a CLI on the CPU at one thread, with
    no XAS_ or JAX_ variable of its own and `stub_dir` first on
    PYTHONPATH."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XAS_", "JAX_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (stub_dir, env.get("PYTHONPATH")) if p), **extra)
    return env
