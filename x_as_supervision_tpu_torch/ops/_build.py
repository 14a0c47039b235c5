"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` builds it in seconds. It is compiled for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` under the repository root at first use;
the hash covers the source, every shared header ``csrc/*.cuh`` (the sources
include them through ``-I csrc``) and the flags, so an edited source or
header never loads a stale library. A failed build raises. ptxas reports
each kernel's registers and spills (``-Xptxas=-v``); the compiler's output of
each source built by this process is kept in ``compiler_output``. Nothing
here runs at import time.

Host C++ of the input pipeline, ``csrc/host/<name>.cpp`` (the geodesic
maps' fast marching), is built the same way with the host compiler and
native/Makefile's flags into ``build/host/<name>-<hash>.so``, the hash
also covering the CPU that ``-march=native`` compiles for
(``load_host``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

HOST_CSRC = CSRC / "host"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
# native/Makefile's CXXFLAGS and LDFLAGS
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp",
              "-Wall", "-shared")

_libs: dict[str, ctypes.CDLL] = {}
compiler_output: dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _library_path(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. Waits for every compiler it started, then raises
    on the first that failed."""
    jobs = []
    for name in names:
        src, lib = _library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        jobs.append((name, [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                            str(tmp), str(src)], tmp, lib))
    _compile(jobs)


def _compile(jobs, what: str = "kernel build") -> None:
    """Run every (name, command, temporary output, library) compile at
    once; each library appears atomically when its compiler succeeds.
    Raises after all have ended if any failed."""
    started = []
    for name, cmd, tmp, lib in jobs:
        lib.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((name, proc, cmd, tmp, lib))
    failures = []
    for name, proc, cmd, tmp, lib in started:
        out, _ = proc.communicate()
        compiler_output[name] = out
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)} -> {proc.returncode}\n{out}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError(f"{what} failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build(name)
            lib = ctypes.CDLL(str(_library_path(name)[1]))
            lib.xas_error_string.argtypes = [ctypes.c_int]
            lib.xas_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def _cxx() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) found: the input "
                       "pipeline's native code is built at first use")


def _cpu_features() -> bytes:
    """What -march=native compiles for: the CPU's model and flags
    (/proc/cpuinfo), or the machine's architecture where that is absent."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode()
    keys = (b"model name", b"flags")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keys)}))


def host_library_path(name: str) -> tuple[Path, Path]:
    """The source and the library of ``csrc/host/<name>.cpp``; the name
    hashes the source, the flags and the CPU (-march=native), so a build
    directory shared between machines never loads another CPU's code."""
    src = HOST_CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update(_cpu_features())
    return src, HOST_BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/host/<name>.cpp``, built with the host
    compiler on first use; a failed build raises."""
    key = f"host/{name}"
    with _lock:
        if key not in _libs:
            src, lib = host_library_path(name)
            if not lib.exists():
                tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
                _compile([(key, [_cxx(), *HOST_FLAGS, str(src), "-o",
                                 str(tmp)], tmp, lib)], "host library build")
            _libs[key] = ctypes.CDLL(str(lib))
        return _libs[key]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and synchronizing would not report it)."""
    if err != 0:
        msg = lib.xas_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def device_guard(t: torch.Tensor):
    """``torch.cuda.device(t.device)``, or nothing when that device is
    already current: entering the guard costs host time on every launch,
    which shows at small batch."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
