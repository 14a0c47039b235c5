"""The port's kernel builder (x_as_supervision_tpu_torch/ops/_build.py)
without nvcc: the library name hashes the source, every shared header and
the flags, so an edited header never loads a stale library; the compiler is
given the source directory for its includes; a failed build raises."""

import os
import subprocess

import pytest

from x_as_supervision_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text(
        '#include "shared.cuh"\n__global__ void k() {}\n')
    (src / "shared.cuh").write_text("// v1\n")
    (src / "notes.md").write_text("a\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_path_follows_source_and_headers(csrc):
    first = _build._library_path("k")[1]
    assert first.parent == _build.BUILD_DIR and first.name.startswith("k-")
    assert _build._library_path("k")[1] == first  # deterministic
    # files the build does not read leave the name alone
    (csrc / "notes.md").write_text("b\n")
    (csrc / "other.cu").write_text("__global__ void o() {}\n")
    assert _build._library_path("k")[1] == first
    # an edited header, a new header, an edited source: a new library
    (csrc / "shared.cuh").write_text("// v2\n")
    second = _build._library_path("k")[1]
    assert second != first
    (csrc / "more.cuh").write_text("// new\n")
    third = _build._library_path("k")[1]
    assert third not in (first, second)
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build._library_path("k")[1] not in (first, second, third)


class _FakeNvcc:
    """subprocess.Popen stand-in: records the command and writes the -o
    file, or fails."""

    def __init__(self, returncode):
        self.returncode = returncode
        self.cmds = []

    def __call__(self, cmd, **kwargs):
        self.cmds.append(cmd)
        fake = self

        class Proc:
            returncode = fake.returncode

            def communicate(self):
                if fake.returncode == 0:
                    with open(cmd[cmd.index("-o") + 1], "wb") as f:
                        f.write(b"so")
                return "nvcc output", None

        return Proc()


def test_build_includes_the_source_directory(csrc, monkeypatch):
    fake = _FakeNvcc(0)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", fake)
    _build.build("k")
    (cmd,) = fake.cmds
    assert cmd[cmd.index("-I") + 1] == str(csrc)
    assert "arch=compute_90a,code=sm_90a" in cmd
    lib = _build._library_path("k")[1]
    assert lib.read_bytes() == b"so"
    assert os.listdir(lib.parent) == [lib.name]  # the temporary was renamed
    _build.build("k")  # built: no second compile
    assert len(fake.cmds) == 1


def test_failed_build_raises(csrc, monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc(1))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build("k")
    assert not _build._library_path("k")[1].exists()
