"""``kernels/build.py``: when a kernel library is rebuilt.

A stand-in compiler (a shell script that writes the file named after
``-o`` and counts its runs) takes the place of ``nvcc``, so this runs on
a machine without the CUDA toolkit.  A library is rebuilt when any file
in its source's directory is newer than it, a header the source includes
as much as the source itself, or when the build is forced; otherwise the
library on disk is kept.
"""
from __future__ import annotations

import os
import stat

import pytest

from repro_torch.kernels import build


@pytest.fixture
def kernel_dir(tmp_path, monkeypatch):
    count = tmp_path / "runs.txt"
    fake = tmp_path / "fake_nvcc"
    fake.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = \"-o\" ]; then out=\"$2\"; fi\n"
                    "  shift\n"
                    "done\n"
                    f"echo run >> '{count}'\n"
                    "printf 'library' > \"$out\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kernel.cu").write_text('#include "helpers.cuh"\n')
    (csrc / "helpers.cuh").write_text("// device helpers\n")
    lib = tmp_path / "build" / "libkernel.so"

    def builds():
        return len(count.read_text().splitlines()) if count.exists() else 0

    def run(force=False):
        return build.build_library(csrc / "kernel.cu", lib,
                                   tmp_path / "build" / "nvcc.log", force)
    return csrc, lib, run, builds


def _age(csrc, lib, changed=None):
    """Sources 100 s old and the library 50 s old (up to date); then the
    changed file, if any, 20 s old: newer than the library, not than now."""
    now = lib.stat().st_mtime
    for path in csrc.iterdir():
        os.utime(path, (now - 100, now - 100))
    os.utime(lib, (now - 50, now - 50))
    if changed is not None:
        os.utime(csrc / changed, (now - 20, now - 20))


def test_builds_once_then_keeps_the_library(kernel_dir):
    _, lib, run, builds = kernel_dir
    run()
    assert builds() == 1 and lib.read_text() == "library"
    assert run() == 0.0 and builds() == 1


@pytest.mark.parametrize("changed", ["helpers.cuh", "kernel.cu"])
def test_a_newer_file_in_the_source_directory_rebuilds(kernel_dir, changed):
    csrc, lib, run, builds = kernel_dir
    run()
    _age(csrc, lib)
    assert run() == 0.0 and builds() == 1
    _age(csrc, lib, changed)
    run()
    assert builds() == 2
    assert run() == 0.0 and builds() == 2


def test_force_rebuilds_an_up_to_date_library(kernel_dir):
    _, _, run, builds = kernel_dir
    run()
    run(force=True)
    assert builds() == 2
