"""Build a kernel source with ``nvcc`` into a shared library with a plain C
interface, for ``ctypes``.  Nothing here runs at import: a kernel is built
at its first launch (or by ``chip_smoke.py``'s build phase), into the
gitignored ``build/`` beside its source.  ``call_on`` and ``stream_ptr``
give a wrapper its launch context with little host work.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return str(path)


def build_library(src: Path, lib: Path, log: Path,
                  force: bool = False) -> float:
    """Compile ``src`` into ``lib`` unless an up-to-date library is there:
    one newer than every file in ``src``'s directory, the headers it
    includes too.  The compiler's output (ptxas register and shared-memory
    use per kernel) goes to ``log``.  Returns the build seconds."""
    newest = max(p.stat().st_mtime for p in src.parent.iterdir()
                 if p.is_file())
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def read_log(log: Path) -> str:
    return log.read_text() if log.exists() else ""


def call_on(device: torch.device, fn, *args):
    """``fn(*args)`` with ``device`` current: directly where it already is
    (a device guard would swap the device twice on every launch), else
    under ``torch.cuda.device``."""
    if device.index == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def stream_ptr(device: torch.device) -> int:
    """The ``cudaStream_t`` of ``device``'s current stream, which the
    kernels launch on; ``torch.cuda.current_stream(device).cuda_stream``
    builds a ``Stream`` object on every call to read the same pointer."""
    return torch._C._cuda_getCurrentRawStream(device.index)
