"""Build a kernel source with ``nvcc`` into a shared library with a plain C
interface, for ``ctypes``.  Nothing here runs at import: a kernel is built
at its first launch (or by ``chip_smoke.py``'s build phase), into the
gitignored ``build/`` beside its source.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path

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
