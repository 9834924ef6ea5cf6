"""Build the package's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a plain
C interface, ``build/lib<name>-<digest>.so`` inside the package (``build/`` is
git-ignored), which :mod:`surge_tpu_torch.replay.fold_kernels` loads with
``ctypes``. The digest covers the source, every shared header
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and an
unchanged one is reused. No PyTorch header is compiled, which
keeps a build to seconds.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default install; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a host "
                       "with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source, the
    shared headers it may include, and the flags)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Build the named kernels (default: every ``csrc/*.cu``) in parallel, one
    ``nvcc`` each, all started together. Returns ``{name: seconds}`` (0.0 for a
    library already built). Raises with the compiler's output on failure; the
    compiler's resource report (``-Xptxas -v``) is kept beside each library as
    ``.log``."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    times: dict[str, float] = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
    if failures:
        raise RuntimeError("\n".join(failures))
    return times


def library(name: str) -> Path:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    build_all([name])
    return library_path(name)
