"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), and loaded with ``ctypes``.  The library's file name carries
a hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LOGS: dict[str, str] = {}  # nvcc's output (ptxas' registers and spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, the headers
    beside it (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(b"".join(
        path.read_bytes() for path in [CSRC / f"{name}.cu",
                                       *sorted(CSRC.glob("*.cuh"))])
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library exists; the output
    goes to a temporary file that :func:`build` renames into place, so a
    concurrent or interrupted build never leaves a half-written library."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                             str(CSRC / f"{name}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, Path(tmp), target


def build(*names: str) -> list[Path]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together, and return the libraries' paths; each
    compiler's output is kept in ``LOGS``."""
    started = [(name, _start_build(name)) for name in names]
    errors = []
    for name, job in started:
        if job is None:
            continue
        proc, tmp, target = job
        out, _ = proc.communicate()
        LOGS[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(name) for name in names]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    (path,) = build(name)
    return ctypes.CDLL(str(path))
