"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launchers
returning ``cudaError_t``), so it compiles with ``nvcc`` alone, in seconds,
without PyTorch's headers. The shared library lands in ``_build/`` next to
the package (listed in ``.gitignore``), named by a hash of the source and
the flags: an edited source builds anew, an unchanged one is reused.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of finmath_tpu_torch build on a machine with the CUDA "
        "toolkit")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of this exact source
    exists; returns the library's path. Raises with nvcc's output on
    failure."""
    out = library_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``."""
    return ctypes.CDLL(str(build(source)))
