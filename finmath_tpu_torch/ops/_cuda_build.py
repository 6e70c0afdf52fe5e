"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launchers
returning ``cudaError_t``), so it compiles with ``nvcc`` alone, in seconds,
without PyTorch's headers. The shared library lands in ``_build/`` next to
the package (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``), the flags (``NVCC_FLAGS`` and the
source's own ``flags``, such as ``-fmad=false``) and the preprocessor
defines that pick one instantiation of a source (``defines``): an edited
source or header, or other flags, build anew; an unchanged one is reused.
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


def _define_flags(defines) -> list:
    return [f"-D{name}={value}" for name, value in defines]


def _source_flags(defines, flags) -> list:
    return [*NVCC_FLAGS, *flags, *_define_flags(defines)]


def library_path(source: str, defines=(), flags=()) -> Path:
    """Where the library built from ``csrc/<source>`` with the
    ``(name, value)`` pairs ``defines`` and the extra nvcc ``flags`` lives:
    named by a hash of the source, of every header in ``csrc/`` (any of
    which it may include), of the flags and of the defines."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(_source_flags(defines, flags)).encode())
    tag = "".join(f"-{name[-1].lower()}{value}" for name, value in defines)
    return BUILD_DIR / f"{src.stem}{tag}-{digest.hexdigest()[:16]}.so"


def build(source: str, defines=(), flags=()) -> Path:
    """Compile ``csrc/<source>`` with ``defines`` and ``flags`` unless a
    library of this exact source exists; returns the library's path.
    Raises with nvcc's output on failure."""
    out = library_path(source, defines, flags)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *_source_flags(defines, flags), "-o", str(tmp),
         str(CSRC_DIR / source)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(source: str, defines=(), flags=()) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>`` with
    ``defines`` and ``flags``."""
    return ctypes.CDLL(str(build(source, defines, flags)))
