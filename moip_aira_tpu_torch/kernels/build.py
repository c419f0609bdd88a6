"""Build the package's CUDA kernels from the repository's sources.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (it may
include the shared ``csrc/*.cuh`` headers), compiled by ``nvcc`` into a
shared library under ``<repo>/build/kernels/`` the first time it is needed,
and loaded with ``ctypes``.  The library's file name carries a hash of the
source, the headers and the flags, so an edited source builds anew.  A failed
build raises with nvcc's own error output; nothing falls back."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for its hash exists;
    ``defines`` are extra ``-D`` flags of an instrumented variant."""
    src = CSRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(defines)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *flags, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (when needed) and load ``csrc/<name>.cu``, once per process
    and set of ``defines``."""
    return ctypes.CDLL(str(build(name, tuple(defines))))
