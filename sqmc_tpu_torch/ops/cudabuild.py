"""Build and load the port's hand CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc into a plain-C shared library (no torch
headers: seconds, not minutes) under ``build/sqmc_tpu_torch/`` at the
repository root, keyed by a hash of the source and the flags, and bound
with ctypes.  Building happens at first use, on the machine with the
card; importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "sqmc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}                     # source name -> bound ctypes.CDLL


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "sqmc_tpu_torch/csrc on the machine with the card")
    return found


def library_path(source: str) -> Path:
    """Build output for the current text of csrc/<source>."""
    h = hashlib.sha256((CSRC / source).read_bytes()
                       + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsqmc_{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile csrc/<source> unless this text of it is already built."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp,
                               str(CSRC / source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):"
                               f"\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)     # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: str, bind) -> ctypes.CDLL:
    """The built library of csrc/<source>, once per process; ``bind(lib)``
    declares its functions' argtypes and restypes."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        bind(lib)
        _libs[source] = lib
    return lib
