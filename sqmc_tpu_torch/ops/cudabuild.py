"""Build and load the port's hand CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc into a plain-C shared library (no torch
headers: seconds, not minutes) under ``build/sqmc_tpu_torch/`` at the
repository root, keyed by a hash of the source and the flags, and bound
with ctypes.  What ptxas reports of each kernel (registers, shared
memory, spills: ``-Xptxas -v``) is kept beside the library
(:func:`ptxas_summary`).  Building happens at first use, on the machine
with the card; importing this module builds nothing.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}                     # source name -> bound ctypes.CDLL
_ready: set = set()                  # (source name, device index) set up


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
    """Compile csrc/<source> unless this text of it is already built;
    nvcc's report goes to the library's .log file."""
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
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)     # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def ptxas_summary(source: str) -> list:
    """One line per kernel of the built library of csrc/<source> (none
    before a build): its (demangled where c++filt is at hand) name,
    registers, shared memory and spill bytes, as ptxas reported them."""
    log = library_path(source).with_suffix(".log")
    lines, name = [], None
    for line in (log.read_text() if log.exists() else "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
        elif name and "Used" in line and "registers" in line:
            lines.append((name, line.split("info    :")[-1].strip()))
        elif name and "spill" in line:
            lines.append((name, line.split("info    :")[-1].strip()))
    names = sorted({n for n, _ in lines})
    pretty = dict(zip(names, names))
    filt = shutil.which("c++filt")
    if filt and names:
        proc = subprocess.run([filt], input="\n".join(names),
                              capture_output=True, text=True)
        if proc.returncode == 0:
            pretty = dict(zip(names, proc.stdout.splitlines()))
    out = {}
    for n, text in lines:
        out.setdefault(n, []).append(text)
    return [f"{pretty.get(n, n)}: " + "; ".join(t) for n, t in out.items()]


def aligned(t):
    """t contiguous at a 16-byte boundary, as the kernels' vector loads
    need it: a misaligned view is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def load(source: str, prefix: str, bind, device: int) -> ctypes.CDLL:
    """The built library of csrc/<source>, loaded once per process.

    ``bind(lib)`` declares its launch entries' argtypes and restypes; load
    binds ``<prefix>_error_string`` (the name of a CUDA error code) and
    runs ``<prefix>_init`` -- which sets the kernels' launch attributes on
    the current device -- once per device.  Call it with ``device``
    current."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        bind(lib)
        err_str = getattr(lib, f"{prefix}_error_string")
        err_str.restype = ctypes.c_char_p
        err_str.argtypes = [ctypes.c_int]
        init = getattr(lib, f"{prefix}_init")
        init.restype = ctypes.c_int
        init.argtypes = []
        _libs[source] = lib
    if (source, device) not in _ready:
        err = getattr(lib, f"{prefix}_init")()
        if err != 0:
            raise RuntimeError(f"{prefix}_init failed on device {device}: "
                               + error_string(lib, prefix, err))
        _ready.add((source, device))
    return lib


def error_string(lib, prefix: str, err: int) -> str:
    """The CUDA name of error code ``err`` from a loaded library."""
    return getattr(lib, f"{prefix}_error_string")(err).decode()
