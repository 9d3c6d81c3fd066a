"""Fused multi-field segmented scan: plain PyTorch version and the wrapper
around the hand CUDA kernel (csrc/segscan.cu).

Port of sqmc_tpu/ops/segscan.py and sqmc_tpu/ops/pscan.py: with
``start[i]`` True at each segment's first row, ``seg_scan(fields, ops,
start)[k][i]`` is the reduction ("sum", "min" or "max") of ``fields[k]``
over rows ``seg_start(i) .. i``; at rows where :func:`seg_ends` is True it
is the whole segment's reduction.  The walk's annihilation merge reads
every group's weight sum, initiator max, priority min, diagonal min and
C(T) max from one such scan.

:func:`seg_scan` dispatches on the device of ``start``: a CPU tensor takes
:func:`seg_scan_plain`; a CUDA tensor launches the kernel (built from the
source on first use into ``build/sqmc_tpu_torch/`` at the repository
root) or raises.  There is no fallback from the card to the plain path.
"""

from __future__ import annotations

import ctypes

import torch

from . import cudabuild

_OPS = ("sum", "min", "max")
_DTYPES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2,
           torch.float64: 3}
MAX_FIELDS = 8

launches = 0                         # kernel launches since reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


# ---------------------------------------------------------------------------
# Plain version (log-depth Hillis-Steele over the segmented monoid)
# ---------------------------------------------------------------------------

def _op_fn(op):
    return {"sum": torch.add, "min": torch.minimum,
            "max": torch.maximum}[op]


def seg_scan_plain(fields, ops, start):
    """Inclusive segmented scan by log2(N) Hillis-Steele sweeps of
    (f1,v1)(+)(f2,v2) = (f1|f2, f2 ? v2 : op(v1,v2)).  uint32 fields
    compute in int64 (sums wrap mod 2**32) since torch has no uint32
    arithmetic on the CPU."""
    n = start.shape[0]
    f = start.to(torch.bool).clone()
    vs, casts = [], []
    for v in fields:
        casts.append(v.dtype == torch.uint32)
        vs.append(v.to(torch.int64) if casts[-1] else v.clone())
    fns = [_op_fn(o) for o in ops]
    d = 1
    while d < n:
        new_vs = []
        for fn, v, c, o in zip(fns, vs, casts, ops):
            comb = fn(v[:-d], v[d:])
            if c and o == "sum":
                comb = comb & 0xFFFFFFFF
            nv = v.clone()
            nv[d:] = torch.where(f[d:], v[d:], comb)
            new_vs.append(nv)
        nf = f.clone()
        nf[d:] = f[d:] | f[:-d]
        f, vs = nf, new_vs
        d *= 2
    return [v.to(torch.uint32) if c else v for v, c in zip(vs, casts)]


def seg_ends(start: torch.Tensor) -> torch.Tensor:
    """End-row flags: end[i] = start[i+1]; the last row is always an end."""
    return torch.cat([start[1:], torch.ones(1, dtype=torch.bool,
                                            device=start.device)])


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_SOURCE = "segscan.cu"
_PREFIX = "sqmc_seg_scan"


def _bind(lib):
    fn = lib.sqmc_seg_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p, ctypes.c_void_p]
    lib.sqmc_seg_scan_scratch_bytes.restype = ctypes.c_longlong
    lib.sqmc_seg_scan_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int]


def build():
    """Compile csrc/segscan.cu (see ops/cudabuild.py); returns the path."""
    return cudabuild.build(_SOURCE)


def seg_scan_cuda(fields, ops, start):
    """Launch the kernel on CUDA tensors (checks everything it is handed)."""
    global launches
    fields, ops = list(fields), list(ops)
    n = start.shape[0]
    dev = start.device
    if start.dim() != 1 or start.dtype != torch.bool:
        raise ValueError("start must be a 1-D bool tensor")
    if not 1 <= len(fields) <= MAX_FIELDS or len(ops) != len(fields):
        raise ValueError(f"need 1..{MAX_FIELDS} fields, one op each")
    for v, o in zip(fields, ops):
        if o not in _OPS:
            raise ValueError(f"unknown op {o!r}")
        if v.dtype not in _DTYPES:
            raise ValueError(f"unsupported field dtype {v.dtype}")
        if v.device != dev or v.shape != (n,):
            raise ValueError("fields must be [N] tensors on start's device")
    start = cudabuild.aligned(start)
    fields = [cudabuild.aligned(v) for v in fields]
    outs = [torch.empty_like(v) for v in fields]
    if n == 0:
        return outs
    nf = len(fields)
    ptr_arr = ctypes.c_void_p * nf
    int_arr = ctypes.c_int * nf
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        # the look-back's tile status words, aggregates and inclusive prefixes
        scratch = torch.empty(lib.sqmc_seg_scan_scratch_bytes(n, nf),
                              dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sqmc_seg_scan(
            n, nf, start.data_ptr(),
            ptr_arr(*[v.data_ptr() for v in fields]),
            ptr_arr(*[o.data_ptr() for o in outs]),
            int_arr(*[_DTYPES[v.dtype] for v in fields]),
            int_arr(*[_OPS.index(o) for o in ops]),
            scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("seg_scan kernel launch failed: "
                           + cudabuild.error_string(lib, _PREFIX, err))
    launches += 1
    return outs


def seg_scan(fields, ops, start):
    """Inclusive segmented scan of several [N] fields in one pass.

    fields: sequence of int32 / uint32 / float32 / float64 tensors; ops:
    matching "sum" | "min" | "max"; start: [N] bool segment starts
    (start[0] must be True).  Returns the scanned fields (same dtypes).
    Float sums associate differently on the two paths, so they agree to
    rounding, not bit for bit."""
    if start.device.type == "cpu":
        return seg_scan_plain(fields, ops, start)
    if start.device.type != "cuda":
        raise ValueError(f"seg_scan has no path for device {start.device}")
    return seg_scan_cuda(fields, ops, start)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Plain inclusive prefix sum as the one-segment case."""
    start = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    return seg_scan([x], ["sum"], start)[0]


def cummax(x: torch.Tensor) -> torch.Tensor:
    start = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    return seg_scan([x], ["max"], start)[0]
