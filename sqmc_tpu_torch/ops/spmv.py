"""Sparse matrix times vector(s) over a row-pointer layout: the layout
functions, the plain PyTorch version and the wrapper around the hand CUDA
kernel (csrc/spmv.cu).

Port of sqmc_tpu/ops/spmv_pallas.py.  Row i of the matrix owns the slots
``[row_ptr[i], row_ptr[i+1])`` of flat ``cols`` (int32) / ``vals`` arrays,
of which the first ``row_nnz[i]`` hold its entries and the rest padding
(column 0, value 0):

  * ELL (:func:`ell_from_coo`): every row owns K consecutive slots,
    ``row_ptr[i] = i * K`` -- the layout of the TPU kernel
    ``_spmv_pallas``;
  * block-ELL (:func:`blockell_from_coo`): every row owns a whole number
    of 128-slot blocks, ``row_ptr[i]`` = its first block x 128 -- the
    layout the JAX package runs in production (Davidson under
    ``device_davidson``, the walk's D-space projection), with padding
    bounded by 127 slots per row instead of K_max - K_row.

:func:`spmv` computes ``y[i] = sum over row i's entries of vals * x[cols]``
for x of shape [n] or [n, m] (all m columns in one launch), reading only
the first ``row_nnz[i]`` slots of each row (the layout builders return the
counts).
A CPU tensor takes :func:`spmv_plain`; a CUDA tensor launches the kernel
(built from the source at first use, ops/cudabuild.py) or raises.
float32 inputs accumulate in float32, float64 inputs in float64.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import timers
from . import cudabuild

BLOCK_ROWS = 512            # the ELL row count rounds up to this (JAX's n_pad)
SLOTS = 128                 # block-ELL block width
_DTYPES = {torch.float32: 0, torch.float64: 1}
_SOURCE = "spmv.cu"
_PREFIX = "sqmc_spmv"

launches = 0                # kernel launches since reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


# ---------------------------------------------------------------------------
# Layouts (host, numpy)
# ---------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _symmetric_sorted(n, rows, cols, vals, diag):
    """Both orientations of the strictly-upper COO (+ the diagonal),
    stably sorted by row, as the JAX layout functions order them."""
    rows, cols, vals = _np(rows), _np(cols), _np(vals)
    r_all = np.concatenate([rows, cols])
    c_all = np.concatenate([cols, rows])
    v_all = np.concatenate([vals, vals])
    if diag is not None:
        r_all = np.concatenate([r_all, np.arange(n)])
        c_all = np.concatenate([c_all, np.arange(n)])
        v_all = np.concatenate([v_all, _np(diag)])
    order = np.argsort(r_all, kind="stable")
    r_all, c_all, v_all = r_all[order], c_all[order], v_all[order]
    counts = np.bincount(r_all, minlength=n)
    rank = np.arange(len(r_all)) - np.concatenate([[0], np.cumsum(counts)])[r_all]
    return r_all, c_all, v_all, counts, rank


def ell_from_coo(n: int, rows, cols, vals, diag=None, k_max: int | None = None):
    """Symmetric upper COO (+ diag) -> padded ELL.

    Returns (ell_cols [n_pad, K] int32, ell_vals [n_pad, K] float32, K,
    row_ptr [n + 1] int64, row_nnz [n] int32): the first three equal
    sqmc_tpu's ``ell_from_coo``; padding slots point at column 0 with value
    0, n_pad rounds n up to BLOCK_ROWS, rows longer than k_max are cut, and
    row_nnz counts each row's entries (at most K)."""
    r_all, c_all, v_all, counts, rank = _symmetric_sorted(n, rows, cols,
                                                          vals, diag)
    K = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    if k_max is not None:
        K = min(K, k_max)
    n_pad = -(-n // BLOCK_ROWS) * BLOCK_ROWS
    ell_cols = np.zeros((n_pad, K), np.int32)
    ell_vals = np.zeros((n_pad, K), np.float32)
    keep = rank < K
    ell_cols[r_all[keep], rank[keep]] = c_all[keep]
    ell_vals[r_all[keep], rank[keep]] = v_all[keep]
    row_ptr = np.arange(n + 1, dtype=np.int64) * K
    row_nnz = np.minimum(counts, K).astype(np.int32)
    return ell_cols, ell_vals, K, row_ptr, row_nnz


def _blockell_layout(n, r_all, c_all, v_all, counts, rank, dtype):
    nb_r = np.maximum(1, -(-counts // SLOTS))
    row_ptr = np.concatenate([[0], np.cumsum(nb_r)]).astype(np.int64) * SLOTS
    P = int(row_ptr[-1])
    ell_cols = np.zeros(P, np.int32)
    ell_vals = np.zeros(P, dtype)
    slot = row_ptr[:-1][r_all] + rank
    ell_cols[slot] = c_all
    ell_vals[slot] = v_all
    ell_row = np.repeat(np.arange(n, dtype=np.int32), nb_r)
    return ell_cols, ell_vals, ell_row, row_ptr, counts.astype(np.int32)


def blockell_from_coo(n: int, rows, cols, vals, diag=None, dtype=np.float32):
    """Symmetric upper COO (+ diag) -> 128-slot row-block layout.

    Returns (ell_cols [P] int32, ell_vals [P] dtype, ell_row [P/128] int32,
    row_ptr [n + 1] int64, row_nnz [n] int32): the first three equal
    sqmc_tpu's ``blockell_from_coo`` (float32 values by default); every row
    owns at least one block and holds row_nnz entries at its start."""
    return _blockell_layout(n, *_symmetric_sorted(n, rows, cols, vals, diag),
                            dtype)


def blockell_from_full_coo(n: int, rows, cols, vals, dtype=np.float32):
    """Row-complete COO of any (not necessarily symmetric) matrix -> the
    same 128-slot row-block layout and outputs as :func:`blockell_from_coo`.
    Every entry is stored once, explicit zeros included; entries keep
    their order within a row; a row without entries owns one empty block
    (row_nnz 0)."""
    rows, cols, vals = _np(rows), _np(cols), _np(vals)
    order = np.argsort(rows, kind="stable")
    r_all, c_all, v_all = rows[order], cols[order], vals[order]
    counts = np.bincount(r_all, minlength=n)
    rank = np.arange(len(r_all)) - np.concatenate([[0], np.cumsum(counts)])[r_all]
    return _blockell_layout(n, r_all, c_all, v_all, counts, rank, dtype)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def entry_slots(row_ptr, row_nnz):
    """Each entry's row and slot, in row order: row i's entries are the
    slots row_ptr[i] .. row_ptr[i] + row_nnz[i] - 1."""
    used = int(row_nnz.sum())
    rows = torch.arange(row_nnz.numel(), device=row_ptr.device)
    row_of = torch.repeat_interleave(rows, row_nnz, output_size=used)
    first = torch.cumsum(row_nnz, 0) - row_nnz          # row's first entry
    slot = row_ptr[row_of] + torch.arange(used, device=row_ptr.device) \
        - first[row_of]
    return row_of, slot


def spmv_plain(x, cols, vals, row_ptr, row_nnz):
    """Gather, multiply, sum per row (index_add_ over the slots' rows),
    over each row's first row_nnz[i] slots.
    x: [n_x] or [n_x, m]; returns [n_rows] or [n_rows, m] in x's dtype."""
    _check_types(x, cols, vals, row_ptr, row_nnz)
    n_rows = row_ptr.numel() - 1
    row_of, slot = entry_slots(row_ptr, row_nnz)
    cols = cols.reshape(-1)[slot].to(torch.int64)
    vals = vals.reshape(-1)[slot]
    xs = x[:, None] if x.dim() == 1 else x
    y = torch.zeros((n_rows, xs.shape[1]), dtype=x.dtype, device=x.device)
    y.index_add_(0, row_of, vals[:, None] * xs[cols])
    return y[:, 0] if x.dim() == 1 else y


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def _bind(lib):
    fn = lib.sqmc_spmv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 7


def build():
    """Compile csrc/spmv.cu (see ops/cudabuild.py); returns the path."""
    return cudabuild.build(_SOURCE)


def _check_types(x, cols, vals, row_ptr, row_nnz):
    if x.dim() not in (1, 2):
        raise ValueError("x must be [n] or [n, m]")
    if x.dtype not in _DTYPES or vals.dtype != x.dtype:
        raise ValueError(f"x and vals must share float32 or float64, got "
                         f"{x.dtype} and {vals.dtype}")
    if cols.dtype != torch.int32 or row_ptr.dtype != torch.int64:
        raise ValueError("cols must be int32 and row_ptr int64")
    if row_ptr.dim() != 1 or row_ptr.numel() < 1:
        raise ValueError("row_ptr must be [n_rows + 1]")
    if cols.numel() != vals.numel():
        raise ValueError("cols and vals must hold the same slots")
    if row_nnz.dtype != torch.int32 or row_nnz.shape != (row_ptr.numel() - 1,):
        raise ValueError("row_nnz must be [n_rows] int32")
    if any(t.device != x.device for t in (cols, vals, row_ptr, row_nnz)):
        raise ValueError("x, cols, vals, row_ptr and row_nnz must share a "
                         "device")


def spmv_cuda(x, cols, vals, row_ptr, row_nnz):
    """Launch the kernel on CUDA tensors (checks what it is handed; the
    column indices are in range by construction of the layouts)."""
    global launches
    _check_types(x, cols, vals, row_ptr, row_nnz)
    n_rows = row_ptr.numel() - 1
    xs = cudabuild.aligned(x[:, None] if x.dim() == 1 else x)
    m = xs.shape[1]
    y = torch.empty((n_rows, m), dtype=x.dtype, device=x.device)
    if n_rows > 0 and m > 0:
        cols, vals = cudabuild.aligned(cols), cudabuild.aligned(vals)
        row_ptr, row_nnz = row_ptr.contiguous(), row_nnz.contiguous()
        with torch.cuda.device(x.device):
            lib = cudabuild.load(_SOURCE, _PREFIX, _bind, x.device.index)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.sqmc_spmv(n_rows, m, _DTYPES[x.dtype], row_ptr.data_ptr(),
                                row_nnz.data_ptr(), cols.data_ptr(),
                                vals.data_ptr(), xs.data_ptr(), y.data_ptr(),
                                stream)
        if err != 0:
            raise RuntimeError("spmv kernel launch failed: "
                               + cudabuild.error_string(lib, _PREFIX, err))
        launches += 1
    return y[:, 0] if x.dim() == 1 else y


def spmv(x, cols, vals, row_ptr, row_nnz):
    """y = A x in a row-pointer layout; x [n_x] or [n_x, m] float32/float64,
    cols int32 and vals (x's dtype) flat slots, row_ptr [n_rows + 1] int64,
    row_nnz [n_rows] int32 entries per row.
    The two paths sum in different orders, so they agree to rounding."""
    if x.device.type == "cpu":
        return spmv_plain(x, cols, vals, row_ptr, row_nnz)
    if x.device.type != "cuda":
        raise ValueError(f"spmv has no path for device {x.device}")
    return spmv_cuda(x, cols, vals, row_ptr, row_nnz)


# ---------------------------------------------------------------------------
# Matvec objects with the JAX package's signatures
# ---------------------------------------------------------------------------

class _RowPtrSpmv:
    """y = H x for a SparseHam in one of the layouts, on H's device, in the
    layout's value type (float32 unless asked otherwise); x is [n] or
    [n, m] and y comes back in x's dtype.  Traced (utils/timers), each
    call counts spmv_calls, spmv_rows, spmv_nnz (stored entries read) and
    spmv_cols (m) on the open span, from host-side shapes."""

    def __call__(self, x):
        x = torch.as_tensor(x, device=self.cols.device)
        if timers.tracing():
            timers.count("spmv_calls", 1)
            timers.count("spmv_rows", self.n)
            timers.count("spmv_nnz", self.nnz)
            timers.count("spmv_cols", 1 if x.dim() == 1 else x.shape[1])
        y = spmv(x.to(self.vals.dtype), self.cols, self.vals, self.row_ptr,
                 self.row_nnz)
        return y.to(x.dtype)

    def _put(self, H, cols, vals, row_ptr, row_nnz):
        dev = H.vals.device
        self.n = H.n
        self.cols = torch.as_tensor(cols, device=dev)
        self.vals = torch.as_tensor(vals, device=dev)
        self.row_ptr = torch.as_tensor(row_ptr, device=dev)
        self.row_nnz = torch.as_tensor(row_nnz, device=dev)
        self.nnz = int(np.asarray(row_nnz).sum())


class EllSpmv(_RowPtrSpmv):
    """The ELL layout of sqmc_tpu's EllSpmv (the TPU kernel's layout)."""

    def __init__(self, H):
        cols, vals, K, row_ptr, row_nnz = ell_from_coo(H.n, H.rows, H.cols,
                                                       H.vals, H.diag)
        self.K = K
        self.n_pad = cols.shape[0]
        self._put(H, cols.reshape(-1), vals.reshape(-1), row_ptr, row_nnz)


class BlockEllSpmv(_RowPtrSpmv):
    """The 128-slot row-block layout of sqmc_tpu's BlockEllSpmv; dtype
    np.float64 keeps the values (and the sums) in float64."""

    def __init__(self, H, dtype=np.float32):
        cols, vals, _, row_ptr, row_nnz = blockell_from_coo(
            H.n, H.rows, H.cols, H.vals, H.diag, dtype=dtype)
        self._put(H, cols, vals, row_ptr, row_nnz)
