"""The sequential initiator combine of the walk's merge: plain PyTorch
version and the wrapper around the hand CUDA kernel (csrc/seqinit.cu).

Port of sqmc_tpu/algo/walk.py:2090 ``sequential_initiator_scan``, the
reference's order-dependent pairwise initiator combine
(merge_original_with_spawned2 do_walk.f90:5897-5950): walk each merge
group in sort order carrying (running weight, initiator); a same-sign
pair takes the max initiator, an opposite-sign pair the initiator of the
sign-winning walker (exact cancellation -> 0), except that a permanent
initiator (code 3) is never demoted.  A measurement mode of the walk
(WalkConfig.initiator_rule "sequential").

:func:`sequential_initiator` dispatches on the device of ``neq``: a CPU
tensor takes :func:`sequential_initiator_plain`; a CUDA tensor launches
the kernel (built from the source on first use, ops/cudabuild.py) or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cudabuild, segscan

_SOURCE = "seqinit.cu"
_PREFIX = "sqmc_seq_init"

launches = 0                         # kernel launches since reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def sequential_initiator_plain(neq, s_wt, init_row):
    """The rule iterated over the RANK of a row within its group: one
    count scan gives every row's rank, and pass k combines the rank-k row
    of every group that has one with the running value of the row before
    it, vectorized over the groups.  The number of passes is the largest
    group size less one, read from the device once per call; no group is
    cut short, however long.  Each pass is a handful of small operations:
    the CPU's path, and the kernel's reference."""
    N = neq.shape[0]
    dev = neq.device
    ones = torch.ones(N, dtype=torch.int32, device=dev)
    rank = (segscan.seg_scan_plain([ones], ["sum"], neq)[0] - 1).to(torch.int64)
    counts = torch.bincount(rank).tolist()        # rows per rank: one sync
    order = torch.argsort(rank, stable=True)      # rank-major, rows ascending
    acc_w = s_wt.clone()
    acc_i = init_row.to(torch.int32).clone()
    off = counts[0]
    for cnt in counts[1:]:
        rows = order[off:off + cnt]
        off += cnt
        pw, pi = acc_w[rows - 1], acc_i[rows - 1]
        w, ini = s_wt[rows], init_row[rows].to(torch.int32)
        a, r = pw.abs(), w.abs()
        opp = torch.where(r > a, ini, torch.where(r == a, 0, pi))
        opp = torch.where(pi == 3, pi, opp)
        acc_i[rows] = torch.where(pw * w > 0, torch.maximum(pi, ini),
                                  opp).to(torch.int32)
        acc_w[rows] = pw + w
    return acc_i


def _bind(lib):
    fn = lib.sqmc_seq_init
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]


def build():
    """Compile csrc/seqinit.cu (see ops/cudabuild.py); returns the path."""
    return cudabuild.build(_SOURCE)


def sequential_initiator_cuda(neq, s_wt, init_row):
    """Launch the kernel on CUDA tensors (checks what it is handed)."""
    global launches
    n = neq.shape[0]
    if neq.dim() != 1 or neq.dtype != torch.bool or n < 1:
        raise ValueError("neq must be a non-empty 1-D bool tensor")
    if s_wt.shape != (n,) or s_wt.dtype not in (torch.float32, torch.float64):
        raise ValueError("s_wt must be a float32 or float64 tensor like neq")
    if init_row.shape != (n,) or init_row.dtype != torch.int32:
        raise ValueError("init_row must be an int32 tensor like neq")
    dev = neq.device
    if s_wt.device != dev or init_row.device != dev:
        raise ValueError("neq, s_wt and init_row must lie on one device")
    neq, s_wt, init_row = (x.contiguous() for x in (neq, s_wt, init_row))
    out = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        err = lib.sqmc_seq_init(
            n, int(s_wt.dtype == torch.float64), neq.data_ptr(),
            s_wt.data_ptr(), init_row.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("seq_init kernel launch failed: "
                           + cudabuild.error_string(lib, _PREFIX, err))
    launches += 1
    return out


def sequential_initiator(neq, s_wt, init_row):
    """[N] int32 running initiator of the sorted merge rows; a group's
    merged value stands at its END row.

    neq: [N] bool group-start flags (row 0 starts a group whatever neq[0]
    says); s_wt: [N] float32 / float64 signed row weights; init_row: [N]
    int32 row initiator flags.  Both paths give the same bits."""
    if neq.device.type == "cpu":
        return sequential_initiator_plain(neq, s_wt, init_row)
    if neq.device.type != "cuda":
        raise ValueError(f"sequential_initiator has no path for device "
                         f"{neq.device}")
    return sequential_initiator_cuda(neq, s_wt, init_row)
