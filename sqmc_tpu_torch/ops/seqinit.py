"""The sequential initiator combine of the walk's merge: plain PyTorch
version and the wrapper around the hand CUDA kernel (csrc/seqinit.cu).

Port of sqmc_tpu/algo/walk.py:2090 ``sequential_initiator_scan``, the
reference's order-dependent pairwise initiator combine
(merge_original_with_spawned2 do_walk.f90:5897-5950): walk each merge
group in sort order carrying (running weight, initiator); a same-sign
pair takes the max initiator, an opposite-sign pair the initiator of the
sign-winning walker (exact cancellation -> 0), except that a permanent
initiator (code 3) is never demoted.  A measurement mode of the walk
(WalkConfig.initiator_rule "sequential").  Both paths skip the zero-weight
rows that start no group (:func:`active_rows`, :func:`zero_run`): the
serial chain runs over the active rows alone, in row order, so the bits
are those of the walk over every row.

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

launches = 0                         # kernel calls since reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def zero_run(acc_w, acc_i):
    """z: what a run of zero-weight rows that start no group does to the
    carry's initiator, whatever the run's length (the weight is left as it
    is): 0 after an exact cancellation, unless the initiator is permanent
    (3)."""
    return torch.where((acc_w == 0) & (acc_i != 3), 0, acc_i).to(torch.int32)


def active_rows(neq, s_wt):
    """(start, active): the group starts (row 0 always) and the ACTIVE rows,
    a group start or a row with a nonzero weight (-0.0 is zero).  Only the
    active rows enter the serial chain; every other row takes z of the
    carry of the last active row before it."""
    start = neq.clone()
    start[:1] = True
    return start, start | (s_wt != 0)


def sequential_initiator_plain(neq, s_wt, init_row, stats=None):
    """The rule over the ACTIVE rows (see :func:`active_rows`), iterated
    over the rank of an active row within its group: one count scan gives
    the ranks, and pass k combines the rank-k active row of every group
    that has one with the carry of the active row before it (z first where
    inactive rows lie between them), vectorized over the groups.  The
    number of passes is the longest group of active rows less one, read
    from the device once per call; no group is cut short.  Each inactive
    row then takes z of its last active row's carry.  A handful of small
    operations a pass: the CPU's path, and the kernel's reference.

    ``stats``, a dict if given, receives ``passes`` and ``active`` (the
    active row count)."""
    N = neq.shape[0]
    dev = neq.device
    if N == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    start, active = active_rows(neq, s_wt)
    idx = torch.nonzero(active).squeeze(1)       # active rows, in row order
    a_start = start[idx]
    gap = torch.zeros_like(a_start)
    gap[1:] = (idx[1:] - idx[:-1] > 1) & ~a_start[1:]
    w, ini = s_wt[idx], init_row[idx].to(torch.int32)
    ones = torch.ones(idx.shape[0], dtype=torch.int32, device=dev)
    rank = (segscan.seg_scan_plain([ones], ["sum"], a_start)[0]
            - 1).to(torch.int64)
    counts = torch.bincount(rank).tolist()        # rows per rank: one sync
    order = torch.argsort(rank, stable=True)      # rank-major, rows ascending
    acc_w, acc_i = w.clone(), ini.clone()
    off = counts[0]
    for cnt in counts[1:]:
        rows = order[off:off + cnt]
        off += cnt
        pw, pi = acc_w[rows - 1], acc_i[rows - 1]
        pi = torch.where(gap[rows], zero_run(pw, pi), pi)
        wr, ir = w[rows], ini[rows]
        a, r = pw.abs(), wr.abs()
        opp = torch.where(r > a, ir, torch.where(r == a, 0, pi))
        opp = torch.where(pi == 3, pi, opp)
        acc_i[rows] = torch.where(pw * wr > 0, torch.maximum(pi, ir),
                                  opp).to(torch.int32)
        acc_w[rows] = pw + wr
    if stats is not None:
        stats.update(passes=len(counts) - 1, active=int(idx.shape[0]))
    slot = torch.cumsum(active, 0) - 1            # last active row at or before
    return torch.where(active, acc_i[slot], zero_run(acc_w, acc_i)[slot])


def _bind(lib):
    fn = lib.sqmc_seq_init
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    sz = lib.sqmc_seq_init_scratch_bytes
    sz.restype = ctypes.c_longlong
    sz.argtypes = [ctypes.c_longlong, ctypes.c_int]


def build():
    """Compile csrc/seqinit.cu (see ops/cudabuild.py); returns the path."""
    return cudabuild.build(_SOURCE)


def sequential_initiator_cuda(neq, s_wt, init_row):
    """Launch the kernel on CUDA tensors (checks what it is handed).

    One call is a memset and three launches on the current stream (mark,
    compact and walk the short groups; one warp a long group; fill:
    csrc/seqinit.cu), with scratch sized from N and allocated here, and
    no count read by the host: it runs inside a captured graph.
    ``launches`` counts calls, one a call, so that the walk's launch
    counts (eager, and a graph's recorded launches times its replays)
    read one a generation."""
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
    neq, s_wt, init_row = (cudabuild.aligned(x) for x in (neq, s_wt, init_row))
    f64 = int(s_wt.dtype == torch.float64)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        scratch = torch.empty(lib.sqmc_seq_init_scratch_bytes(n, f64),
                              dtype=torch.uint8, device=dev)
        err = lib.sqmc_seq_init(
            n, f64, neq.data_ptr(), s_wt.data_ptr(), init_row.data_ptr(),
            out.data_ptr(), scratch.data_ptr(),
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
