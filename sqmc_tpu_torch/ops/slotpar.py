"""Slot -> parent expand of the walk's spawn slots: plain PyTorch version
and the wrapper around the hand CUDA kernel (csrc/slotpar.cu).

Port of the expand in sqmc_tpu/algo/walk.py:1444-1467.  Walker i owns the
spawn slots ``cum_child[i-1] .. cum_child[i] - 1`` (``cum_child`` the
inclusive prefix of its child counts); ``slot_parents(cum_child, cap)[s]``
is the walker that owns slot s, for the slots below the spawn total.  Every
slot gets a value in [0, M), the ones past the total and past ``cap``
included, exactly as the JAX package's scatter-max + cummax + clip gives
them.

:func:`slot_parents` dispatches on the device of ``cum_child``: a CPU
tensor takes :func:`slot_parents_plain`; a CUDA tensor launches the kernel
(built from the source on first use, ops/cudabuild.py) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cudabuild

_SOURCE = "slotpar.cu"
_PREFIX = "sqmc_slot_parents"

launches = 0                         # kernel launches since reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def slot_parents_plain(cum_child: torch.Tensor, cap: int) -> torch.Tensor:
    """Each walker's index scattered (max) at its first slot, clipped to
    the last slot, forward-filled by a running max (walkers are ascending;
    among walkers sharing an offset only the last one has children)."""
    M = cum_child.shape[0]
    dev = cum_child.device
    off_child = torch.cat([cum_child.new_zeros(1), cum_child[:-1]])
    seed_par = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    seed_par.scatter_reduce_(0, off_child.clamp(0, cap - 1),
                             torch.arange(M, dtype=torch.int64, device=dev),
                             reduce="amax")
    return torch.cummax(seed_par, 0).values.clamp(0, M - 1)


def _bind(lib):
    fn = lib.sqmc_slot_parents
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    shape = lib.sqmc_slot_parents_shape
    shape.restype = ctypes.c_int
    shape.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def build():
    """Compile csrc/slotpar.cu (see ops/cudabuild.py); returns the path."""
    return cudabuild.build(_SOURCE)


def launch_shape(m: int, cap: int, device) -> dict:
    """How the kernel launches for m walkers and cap slots on ``device``
    (a card): blocks, threads a block, static shared bytes a block,
    resident blocks per SM, and the merge items (walkers + slots) a block
    takes."""
    dev = torch.device(device)
    out = (ctypes.c_longlong * 5)()
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        err = lib.sqmc_slot_parents_shape(m, cap, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError("slot_parents launch shape: "
                           + cudabuild.error_string(lib, _PREFIX, err))
    return dict(zip(("blocks", "threads", "smem_bytes", "blocks_per_sm",
                     "tile_items"), list(out)))


def slot_parents_cuda(cum_child: torch.Tensor, cap: int) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor (checks what it is handed)."""
    global launches
    if cum_child.dim() != 1 or cum_child.dtype != torch.int64:
        raise ValueError("cum_child must be a 1-D int64 tensor")
    if cum_child.shape[0] < 1 or cap < 1:
        raise ValueError("need at least one walker and one slot")
    dev = cum_child.device
    cum_child = cum_child.contiguous()
    b = torch.empty(cap, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        err = lib.sqmc_slot_parents(
            cum_child.shape[0], cap, cum_child.data_ptr(), b.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("slot_parents kernel launch failed: "
                           + cudabuild.error_string(lib, _PREFIX, err))
    launches += 1
    return b


def slot_parents(cum_child: torch.Tensor, cap: int) -> torch.Tensor:
    """[cap] int64 parent walker of every spawn slot.

    cum_child: [M] int64 inclusive prefix sum of the walkers' child counts
    (nondecreasing, >= 0; the kernel's merge of walkers and slots relies on
    it).  Both paths give the same bits."""
    if cum_child.device.type == "cpu":
        return slot_parents_plain(cum_child, cap)
    if cum_child.device.type != "cuda":
        raise ValueError(f"slot_parents has no path for device "
                         f"{cum_child.device}")
    return slot_parents_cuda(cum_child, cap)
