"""Device timestamps at the boundaries of a step's pieces: the plain
version and the wrapper around the one-thread CUDA kernel
(csrc/mark.cu).

A :class:`Marks` holds an int64 ``[rows, n]`` buffer and a device-side
row index ``slot`` (one int64 tensor).  ``marks(k)`` writes "now", in
ns, at ``buf[slot, k]``: on a CUDA buffer the kernel reads the device's
global clock once the work queued before it is done, so a mark captured
into a CUDA graph times the replay, with no host sync; on a CPU buffer
the plain version writes ``time.perf_counter_ns()``.  The caller advances
``slot`` once a step.  Nothing is copied to the host until
:meth:`Marks.read`.

No launch counter: a mark is instrumentation, not a kernel of the
computation, and the CLI's ``Kernel launches:`` line does not list it.
"""

from __future__ import annotations

import ctypes
import time

import torch

from . import cudabuild

_SOURCE = "mark.cu"
_PREFIX = "sqmc_mark"
MAX_MARKS = 8                       # the kernel's template instances


def _bind(lib):
    fn = lib.sqmc_mark_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def mark_plain(buf: torch.Tensor, slot: torch.Tensor, k: int) -> None:
    """buf[slot, k] = time.perf_counter_ns() (a slot past the rows writes
    nothing, as the kernel does)."""
    r = int(slot)
    if 0 <= r < buf.shape[0]:
        buf[r, k] = time.perf_counter_ns()


def mark_cuda(buf: torch.Tensor, slot: torch.Tensor, k: int) -> None:
    """Launch the mark kernel on the current stream of buf's device."""
    dev = buf.device
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        err = lib.sqmc_mark_launch(k, buf.data_ptr(), slot.data_ptr(),
                                   buf.shape[0], buf.shape[1],
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("mark kernel launch failed: "
                           + cudabuild.error_string(lib, _PREFIX, err))


def mark(buf: torch.Tensor, slot: torch.Tensor, k: int) -> None:
    """Write the time at buf[slot, k]: buf [rows, n] int64 contiguous,
    slot one int64 on buf's device, 0 <= k < n <= MAX_MARKS."""
    if (buf.dim() != 2 or buf.dtype != torch.int64
            or not buf.is_contiguous() or slot.dtype != torch.int64
            or slot.numel() != 1 or slot.device != buf.device):
        raise ValueError("mark takes a contiguous [rows, n] int64 buffer and "
                         "a one-element int64 slot on its device")
    if not 0 <= k < buf.shape[1] <= MAX_MARKS:
        raise ValueError(f"mark {k} of {buf.shape[1]} (at most {MAX_MARKS})")
    if buf.device.type == "cpu":
        mark_plain(buf, slot, k)
    elif buf.device.type == "cuda":
        mark_cuda(buf, slot, k)
    else:
        raise ValueError(f"mark has no path for device {buf.device}")


class Marks:
    """n marks a step over at most `rows` steps, at the device-side row
    `slot` (a new zero one unless given: a step graph shares its own)."""

    def __init__(self, n: int, rows: int, device, slot=None):
        self.n = int(n)
        self.buf = torch.zeros((int(rows), self.n), dtype=torch.int64,
                               device=device)
        self.slot = slot if slot is not None else torch.zeros(
            1, dtype=torch.int64, device=device)

    def __call__(self, k: int) -> None:
        mark(self.buf, self.slot, k)

    def last(self) -> None:
        """The step's last mark."""
        mark(self.buf, self.slot, self.n - 1)

    def read(self, steps: int):
        """The first `steps` rows on the host (int64 numpy; synchronizes)."""
        return self.buf[:steps].cpu().numpy()
