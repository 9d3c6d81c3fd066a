"""The walk's log2-binned histogram of |spawn weight|: plain PyTorch
version and the wrapper around the hand CUDA kernel (csrc/spawnhist.cu).

Port of the one-hot sum in sqmc_tpu/algo/walk.py:2633-2644 (ref gen_hist,
more_tools.f90:5449): bin i covers |w| in [2^(i-20), 2^(i-19)), the first
and last bins take everything below and above; a slot counts where its
flag is set and |w| > 0.  The histogram is an output of the walk only
(``n_spawn_ok``, the block sums, the spawn statistics): nothing in the
walk reads it back.

:func:`spawn_histogram` dispatches on the device of the weights: a CPU
tensor takes :func:`spawn_histogram_plain`; a CUDA tensor launches the
kernel (built from the source on first use, ops/cudabuild.py) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cudabuild

N_HIST_BINS = 40
TINY = 1e-30                         # |w| floor before the log

_SOURCE = "spawnhist.cu"
_PREFIX = "sqmc_spawn_hist"

launches = 0                         # kernel launches since reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def spawn_histogram_plain(spawn_wt: torch.Tensor,
                          spawn_ok: torch.Tensor) -> torch.Tensor:
    """[N_HIST_BINS] int64 counts: each counted slot's bin scattered into
    one more bin that takes the rest, which is then dropped."""
    aw = spawn_wt.abs()
    hbin = (torch.floor(torch.log2(aw.clamp(min=TINY))) + 20.0).clamp(
        0, N_HIST_BINS - 1).to(torch.int64)
    hbin = torch.where(spawn_ok & (aw > 0), hbin, N_HIST_BINS)
    hist = torch.zeros(N_HIST_BINS + 1, dtype=torch.int64,
                       device=spawn_wt.device)
    hist.scatter_add_(0, hbin, torch.ones_like(hbin))
    return hist[:N_HIST_BINS]


def _bind(lib):
    fn = lib.sqmc_spawn_hist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    shape = lib.sqmc_spawn_hist_shape
    shape.restype = ctypes.c_int
    shape.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def build():
    """Compile csrc/spawnhist.cu (see ops/cudabuild.py); returns the path."""
    return cudabuild.build(_SOURCE)


def launch_shape(n: int, f64: bool, device) -> dict:
    """How the kernel launches for n slots on ``device`` (a card): blocks,
    threads a block, dynamic shared bytes a block, resident blocks per SM
    and the slots of one vector load."""
    dev = torch.device(device)
    out = (ctypes.c_longlong * 5)()
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        err = lib.sqmc_spawn_hist_shape(n, int(f64), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError("spawn_histogram launch shape: "
                           + cudabuild.error_string(lib, _PREFIX, err))
    return dict(zip(("blocks", "threads", "smem_bytes", "blocks_per_sm",
                     "vec_slots"), list(out)))


def spawn_histogram_cuda(spawn_wt: torch.Tensor,
                         spawn_ok: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (checks what it is handed)."""
    global launches
    if spawn_wt.dtype not in (torch.float32, torch.float64):
        raise ValueError("spawn_wt must be float32 or float64")
    if spawn_ok.dtype != torch.bool:
        raise ValueError("spawn_ok must be a bool tensor")
    if spawn_wt.dim() != 1 or spawn_ok.shape != spawn_wt.shape:
        raise ValueError("spawn_wt and spawn_ok must be 1-D of one length")
    if not 0 < spawn_wt.shape[0] < 2**31:
        raise ValueError("need between 1 and 2^31 - 1 slots")
    if spawn_ok.device != spawn_wt.device:
        raise ValueError("spawn_wt and spawn_ok lie on different devices")
    dev = spawn_wt.device
    wt, ok = cudabuild.aligned(spawn_wt), cudabuild.aligned(spawn_ok)
    hist = torch.zeros(N_HIST_BINS, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        err = lib.sqmc_spawn_hist(
            wt.shape[0], int(wt.dtype == torch.float64), wt.data_ptr(),
            ok.data_ptr(), hist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("spawn_histogram kernel launch failed: "
                           + cudabuild.error_string(lib, _PREFIX, err))
    launches += 1
    return hist


def spawn_histogram(spawn_wt: torch.Tensor,
                    spawn_ok: torch.Tensor) -> torch.Tensor:
    """[N_HIST_BINS] int64 counts of the spawn weights' log2 bins.

    spawn_wt: [N] float32 or float64; spawn_ok: [N] bool, the slots that
    count (with |w| > 0).  Both paths give the same counts."""
    if spawn_wt.device.type == "cpu":
        return spawn_histogram_plain(spawn_wt, spawn_ok)
    if spawn_wt.device.type != "cuda":
        raise ValueError(f"spawn_histogram has no path for device "
                         f"{spawn_wt.device}")
    return spawn_histogram_cuda(spawn_wt, spawn_ok)
