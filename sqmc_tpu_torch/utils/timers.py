"""Phase timers printing the reference's grep-able "END OF" lines (the
port's own copy of sqmc_tpu/utils/timers.py).

Mirrors my_second (ref: src/my_second.f90): every major phase is bracketed
and reports cpu/wall deltas, so the e2e diff tooling and log-parsing habits
from the reference carry over.
"""

from __future__ import annotations

import contextlib
import sys
import time

_t0_wall = time.time()
_t0_cpu = time.process_time()
_last_wall = _t0_wall
_last_cpu = _t0_cpu

# Optional in-memory phase ledger (tag -> accumulated wall seconds), used
# by the e2e timing tools to build phase tables without parsing stdout.
_ledger: dict | None = None


def start_ledger() -> None:
    """Begin (or reset) ledger accumulation for subsequent phase() blocks."""
    global _ledger
    _ledger = {}


def read_ledger() -> dict:
    """Snapshot of accumulated {tag: wall_seconds} since start_ledger()."""
    return dict(_ledger or {})


def _mem_avail_mb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def my_second(phase: str, tag: str, out=sys.stdout):
    """phase: 'BEG' or 'END'."""
    global _last_wall, _last_cpu
    now_w = time.time()
    now_c = time.process_time()
    dw = now_w - _last_wall
    dc = now_c - _last_cpu
    _last_wall, _last_cpu = now_w, now_c
    print(f"{phase} OF {tag} CP, REAL TIME {now_c - _t0_cpu:10.2f} {dc:10.2f} "
          f"{now_w - _t0_wall:8.0f} {dw:8.0f}, Mem avail {_mem_avail_mb():.2f}",
          file=out, flush=True)


@contextlib.contextmanager
def phase(tag: str, out=sys.stdout, enabled: bool = True):
    if enabled:
        my_second("BEG", tag, out)
    t0 = time.time()
    try:
        yield
    finally:
        if _ledger is not None:
            _ledger[tag] = _ledger.get(tag, 0.0) + (time.time() - t0)
        if enabled:
            my_second("END", tag, out)
