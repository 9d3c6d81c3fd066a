"""The port's one host tracer: phase timers printing the reference's
grep-able "BEG/END OF" lines (the port's own copy of
sqmc_tpu/utils/timers.py), and the named spans and counters they are
built on.

Mirrors my_second (ref: src/my_second.f90): every major phase is bracketed
and reports cpu/wall deltas, so the e2e diff tooling and log-parsing habits
from the reference carry over.

Spans and counters.  ``span(name, **counts)`` brackets a stretch of host
code and ``count(name, value)`` adds to a counter of the innermost open
span.  Each span is recorded in memory (:class:`Span`: name, start and
end on ``time.perf_counter_ns``, the span it was opened in, counts) and
also opens a profiler record function of its name (``_range``), so that
it sits in a profiler's trace, as a host op on the profiler's clock.
It is torch's fast record function, not ``torch.profiler.
record_function``: a user annotation gets a mirror range on the device's
timeline, which a trace reader would count as device work (busy time, a
device row) where the device may have been idle.  They record while a
torch.profiler session is active or after :func:`enable`; otherwise a
span is one boolean test and a shared null context, and records nothing.
A span's end is where the host left it: it bounds the device work
enqueued inside it only where the code synchronizes before it ends (each
call site says whether it does).  :func:`spans` reads the record,
:func:`clear` empties it.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch
from torch.autograd import profiler as _profiler

_t0_wall = time.time()
_t0_cpu = time.process_time()
_last_wall = _t0_wall
_last_cpu = _t0_cpu

_on = False                  # enable()
_record: list = []           # every span opened since clear(), in start order
_open: list = []             # the open spans, innermost last
_NULL = contextlib.nullcontext()
# a host-only range in a profiler's trace (torch.profiler.record_function
# where torch has no fast record function)
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 _profiler.record_function)


class Span:
    """One recorded span: ``start`` / ``end`` in perf_counter ns (``end``
    None while open), ``parent`` the Span it was opened in (None at the
    top), ``counts`` its counters."""

    __slots__ = ("name", "start", "end", "parent", "counts", "_fn")

    def __init__(self, name: str, counts: dict, profiler_range: bool = True):
        self.name, self.counts = name, counts
        self.start = self.end = self.parent = None
        self._fn = _range(name) if profiler_range else _NULL

    def within(self, other) -> bool:
        """Whether `other` is this span or one it was opened in."""
        s = self
        while s is not None and s is not other:
            s = s.parent
        return s is other

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def __enter__(self):
        self._fn.__enter__()
        self.parent = _open[-1] if _open else None
        _record.append(self)
        _open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        _open.pop()
        self._fn.__exit__(*exc)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start}, {self.end}, "
                f"parent={self.parent}, counts={self.counts})")


def enable(on: bool = True) -> None:
    """Record spans and counters with no profiler session active too."""
    global _on
    _on = bool(on)


def tracing() -> bool:
    """Whether spans and counters record now."""
    return _on or _profiler._is_profiler_enabled


def span(name: str, profiler_range: bool = True, **counts):
    """A context that records `name` (with counters `counts`) while
    tracing is on, and does nothing otherwise; it yields the Span, or
    None when off.  profiler_range=False records the span without a range
    in the profiler's trace: a span around CUDA graph replays has no op
    of its own between it and the replayed kernels, so the profiler makes
    it their parent, and reading the profiler's events then takes several
    times as long (see algo/walk.py walk_block)."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, dict(counts), profiler_range)


def count(name: str, value) -> None:
    """Add `value` to counter `name` of the innermost open span (dropped
    when tracing is off or no span is open)."""
    if (_on or _profiler._is_profiler_enabled) and _open:
        c = _open[-1].counts
        c[name] = c.get(name, 0) + value


def spans() -> list:
    """The recorded spans, in start order."""
    return list(_record)


def clear() -> None:
    """Forget the recorded spans."""
    _record.clear()


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
def phase(tag: str, out=sys.stdout, enabled: bool = True,
          name: str | None = None):
    """A span named `name` (default: `tag`) that also prints the
    reference's BEG/END OF `tag` lines when `enabled`."""
    if enabled:
        my_second("BEG", tag, out)
    try:
        with span(name or tag):
            yield
    finally:
        if enabled:
            my_second("END", tag, out)
