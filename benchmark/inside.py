"""What the program reports from inside, for the per-layer metrics: the
walk's report of its last block (device marks a piece, host enqueue
time, counters), the traffic generator's last block of per-generation
counters, and the spans of the last traced SHCI solve.

Every reader returns None, and never raises, on a program that lacks
what it reads (the benchmark also runs an older program with these
files), or in a cell of another kind.
"""

from __future__ import annotations


def walk_report(run):
    """sqmc_tpu_torch.algo.walk.block_report() for the last block run,
    or None."""
    if run.get("kind") != "walk":
        return None
    try:
        from sqmc_tpu_torch.algo import walk as W
        report = getattr(W, "block_report", None)
        return report() if report is not None else None
    except Exception:
        return None


def piece_ms(run, piece: str):
    """Mean device ms a generation of one piece of the last block."""
    rep = walk_report(run)
    ns = (rep or {}).get("piece_ns", {}).get(piece)
    return None if ns is None else ns * 1e-6


def last_counts(run, key: str):
    """(sum over the generations, generations) of a per-generation stat
    of the generator's last block, or None where the program has no such
    stat."""
    drv = run.get("driver")
    last = getattr(drv, "last", None)
    if run.get("kind") != "walk" or not isinstance(last, dict) \
            or key not in last:
        return None
    v = last[key]
    return float(v.sum()), int(v.numel())


def solve_spans(run):
    """The spans recorded inside the last finished "hci.run" (itself
    included), or None."""
    if run.get("kind") != "shci":
        return None
    try:
        from sqmc_tpu_torch.utils import timers
        spans = timers.spans()
        runs = [s for s in spans if s.name == "hci.run" and s.end is not None]
        if not runs:
            return None
        return [s for s in spans if s.end is not None and s.within(runs[-1])]
    except Exception:
        return None


def span_seconds(run, name: str):
    """Host seconds of the spans called `name` in the last solve."""
    spans = solve_spans(run)
    if spans is None:
        return None
    found = [s.seconds for s in spans if s.name == name]
    return sum(found) if found else None


def span_count(spans, name: str, key: str):
    """Counter `key` summed over the spans called `name`."""
    return sum(s.counts.get(key, 0) for s in spans if s.name == name)
