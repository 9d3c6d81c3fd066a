"""Reduce one torch.profiler window to the numbers the per-layer metrics
read.

Device rows are the profiler's CUDA events (kernels, copies, sets; not
the device range the profiler gives the window's own annotation); the
busy time is the union of their intervals, so overlapping rows count
once; the window is the host's wall time of the traced work, which ends
in a synchronize.  Host launches are the host calls that put work on the
card's queue.  Idle gaps are the spaces between busy intervals inside
the window, each named by the innermost host event that covers its
middle.
"""

from __future__ import annotations

HOST_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
WINDOW = "benchmark.window"
TOP = 10


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, window_s: float, units: int) -> dict:
    """events: the profiler's FunctionEvents; window_s: the traced
    window's wall seconds; units: the generations (or solves) in it."""
    from torch.autograd import DeviceType
    rows, dev, host, launches = {}, [], [], 0
    win = None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name == WINDOW:        # the annotation's own device range
                continue
            us, k = rows.get(e.name, (0.0, 0))
            rows[e.name] = (us + (b - a), k + 1)
            dev.append((a, b))
        else:
            if e.name == WINDOW:
                win = (a, b)
                continue
            if e.name.startswith(HOST_LAUNCHES):
                launches += 1
            host.append((a, b, e.name))
    busy = _merge(dev)
    if win is not None:
        busy = [[max(a, win[0]), min(b, win[1])] for a, b in busy
                if b > win[0] and a < win[1]]
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    if busy:
        lo = win[0] if win else busy[0][0]
        hi = win[1] if win else busy[-1][1]
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        gaps = gaps[:TOP]
    named = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        cover = [(hb - ha, n) for ha, hb, n in host if ha <= mid <= hb]
        named.append([min(cover)[1] if cover else "host, between ops",
                      length * 1e-6])
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "units": units, "window_s": window_s, "busy_s": busy_us * 1e-6,
        "device_us": sum(us for us, _ in rows.values()),
        "device_ops": sum(k for _, k in rows.values()),
        "host_launches": launches, "rows": rows,
        "breakdown": {"device_ops": [[n, us * 1e-6] for n, (us, _) in top],
                      "idle_gaps": named},
    }


def kernel_rows(summary: dict, tag: str):
    """(total us, calls) of the device rows whose name holds `tag`."""
    found = [v for n, v in summary["rows"].items() if tag in n]
    return sum(us for us, _ in found), sum(k for _, k in found)
