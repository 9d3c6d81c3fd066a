"""Share of a walk's traced window in which no device row ran: 1 - (union
of the device rows' intervals) / (the window's wall time), in %."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "walk" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
