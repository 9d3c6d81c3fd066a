"""Share of an SHCI cell's traced window (one whole HCI + PT solve) in
which no device row ran, in %."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "shci" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
