"""Device time of the traced window's rows (kernels, copies, sets),
summed, in ms a generation."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "walk" or not t or not t["units"]:
        return None
    return t["device_us"] / 1e3 / t["units"]
