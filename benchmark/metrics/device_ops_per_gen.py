"""Device rows (kernels, copies, sets) a generation in the traced window."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "walk" or not t or not t["units"]:
        return None
    return t["device_ops"] / t["units"]
