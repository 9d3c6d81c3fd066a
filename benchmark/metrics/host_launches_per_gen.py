"""Host calls that put work on the card's queue (kernel and graph
launches, copies, sets) a generation, in the traced window."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "walk" or not t or not t["units"]:
        return None
    return t["host_launches"] / t["units"]
