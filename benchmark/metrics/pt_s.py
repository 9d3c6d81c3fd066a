"""Host seconds of the deterministic PT in the traced solve, ended by a
synchronize."""


def read(run):
    return run.get("spans", {}).get("pt")
