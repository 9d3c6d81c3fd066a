"""Host seconds of run_hci in the traced solve, ended by a synchronize."""


def read(run):
    return run.get("spans", {}).get("hci")
