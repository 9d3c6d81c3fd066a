"""Host seconds of the walk's trial build in set-up (HCI, Psi_T, C(T)
and the D-space H), ended by a synchronize."""


def read(run):
    return run.get("spans", {}).get("trial")
