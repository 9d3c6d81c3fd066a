"""Host seconds of HCI's Davidson solves (span "hci.davidson", ended by
the host reading the eigenvectors) summed over the traced solve's
iterations."""

from benchmark import inside


def read(run):
    return inside.span_seconds(run, "hci.davidson")
