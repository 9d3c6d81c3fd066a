"""Host seconds of HCI's candidate selection (span "hci.select", the
connections of the references) summed over the traced solve's
iterations."""

from benchmark import inside


def read(run):
    return inside.span_seconds(run, "hci.select")
