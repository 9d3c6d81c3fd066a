"""Host seconds of HCI's sparse Hamiltonian builds (span "hci.ham", ended
by the copy of the diagonal to the host) summed over the traced solve's
iterations."""

from benchmark import inside


def read(run):
    return inside.span_seconds(run, "hci.ham")
