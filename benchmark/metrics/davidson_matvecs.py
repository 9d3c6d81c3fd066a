"""Vectors multiplied by H in the traced solve's Davidson iterations
(counter "matvecs" of the "hci.davidson" spans)."""

from benchmark import inside


def read(run):
    spans = inside.solve_spans(run)
    if spans is None or not any(s.name == "hci.davidson" for s in spans):
        return None
    return float(inside.span_count(spans, "hci.davidson", "matvecs"))
