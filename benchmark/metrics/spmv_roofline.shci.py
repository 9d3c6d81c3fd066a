"""K2's share of its bound in the traced solve's Davidson: the bytes and
operations of its SpMV calls (yardstick kernel_bytes.spmv at float32,
from the rows, stored entries and vectors the "hci.davidson" spans
counted) against the HBM and peak rates, over the device time of the
solve's k_spmv profiler rows, in %.  None unless the profiler rows are
as many as the calls counted."""

from benchmark import inside
from benchmark.yardstick import kernel_bytes, peaks, trace


def read(run):
    t, spans = run.get("trace"), inside.solve_spans(run)
    if not t or spans is None:
        return None
    c = {k: inside.span_count(spans, "hci.davidson", "spmv_" + k)
         for k in ("calls", "rows", "nnz", "cols")}
    us, rows = trace.kernel_rows(t, "k_spmv")
    n = c["calls"]
    if not n or rows != n or us <= 0:
        return None
    # the call's bytes and operations are linear in its rows, entries and
    # rows x vectors: n calls at the mean shape give their sum when every
    # call multiplies the same number of vectors (Davidson on one state)
    nbytes, flops = kernel_bytes.spmv(c["rows"] / n, c["nnz"] / n, 4,
                                      c["cols"] / n)
    bound, _ = peaks.bound_us(nbytes * n, flops * n, "float32")
    return 100.0 * bound / us
