"""K2's share of its bound in a walk's D-space projection: bytes and
operations of one call (yardstick kernel_bytes.spmv at the projection's
rows, stored entries and precision) against the HBM rate and the peak
rate, divided by the mean device time of its profiler rows, in %."""

from benchmark.yardstick import kernel_bytes, peaks, trace


def read(run):
    t, drv = run.get("trace"), run.get("driver")
    if run.get("kind") != "walk" or not t or drv is None:
        return None
    cfg, tb = drv.cfg, drv.tables
    n = len(tb.imp_diag)
    if not (cfg.semistochastic and n and tb.imp_dense.numel() == 0):
        return None                     # no D space, or the dense path
    us, calls = trace.kernel_rows(t, "k_spmv")
    if not calls or us <= 0:
        return None
    es, dt = (4, "float32") if cfg.f32_state else (8, "float64")
    nbytes, flops = kernel_bytes.spmv(n, int(tb.imp_ell_nnz.sum()), es)
    bound, _ = peaks.bound_us(nbytes, flops, dt)
    return 100.0 * bound / (us / calls)
