"""K1's share of its bytes bound: the bytes of one call (yardstick
kernel_bytes.seg_scan at the walk's merge rows and fields) over the HBM
rate, divided by the mean device time of its profiler rows, in %."""

from benchmark.yardstick import kernel_bytes, peaks, trace


def read(run):
    t, drv = run.get("trace"), run.get("driver")
    if run.get("kind") != "walk" or not t or drv is None \
            or not drv.cfg.full_sort_merge:
        return None
    us, calls = trace.kernel_rows(t, "k_seg_scan")
    if not calls or us <= 0:
        return None
    # the merge's one scan over the walkers and the spawn slots: u, init
    # (int32), weight, D weight, diagonal (state dtype), C(T) index (int32)
    es = 4 if drv.cfg.f32_state else 8
    rows = drv.cfg.mwalk + drv.cfg.cap_spawn
    bound, _ = peaks.bound_us(kernel_bytes.seg_scan(rows,
                                                    [4, 4, es, es, es, 4]))
    return 100.0 * bound / (us / calls)
