"""K3b's share of its bytes bound: the compulsory bytes of one launch
(yardstick hb_spawn_bytes: each drawn slot's parent words read and its
outputs written once, the tables once a launch) at the walk's spawn
total a generation over the HBM rate, divided by the mean device time of
the profiler's k_hb_spawn rows, in %."""

from benchmark import inside
from benchmark.yardstick import hb_spawn_bytes, peaks, trace


def read(run):
    t, drv = run.get("trace"), run.get("driver")
    if run.get("kind") != "walk" or not t or drv is None:
        return None
    us, calls = trace.kernel_rows(t, "k_hb_spawn")
    drawn = inside.last_counts(run, "n_spawn")
    if not calls or us <= 0 or drawn is None or drawn[1] == 0:
        return None
    cfg = drv.cfg
    slots = min(drawn[0] / drawn[1], cfg.cap_spawn)
    nbytes = hb_spawn_bytes.compulsory(slots, cfg.n_words, drv.tables,
                                       cfg.has_singles, cfg.f32_state)
    bound, _ = peaks.bound_us(nbytes)
    return 100.0 * bound / (us / calls)
