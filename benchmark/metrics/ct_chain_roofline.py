"""The CT chain's share of its bytes bound: the compulsory bytes of one
generation's chain (yardstick ct_chain_bytes: each drawn slot's parent
words read and its outputs written once, kmap3 once) at the walk's mean
spawn total over the HBM rate, divided by the device time from the spawn
piece's start to the chain's end (block_report's sub_ns "propose", the
last block of the untraced window), in %.  That window also holds the
slot allocation (nchild, the cumsum, K4) and the parent gathers before
the chain.  None outside CT walks, or where the program writes no mark
at the chain's end."""

from benchmark import inside
from benchmark.yardstick import ct_chain_bytes, peaks


def read(run):
    drv = run.get("driver")
    cfg = getattr(drv, "cfg", None)
    if run.get("kind") != "walk" or cfg is None \
            or not getattr(cfg, "use_exponential_projector", False):
        return None
    ns = ((inside.walk_report(run) or {}).get("sub_ns") or {}).get("propose")
    drawn = inside.last_counts(run, "n_spawn")
    if not ns or ns <= 0 or drawn is None or drawn[1] == 0:
        return None
    slots = min(drawn[0] / drawn[1], cfg.cap_spawn)
    bound, _ = peaks.bound_us(ct_chain_bytes.compulsory(
        slots, cfg.n_words, drv.tables))
    return 100.0 * bound / (ns * 1e-3)
