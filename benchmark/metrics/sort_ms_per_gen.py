"""Device ms a generation from the annihilation's start to the end of the
full-sort merge's key sort and its gathers: the parents' diagonal move
and D add, the merge's keys, one stable argsort a key word and the rows'
gathers, from the walk's device marks (sqmc_tpu_torch/algo/walk.py
block_report's sub_ns "sort") over the last block of the untraced
window.  Part of annihilate_ms_per_gen, which adds K1's scan, the
initiator rule and min_wt rounding; a program without the mark, or a
walk under the two-level merge, reports none."""

from benchmark import inside


def read(run):
    ns = ((inside.walk_report(run) or {}).get("sub_ns") or {}).get("sort")
    return None if ns is None else ns * 1e-6
