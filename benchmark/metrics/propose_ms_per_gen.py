"""Device ms a generation from the spawn piece's start to the end of the
heat-bath proposal (K3b on the card): the slot allocation, K4, the parent
gathers and K3b, from the walk's device marks
(sqmc_tpu_torch/algo/walk.py block_report's sub_ns) over the last block of
the untraced window.  Part of spawn_ms_per_gen, which adds the rows after
the proposal; a walk without K3b has no such mark."""

from benchmark import inside


def read(run):
    ns = ((inside.walk_report(run) or {}).get("sub_ns") or {}).get("propose")
    return None if ns is None else ns * 1e-6
