"""Device ms a generation of the annihilation: the parents' diagonal move
and D add, the key sort, K1's scan, K5, the initiator rule and min_wt
rounding, from the walk's device marks (sqmc_tpu_torch/algo/walk.py
block_report) over the last block of the untraced window; the six pieces
sum to the block's device wall time a generation."""

from benchmark import inside


def read(run):
    return inside.piece_ms(run, "annihilate")
