"""Device ms a generation of the gap from the last mark of one generation
to the first of the next: the device waiting between graph replays, from
the walk's device marks (sqmc_tpu_torch/algo/walk.py block_report) over
the last block of the untraced window; the six pieces sum to the block's
device wall time a generation."""

from benchmark import inside


def read(run):
    return inside.piece_ms(run, "replay_gap")
