"""Accepted spawns as a share of the spawn slots drawn, in %: 100 x the
sum of n_spawn_ok (slots that leave the spawn piece with a nonzero
weight) over the sum of n_spawn, over the cell's last block."""

from benchmark import inside


def read(run):
    ok, drawn = inside.last_counts(run, "n_spawn_ok"), \
        inside.last_counts(run, "n_spawn")
    if ok is None or drawn is None or drawn[0] <= 0:
        return None
    return 100.0 * ok[0] / drawn[0]
