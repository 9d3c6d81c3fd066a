"""New dets filled a generation (the diagonal and C(T) index computed for
dets that no walker held), the per-generation counter n_fresh averaged
over the cell's last block."""

from benchmark import inside


def read(run):
    c = inside.last_counts(run, "n_fresh")
    return None if c is None or c[1] == 0 else c[0] / c[1]
