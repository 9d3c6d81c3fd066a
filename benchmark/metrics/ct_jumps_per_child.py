"""The CT chain's jumps a child: the sum of n_ct_jumps (jumps taken over
all chains of a generation) over the sum of n_spawn_ok (slots that leave
the spawn piece with a nonzero weight), over the cell's last block.  A
program without the counter reads None."""

from benchmark import inside


def read(run):
    jumps, ok = inside.last_counts(run, "n_ct_jumps"), \
        inside.last_counts(run, "n_spawn_ok")
    if jumps is None or ok is None or ok[0] <= 0:
        return None
    return jumps[0] / ok[0]
