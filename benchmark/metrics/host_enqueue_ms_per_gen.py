"""Host ms a generation spent enqueueing the last block's graph replays
(the walk's step graph reads the host clock before and after them, no
sync), over the last block of the untraced window."""

from benchmark import inside


def read(run):
    rep = inside.walk_report(run)
    return None if rep is None else rep.get("host_enqueue_ms_per_gen")
