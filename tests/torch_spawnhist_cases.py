"""Inputs of the spawn-histogram tests (sqmc_tpu_torch/ops/spawnhist.py),
shared by the CPU tests and the card tests; numpy only.

``boundary_weights`` holds the values where a bin can go wrong: 0 and
-0.0, TINY and its neighbours, subnormals, each power of two from 2^-21 to
2^20 with the values one ulp either side, values past both clamp edges,
inf and NaN, each value with both signs, and every row once more with its
flag off.  ``discard_heavy`` is the walk's finalize at heg54.walk's shape:
most slots undrawn or rejected (zero weight, flag off), the drawn ones
spread over the bins.  ``numpy_bins`` is the bin rule in numpy."""

import numpy as np

N_HIST_BINS = 40
TINY = 1e-30


def boundary_weights(dt):
    """(weights, flags) of dtype dt (float32 or float64) and bool."""
    dt = np.dtype(dt).type
    zero, inf = dt(0), dt(np.inf)
    fi = np.finfo(dt)
    tiny = dt(TINY)
    vals = [zero, tiny, np.nextafter(tiny, zero), np.nextafter(tiny, inf),
            fi.smallest_subnormal, fi.smallest_subnormal * dt(1000),
            np.nextafter(fi.smallest_normal, zero), fi.smallest_normal,
            dt(2.0 ** -30), dt(1e-10), dt(2.0 ** 25), dt(1e30), fi.max,
            inf, dt(np.nan)]
    for k in range(-21, 21):
        p = dt(2.0) ** k
        vals += [np.nextafter(p, zero), p, np.nextafter(p, inf)]
    v = np.array(vals, dt)
    wt = np.concatenate([v, -v, v, -v])
    ok = np.concatenate([np.ones(2 * len(v), bool),
                         np.zeros(2 * len(v), bool)])
    return wt, ok


def discard_heavy(rng, n, dt, drawn=0.372, accept=0.17):
    """n slots as the finalize sees them at heg54.walk: the first
    `drawn` share drawn, of which `accept` spawned a weight of random sign
    and log2-magnitude in [-24, 22); every other slot weight 0, flag off."""
    nd = int(drawn * n)
    ok = np.zeros(n, bool)
    ok[:nd] = rng.random(nd) < accept
    wt = np.zeros(n, dt)
    mag = 2.0 ** rng.uniform(-24.0, 22.0, nd)
    wt[:nd] = np.where(ok[:nd], mag * rng.choice([-1.0, 1.0], nd), 0.0)
    return wt, ok


def numpy_bins(wt, ok):
    """[N_HIST_BINS] int64 counts of the rule in numpy: floor(log2(max(|w|,
    TINY))) + 20, clamped to [0, 39], where ok and |w| > 0."""
    aw = np.abs(wt)
    with np.errstate(invalid="ignore", divide="ignore"):
        b = np.floor(np.log2(np.maximum(aw, aw.dtype.type(TINY)))) + 20.0
    keep = ok & (aw > 0)
    b = np.clip(b[keep], 0, N_HIST_BINS - 1).astype(np.int64)
    return np.bincount(b, minlength=N_HIST_BINS)
