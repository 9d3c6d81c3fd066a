"""Blocking statistics and autocorrelation analysis for MC energy traces
(numpy; port of sqmc_tpu/utils/blocking.py).

Re-design of the reference's end-of-run statistics (ref: do_walk.f90
2952-3190): ratio-of-means energy with covariance-corrected error, the
non-integrated autocorrelation time t_corr from lag-1 autocovariance, and
reblocked error bars.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BlockStats:
    e_mean: float
    e_err: float
    t_corr: float
    e_err_uncorr: float
    n_eff: float


def ratio_stats(e_num: np.ndarray, e_den: np.ndarray) -> BlockStats:
    """Energy = <num>/<den> with correlated-ratio error and t_corr.

    e_num/e_den: per-generation sums (the walk's e_num_gen/e_den_gen).
    Follows the reference's genabs convention: numerator signs are taken
    relative to the denominator sign.
    """
    num = e_num * np.sign(e_den)
    den = np.abs(e_den)
    n = len(num)
    nb = np.mean(num)
    db = np.mean(den)
    e = nb / db
    # per-step ratio series for autocorrelation
    ratio = e_num / np.where(e_den == 0, 1e-300, e_den)
    r = ratio - ratio.mean()
    var = np.mean(r * r)
    lag1 = np.mean(r[1:] * r[:-1])
    if var > 0 and 0 < lag1 < var:
        tau_corr = -1.0 / np.log(lag1 / var)
    else:
        tau_corr = 0.0
    t_corr = 1.0 + 2.0 * tau_corr

    # covariance-corrected ratio error (ref formula :2840)
    vn = np.var(num, ddof=1) / n
    vd = np.var(den, ddof=1) / n
    cov = np.cov(num, den, ddof=1)[0, 1] / n
    err2 = e * e * (vn / nb ** 2 + vd / db ** 2 - 2 * cov / (nb * db))
    err_uncorr = float(np.sqrt(max(err2, 0.0)))
    err = err_uncorr * np.sqrt(max(t_corr, 1.0))
    return BlockStats(e_mean=float(e), e_err=float(err), t_corr=float(t_corr),
                      e_err_uncorr=err_uncorr, n_eff=n / max(t_corr, 1.0))


def reblock(series: np.ndarray, max_levels: int = 16):
    """Flyvbjerg-Petersen reblocking: std error of the mean at successive
    block doublings.  Returns list of (block_size, err)."""
    x = np.asarray(series, dtype=np.float64)
    out = []
    size = 1
    for _ in range(max_levels):
        if len(x) < 4:
            break
        out.append((size, float(np.std(x, ddof=1) / np.sqrt(len(x)))))
        x = 0.5 * (x[: len(x) // 2 * 2 : 2] + x[1 : len(x) // 2 * 2 : 2])
        size *= 2
    return out


def write_walkalize(path: str, w_abs, e_gen, nwalk, reweight_inv,
                    start: int = 0, append: bool = False):
    """Per-step trace file consumed by external blocking tools
    (ref: do_walk.f90:2930 'walkalize' unit-1 trace): one line per
    generation, `step 1/reweight w_abs e_gen nwalk`.  `start` is the
    number of generations already written and `append` adds to the file,
    so a caller can write the trace block by block."""
    with open(path, "a" if append else "w") as f:
        for i in range(len(w_abs)):
            f.write(f"{start + i + 1:10d}{1.0 / reweight_inv[i]:12.6f}"
                    f"{w_abs[i]:13.6e}{e_gen[i]:19.12f}{int(nwalk[i]):9d}\n")
