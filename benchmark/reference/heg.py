"""The reference's electron gas: plane waves in a cubic cell.

Orbitals are the integer vectors n with |n| <= cutoff, k = 2 pi n / L,
numbered by ascending |n|^2, ties in the order of a lexicographic sweep
of (n_x, n_y, n_z) from -n_max up (the reference code's order).  The
cell holds `nelec` electrons at density 3 / (4 pi r_s^3).

    h[p, q]       = delta_pq |k_p|^2 / 2
    (pq|rs)       = 4 pi / (L^3 |k_p - k_q|^2)  when k_p - k_q = k_s - k_r,
                    p != q, and 0 otherwise

No Madelung constant is added (the energies the program reports leave it
out too).
"""

from __future__ import annotations

import numpy as np

EPS = 1e-10


def integrals(n_dim: int, r_s: float, nelec: int, cutoff: float):
    """(h, eri, core, norb) of the 3D electron gas."""
    if n_dim != 3:
        raise ValueError("the reference electron gas is three-dimensional")
    length = (nelec / (3.0 / (4.0 * np.pi * r_s ** 3))) ** (1.0 / 3.0)
    n_max = int(cutoff + EPS)
    r = np.arange(-n_max, n_max + 1)
    n = np.array([(a, b, c) for a in r for b in r for c in r])
    m2 = (n * n).sum(1)
    n = n[m2 <= cutoff * cutoff + EPS]
    n = n[np.argsort((n * n).sum(1), kind="stable")]
    norb = len(n)
    k = n * (2.0 * np.pi / length)
    h = np.diag(0.5 * (k * k).sum(1))
    dn = n[:, None, :] - n[None, :, :]                  # n_p - n_q
    dk2 = ((dn * (2.0 * np.pi / length)) ** 2).sum(-1)
    with np.errstate(divide="ignore"):
        V = np.where(dk2 > 0, 4.0 * np.pi / (length ** 3 * dk2), 0.0)
    # (pq|rs) nonzero iff n_p - n_q == n_s - n_r
    same = (dn[:, :, None, None, :] == -dn[None, None, :, :, :]).all(-1)
    eri = np.where(same, V[:, :, None, None], 0.0)
    return h, eri, 0.0, norb
