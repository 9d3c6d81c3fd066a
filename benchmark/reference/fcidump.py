"""The reference's own FCIDUMP reader and orbital order.

Reads the raw file the program reads, into a dense h[p, q] and a dense
(pq|rs) with all eight permutations filled.  The program numbers the
orbitals as the reference code does (sort_integrals): the Hartree-Fock
occupied orbitals first, then the rest by ascending estimated orbital
energy, stable in the original label; :func:`orbital_order` works that
order out again from the integrals.
"""

from __future__ import annotations

import re

import numpy as np


def read(path: str):
    """(h, eri, core, norb, nelec, ms2, orb_sym) from a Molpro FCIDUMP."""
    with open(path) as f:
        text = f.read()
    head, body = re.split(r"&END|/", text, maxsplit=1)
    norb = int(re.search(r"NORB\s*=\s*(\d+)", head).group(1))
    nelec = int(re.search(r"NELEC\s*=\s*(\d+)", head).group(1))
    ms2 = int(re.search(r"MS2\s*=\s*(-?\d+)", head).group(1))
    sym = re.search(r"ORBSYM\s*=\s*([\d,\s]+)", head)
    orb_sym = np.array([int(x) for x in sym.group(1).replace(",", " ").split()]
                       if sym else [1] * norb)
    h = np.zeros((norb, norb))
    eri = np.zeros((norb,) * 4)
    core = 0.0
    for line in body.strip().splitlines():
        parts = line.split()
        if len(parts) < 5:
            continue
        v = float(parts[0].replace("D", "E"))
        p, q, r, s = (int(x) - 1 for x in parts[1:5])
        if p < 0:
            core = v
        elif r < 0:
            h[p, q] = h[q, p] = v
        else:
            for a, b, c, d in ((p, q, r, s), (q, p, r, s), (p, q, s, r),
                               (q, p, s, r), (r, s, p, q), (s, r, p, q),
                               (r, s, q, p), (s, r, q, p)):
                eri[a, b, c, d] = v
    return h, eri, core, norb, nelec, ms2, orb_sym[:norb]


def orbital_order(h, eri, nup: int, ndn: int) -> np.ndarray:
    """perm[new] = original orbital: occupied orbitals of the aufbau det
    first, then ascending e_i = h_ii + (exchange_i + direct_i) / 2, where
    the same-spin sums skip j == i (the reference code's estimate)."""
    norb = h.shape[0]
    idx = np.arange(norb)
    D = eri[idx[:, None], idx[:, None], idx[None, :], idx[None, :]]
    X = eri[idx[:, None], idx[None, :], idx[:, None], idx[None, :]]
    up = (idx < nup).astype(float)
    dn = (idx < ndn).astype(float)
    e = np.diag(h).copy()
    for i in range(norb):
        exch = -(X[i] @ up - X[i, i] * up[i]) - (X[i] @ dn - X[i, i] * dn[i])
        dir_ = (D[i] @ up - D[i, i] * up[i]) + D[i] @ dn \
            + (D[i] @ dn - D[i, i] * dn[i]) + D[i] @ up
        e[i] += 0.5 * (exch + dir_)
    key = e - 1e9 * ((idx < nup) | (idx < ndn))
    return np.argsort(key, kind="stable")


def load(path: str, nup: int | None = None):
    """(h, eri, core, norb, nup, ndn) in the program's orbital order."""
    h, eri, core, norb, nelec, ms2, _ = read(path)
    nup = (nelec + ms2) // 2 if nup is None else nup
    ndn = nelec - nup
    perm = orbital_order(h, eri, nup, ndn)
    h = h[np.ix_(perm, perm)]
    eri = eri[np.ix_(perm, perm, perm, perm)]
    return h, eri, core, norb, nup, ndn
