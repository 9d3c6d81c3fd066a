"""The reference's Hubbard model in momentum space (the upstream's
`hubbardk` Hamiltonian: src/hubbard.f90, read_hubbard and
hamiltonian_hubbard_k).

An l_x x l_y periodic lattice of N sites, hopping t, on-site U.  Its
orbitals are the N Bloch waves k = (pi k_x / l_x, pi k_y / l_y) with
integer k_x in {-l_x + 2, -l_x + 4, ..., l_x} (each moved down by 1 when
l_x is odd), likewise k_y, swept with k_x outer and k_y inner, then put
in ascending order of their band energy, ties kept in the sweep's order
(the upstream's generate_k_vectors).

    h[p, q]   = delta_pq eps(k_p),  eps(k) = -2t (cos k_x + cos k_y)
                (a side of length 1 has no hopping along it)
    (pq|rs)   = U / N  when k_p + k_r = k_q + k_s modulo the reciprocal
                lattice (2 l_x, 2 l_y in these integer units; umklapp
                included), and 0 otherwise

so the same-spin doubles cancel and a det's diagonal is the sum of its
band energies plus U / N nup ndn.
"""

from __future__ import annotations

import numpy as np


def kvectors(l_x: int, l_y: int):
    """The integer k-vectors [N, 2] and band energies at t = 1 [N], in
    the orbital order."""
    def axis(n):
        k = np.arange(1, n + 1) * 2 - n
        return k - 1 if n % 2 else k
    kx, ky = axis(l_x), axis(l_y)
    k = np.array([(a, b) for a in kx for b in ky], dtype=np.int64)
    e = np.zeros(len(k))
    if l_x > 1:
        e -= 2.0 * np.cos(np.pi * k[:, 0] / l_x)
    if l_y > 1:
        e -= 2.0 * np.cos(np.pi * k[:, 1] / l_y)
    order = np.argsort(e, kind="stable")
    return k[order], e[order]


def integrals(l_x: int, l_y: int, t: float, U: float):
    """(h, eri, core, norb) of the momentum-space Hubbard model, for
    slater.Hamiltonian."""
    k, e = kvectors(l_x, l_y)
    norb = len(k)
    mod = np.array([2 * l_x, 2 * l_y])
    h = np.diag(t * e)
    # (pq|rs) nonzero iff k_p - k_q + k_r - k_s = 0 modulo the lattice
    d = k[:, None, :] - k[None, :, :]                         # k_p - k_q
    tot = d[:, :, None, None, :] + d[None, None, :, :, :]
    conserved = (np.mod(tot, mod) == 0).all(-1)
    eri = np.where(conserved, U / norb, 0.0)
    return h, eri, 0.0, norb
