"""Hubbard lattice mean-field wavefunctions: RHF / staggered-field UHF
orbitals and energies (host numpy; the port's own copy of
sqmc_tpu/systems/hubbard/meanfield.py).

ref: hubbard.f90 do_hartree_fock:848-1024 - one-shot diagonalization of
the hopping matrix plus a staggered on-site mean-field potential
0.5*U*(<n> +- m) on the two sublattices (no SCF loop; m is scanned and
the best/chosen m's orbitals feed the Gutzwiller trial wavefunction).
Mean-field energy = sum(eps_occ) - (U/4)(<n>-m)(<n>+m)*nsites
(ref :969-970).
"""

from __future__ import annotations

import numpy as np


def hopping_matrix(l_x: int, l_y: int, t: float, pbc: bool = True
                   ) -> np.ndarray:
    """Nearest-neighbor hopping -t on an l_x*l_y lattice (site = ix*l_y+iy;
    matches systems/hubbard/system.py make_hubbard_real_system)."""
    nsites = l_x * l_y
    h = np.zeros((nsites, nsites))

    def site(ix, iy):
        return ix * l_y + iy

    for ix in range(l_x):
        for iy in range(l_y):
            for dx, dy in ((1, 0), (0, 1)):
                jx, jy = ix + dx, iy + dy
                if jx < l_x and jy < l_y:
                    h[site(ix, iy), site(jx, jy)] = -t
                    h[site(jx, jy), site(ix, iy)] = -t
                elif pbc:
                    jx %= l_x
                    jy %= l_y
                    if (dx and l_x > 2) or (dy and l_y > 2):
                        h[site(ix, iy), site(jx, jy)] = -t
                        h[site(jx, jy), site(ix, iy)] = -t
    return h


def _stagger(l_x: int, l_y: int) -> np.ndarray:
    """+1 on the even (x+y) sublattice, -1 on the odd (ref :906-916
    mod(x+y,2) pattern with 1-based x,y)."""
    s = np.empty(l_x * l_y)
    for ix in range(l_x):
        for iy in range(l_y):
            x, y = ix + 1, iy + 1          # the reference's 1-based coords
            s[ix * l_y + iy] = 1.0 if (x + y) % 2 == 0 else -1.0
    return s


def hartree_fock(l_x: int, l_y: int, t: float, U: float, nup: int,
                 ndn: int, pbc: bool = True, m: float = 0.0):
    """Mean-field orbitals at staggered magnetization m (m=0: RHF).

    Returns (phi_up [nsites, nup], phi_dn [nsites, ndn], energy)."""
    nsites = l_x * l_y
    h = hopping_matrix(l_x, l_y, t, pbc)
    avgn = (nup + ndn) / nsites
    s = _stagger(l_x, l_y)
    f_up = h + np.diag(0.5 * U * (avgn + m * s))
    f_dn = h + np.diag(0.5 * U * (avgn - m * s))
    w_up, v_up = np.linalg.eigh(f_up)
    w_dn, v_dn = np.linalg.eigh(f_dn)
    energy = (np.sum(w_up[:nup]) + np.sum(w_dn[:ndn]) -
              0.25 * U * (avgn - m) * (avgn + m) * nsites)
    return v_up[:, :nup], v_dn[:, :ndn], float(energy)


def uhf_scan(l_x: int, l_y: int, t: float, U: float, nup: int, ndn: int,
             pbc: bool = True, ms=None):
    """Scan staggered m (ref :938-980 default -0.6..0.6 by 0.1); returns
    [(m, energy)] and the minimum-energy orbitals."""
    if ms is None:
        ms = np.arange(-0.6, 0.6001, 0.1)
    results = []
    best = None
    for m in ms:
        pu, pd, e = hartree_fock(l_x, l_y, t, U, nup, ndn, pbc, float(m))
        results.append((float(m), e))
        if best is None or e < best[2]:
            best = (pu, pd, e, float(m))
    return results, best
