"""Hubbard model backends: momentum-space (hubbardk) and real-space
(hubbard2) (port of sqmc_tpu/systems/hubbard/system.py).

Both go through the unified integral interface:

  * hubbardk (ref: hamiltonian_hubbard_k:2866, generate_k_vectors:2179):
    k-lattice kx in {-Lx+2i} (shifted by -1 for odd Lx), dispersion
    eps(k) = -2t (cos(pi kx/Lx) + cos(pi ky/Ly)); the on-site U becomes the
    analytic integral (pq|rs) = U/N under momentum conservation modulo the
    reciprocal lattice (2Lx, 2Ly), umklapp included.  Spin-free integrals
    cancel the same-spin doubles and give the reference's diagonal
    U/N nup ndn + sum eps.
  * hubbard2 (ref: hamiltonian_hubbard:1536): site basis, hopping h,
    on-site-only (pp|pp) = U dense integrals; every double vanishes and
    the walk's single (hopping) channel carries the dynamics.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import dets
from ..base import FermionSystem
from ..chem.integrals import IntegralTable, n_eri, pair_index, quad_index
from ..heatbath import build_heatbath


def hubbard_k_vectors(l_x: int, l_y: int):
    """Integer k-vectors and band energies (t = 1), sorted ascending by
    energy (ref: hubbard.f90:2238-2283)."""
    kx = -l_x + 2 * np.arange(1, l_x + 1)
    ky = -l_y + 2 * np.arange(1, l_y + 1)
    if l_x % 2 == 1:
        kx = kx - 1
    if l_y % 2 == 1:
        ky = ky - 1
    KX, KY = np.meshgrid(kx, ky, indexing="ij")
    rel = np.stack([KX.ravel(), KY.ravel()], axis=1)
    if l_y == 1:
        e = -2 * np.cos(np.pi * rel[:, 0] / l_x)
    elif l_x == 1:
        e = -2 * np.cos(np.pi * rel[:, 1] / l_y)
    else:
        e = -2 * (np.cos(np.pi * rel[:, 0] / l_x) +
                  np.cos(np.pi * rel[:, 1] / l_y))
    order = np.argsort(e, kind="stable")
    return rel[order], e[order]


def make_hubbard_k_system(l_x: int, l_y: int, t: float, U: float, nup: int,
                          ndn: int, with_heatbath: bool = True,
                          device="cuda") -> FermionSystem:
    """Momentum-space Hubbard as a FermionSystem (analytic integrals) on
    `device`."""
    nsites = l_x * l_y
    rel, e = hubbard_k_vectors(l_x, l_y)
    e = e * t
    V = np.full((nsites, nsites), U / nsites)
    table = IntegralTable.from_heg(np.diag(e), V, rel,
                                   mod=np.array([2 * l_x, 2 * l_y]),
                                   device=device)
    return FermionSystem(
        name="hubbardk", norb=nsites, nup=nup, ndn=ndn, table=table,
        heatbath=build_heatbath(table) if with_heatbath else None,
        orb_sym_arr=torch.ones(nsites, dtype=torch.int32, device=device),
        has_singles=False,      # momentum conservation kills single hops
        hf_up=dets.det_from_orbs(range(nup), nsites),
        hf_dn=dets.det_from_orbs(range(ndn), nsites),
        extra=dict(l_x=l_x, l_y=l_y, t=t, U=U, k_rel=rel, k_energies=e))


def make_hubbard_real_system(l_x: int, l_y: int, t: float, U: float,
                             nup: int, ndn: int, pbc: bool = True,
                             with_heatbath: bool = True,
                             device="cuda") -> FermionSystem:
    """Real-space Hubbard on `device`: hopping one-body matrix + on-site U."""
    nsites = l_x * l_y

    def site(ix, iy):
        return ix * l_y + iy

    h = np.zeros((nsites, nsites))
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

    eri = np.zeros(n_eri(nsites))
    p = np.arange(nsites)
    eri[quad_index(pair_index(p, p), pair_index(p, p))] = U
    table = IntegralTable.from_dense_arrays(h, eri, 0.0,
                                            np.ones(nsites, np.int32),
                                            device=device)
    return FermionSystem(
        name="hubbard2", norb=nsites, nup=nup, ndn=ndn, table=table,
        heatbath=build_heatbath(table) if with_heatbath else None,
        orb_sym_arr=torch.ones(nsites, dtype=torch.int32, device=device),
        has_singles=True,
        hf_up=dets.det_from_orbs(range(nup), nsites),
        hf_dn=dets.det_from_orbs(range(ndn), nsites),
        extra=dict(l_x=l_x, l_y=l_y, t=t, U=U, pbc=pbc))


def enumerate_dets(nsites: int, nup: int, ndn: int):
    """Every (up, dn) det of the sector as int64 words [n, W] (host
    numpy): det index = iup * len(dns) + idn, both spin strings in
    lexicographic orbital order."""
    import itertools
    ups = np.stack([dets.det_from_orbs(c, nsites)
                    for c in itertools.combinations(range(nsites), nup)])
    dns = np.stack([dets.det_from_orbs(c, nsites)
                    for c in itertools.combinations(range(nsites), ndn)])
    return np.repeat(ups, len(dns), axis=0), np.tile(dns, (len(ups), 1))


def make_hubbard_dense_system(l_x: int, l_y: int, t: float, U: float,
                              nup: int, ndn: int, pbc: bool = True,
                              device="cuda"):
    """The reference's `hubbard` toy type: the full Hilbert-space dense
    Hamiltonian of a small real-space lattice (ref: hamiltonian_mod.f90:
    273-301, make_hubbard_matrix_2d:937), as a ToySystem on `device` for
    the dense-vector walk engine (algo/densewalk.py)."""
    from ...algo.sparseham import build_sparse_ham
    from ..toy import ToySystem

    sysr = make_hubbard_real_system(l_x, l_y, t, U, nup, ndn, pbc=pbc,
                                    with_heatbath=False, device=device)
    nsites = l_x * l_y
    up, dn = enumerate_dets(nsites, nup, ndn)
    sp = build_sparse_ham(sysr.table, torch.as_tensor(up, device=device),
                          torch.as_tensor(dn, device=device), nup, ndn, nsites)
    return ToySystem(ham=sp.dense(), kind="hubbard-dense")
