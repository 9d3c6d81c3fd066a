"""Homogeneous electron gas in a plane-wave basis (port of
sqmc_tpu/systems/heg/system.py; ref: heg.f90 read_heg:102,
generate_k_vectors:643, hamiltonian_heg:845, madelung_energy:2828).

The HEG is a molecular-type system with analytic integrals

    h[p,q]  = delta_pq |k_p|^2 / 2
    (pq|rs) = V(k_p - k_q) delta_{k_p - k_q, k_s - k_r}   (V(0) -> 0)

with V(t) = 4pi/(L^3 t^2) in 3D and 2pi/(L^2 |t|) in 2D; singles vanish
and doubles conserve momentum.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import dets
from ..base import FermionSystem
from ..chem.integrals import IntegralTable
from ..heatbath import build_heatbath

EPS = 1e-10


def generate_k_vectors(n_dim: int, length_cell: float, cutoff_radius: float):
    """Integer k-vectors with |n| <= cutoff_radius, sorted by |k|.
    Returns (k_phys [norb,n_dim], k_rel int [norb,n_dim])."""
    n_max = int(cutoff_radius + EPS)
    rng = np.arange(-n_max, n_max + 1)
    if n_dim == 3:
        grids = np.meshgrid(rng, rng, rng, indexing="ij")
    elif n_dim == 2:
        grids = np.meshgrid(rng, rng, indexing="ij")
    else:
        raise ValueError("only 2D and 3D HEG")
    rel = np.stack([g.ravel() for g in grids], axis=1)
    mag2 = np.sum(rel * rel, axis=1)
    keep = mag2 <= cutoff_radius * cutoff_radius + EPS
    rel, mag2 = rel[keep], mag2[keep]
    rel = rel[np.argsort(mag2, kind="stable")]
    return rel * (2 * np.pi / length_cell), rel


def madelung_energy(n_dim: int, length_cell: float, nelec: int) -> float:
    """Ewald self-interaction constant (3D only; ref: heg.f90:2828)."""
    if n_dim != 3:
        raise ValueError(
            "Madelung energy is only implemented for 3D (ref heg.f90:2845)")
    kappa = 10.0 / length_cell
    n_max = 1
    while True:
        g_max = 2 * np.pi * n_max / length_cell
        if (4 * np.pi / length_cell**3 * np.exp(-(g_max / (2 * kappa))**2)
                / g_max**2 < 1e-10):
            break
        n_max += 1
    rng = np.arange(-n_max, n_max + 1)
    gx, gy, gz = np.meshgrid(rng, rng, rng, indexing="ij")
    g2 = (gx**2 + gy**2 + gz**2).astype(np.float64) * (2 * np.pi / length_cell) ** 2
    g2 = g2[g2 > 1e-10]
    e = np.sum(np.exp(-g2 / (2 * kappa) ** 2) / g2) * 4 * np.pi / length_cell**3
    e = e - np.pi / length_cell**3 / kappa**2 - 2 * kappa / np.sqrt(np.pi)
    return float(e * nelec / 2.0)


def make_heg_system(n_dim: int, r_s: float, nelec: int, nup: int,
                    cutoff_radius: float, device="cuda") -> FermionSystem:
    """The HEG as a FermionSystem with analytic integrals on `device`."""
    ndn = nelec - nup
    density = (1.0 / (np.pi * r_s**2) if n_dim == 2
               else 3.0 / (4.0 * np.pi * r_s**3))
    length_cell = (nelec / density) ** (1.0 / n_dim)

    k, k_rel = generate_k_vectors(n_dim, length_cell, cutoff_radius)
    norb = len(k)
    dk = k[:, None, :] - k[None, :, :]
    dk2 = np.sum(dk * dk, axis=-1)
    with np.errstate(divide="ignore"):
        if n_dim == 3:
            V = 4 * np.pi / (length_cell**3 * dk2)
        else:
            V = 2 * np.pi / (length_cell**2 * np.sqrt(dk2))
    np.fill_diagonal(V, 0.0)
    h = np.diag(0.5 * np.sum(k * k, axis=1))
    table = IntegralTable.from_heg(h, V, k_rel, device=device)

    u = np.zeros(norb); u[:nup] = 1
    d = np.zeros(norb); d[:ndn] = 1
    e_kin = float(np.sum((u + d) * np.diag(h)))
    e_x = float(-0.5 * (u @ V @ u) - 0.5 * (d @ V @ d))
    madelung_ok = n_dim == 3
    e_mad = madelung_energy(n_dim, length_cell, nelec) if madelung_ok else 0.0
    return FermionSystem(
        name="heg", norb=norb, nup=nup, ndn=ndn, table=table,
        heatbath=build_heatbath(table),
        orb_sym_arr=torch.ones(norb, dtype=torch.int32, device=device),
        has_singles=False,
        hf_up=dets.det_from_orbs(range(nup), norb),
        hf_dn=dets.det_from_orbs(range(ndn), norb),
        extra=dict(n_dim=n_dim, r_s=r_s, length_cell=length_cell,
                   k_vectors=k, k_rel=k_rel, energy_hf=e_kin + e_x,
                   energy_madelung=e_mad, madelung_implemented=madelung_ok))
