"""Orbital energies and deterministic MP2 (port of
sqmc_tpu/systems/chem/mp2.py), the reference's built-in cross-check of
the integrals and the excitation machinery.

ref: chemistry.f90 compute_orbital_energies:9378-9443 (eps_i = h_ii +
(direct + exchange) / 2 over the HF occupancies) and
mp2_deterministic:9445-9560 (sum over every HF connection of H_0k^2 /
(sum eps_removed - sum eps_added)).  The connections, their occupancies
and the sum run on the system's device; the norb-sized orbital energies
on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import dets


def _occ_vector(words: np.ndarray, norb: int) -> np.ndarray:
    return dets.to_bits(torch.as_tensor(words)[None], norb)[0].numpy()


def compute_orbital_energies(system) -> np.ndarray:
    """eps_p for the system's HF determinant (float64 [norb])."""
    norb = system.norb
    t = system.table
    h = t.h.cpu().numpy()
    n_up = _occ_vector(system.hf_up, norb).astype(np.float64)
    n_dn = _occ_vector(system.hf_dn, norb).astype(np.float64)
    P, J = np.meshgrid(np.arange(norb), np.arange(norb), indexing="ij")
    J_dir = np.asarray(t.eri_value_np(P.ravel(), P.ravel(), J.ravel(),
                                      J.ravel()), np.float64).reshape(norb, norb)
    K_exc = np.asarray(t.eri_value_np(P.ravel(), J.ravel(), J.ravel(),
                                      P.ravel()), np.float64).reshape(norb, norb)
    off = 1.0 - np.eye(norb)
    # ref 9399-9435: same-spin direct terms exclude j == i, cross-spin ones
    # do not; exchange excludes j == i for both spins; all halved
    direct = ((off * J_dir) @ n_up + J_dir @ n_dn +
              (off * J_dir) @ n_dn + J_dir @ n_up)
    exchange = -(off * K_exc) @ (n_up + n_dn)
    return np.diag(h) + 0.5 * (direct + exchange)


def mp2_deterministic(system, orbital_energies: np.ndarray | None = None):
    """(E_mp2_correction, orbital_energies): the second-order
    Moller-Plesset lowering from the HF determinant."""
    from ...algo.connect import generate_connections

    eps = (compute_orbital_energies(system) if orbital_energies is None
           else np.asarray(orbital_energies, np.float64))
    norb = system.norb
    dev = system.device
    hf_up = torch.as_tensor(system.hf_up[None], device=dev)
    hf_dn = torch.as_tensor(system.hf_dn[None], device=dev)
    cu, cd, helem, _ = generate_connections(
        system, hf_up, hf_dn, torch.zeros(1, dtype=torch.float64, device=dev))
    if len(cu) == 0:
        return 0.0, eps
    e = torch.as_tensor(eps, device=dev)

    def bits(w):
        return dets.to_bits(w, norb).bool()

    b_hu, b_hd, b_cu, b_cd = bits(hf_up), bits(hf_dn), bits(cu), bits(cd)

    def energy(mask):
        return mask.to(torch.float64) @ e

    removed = energy(b_hu & ~b_cu) + energy(b_hd & ~b_cd)
    added = energy(~b_hu & b_cu) + energy(~b_hd & b_cd)
    den = removed - added
    ok = den.abs() > 1e-12
    return float(torch.sum(helem[ok] ** 2 / den[ok])), eps
