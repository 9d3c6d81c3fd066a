"""Guiding wavefunctions for importance-sampled / fixed-node determinant
walks (port of sqmc_tpu/algo/guiding.py).

The reference evaluates guiding-wavefunction ratios per proposed move
(Gutzwiller x free-fermion determinant ratios via Sherman-Morrison,
hubbard.f90 det_ratio_hubbard:4346; trial-wavefunction files for the toy
models, read_psit hamiltonian_mod.f90:1299).  The walk here evaluates
psi_g on whole batches of determinants: batched k x k determinants
(cofactor formulas for k <= 4, torch.linalg.det beyond) times a Gutzwiller
double-occupancy factor, or a sorted-table lookup.

psi_g is signed; the fixed-node rules test the sign of the
importance-transformed flow Ht_ij = (psi_g_i / psi_g_j) H_ij, which does
not depend on a global sign convention (ref run_type dispatch
do_walk.f90:38-50, move variants :3460-4748).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import dets
from ..ops import setalg

F64 = torch.float64


class Guiding(NamedTuple):
    """Guiding-wavefunction data on one device.

    kind (lives in WalkConfig.guiding):
      'gutzwiller': psi_g(D) = det(phi_up[occ_up]) * det(phi_dn[occ_dn])
                    * g^n_double
      'table':      psi_g from a sorted complete det table (toy systems)
    """
    phi_up: torch.Tensor     # [norb, nup] f64
    phi_dn: torch.Tensor     # [norb, ndn] f64
    g: torch.Tensor          # [] f64 Gutzwiller factor
    tab_up: torch.Tensor     # [n, W] int64 sorted packed dets ('table')
    tab_dn: torch.Tensor
    tab_val: torch.Tensor    # [n] f64


def empty_guiding(device="cuda") -> Guiding:
    z = torch.zeros((1, 1), dtype=F64, device=device)
    zu = torch.zeros((1, 1), dtype=torch.int64, device=device)
    return Guiding(phi_up=z, phi_dn=z,
                   g=torch.ones((), dtype=F64, device=device),
                   tab_up=zu, tab_dn=zu,
                   tab_val=torch.zeros(1, dtype=F64, device=device))


def make_gutzwiller_guiding(system, g: float = 1.0, phi_up=None,
                            phi_dn=None) -> Guiding:
    """Free-fermion x Gutzwiller guiding from the one-body hamiltonian's
    lowest orbitals, on the system's device (ref: wf_type 'gutz'
    hubbard.f90 set_gutzwiller:1432).

    A degenerate Fermi level makes the Slater part ill-conditioned: pass
    orbitals of your own or pick a filling with a gap.
    """
    dev = system.device
    if phi_up is None or phi_dn is None:
        _, v = np.linalg.eigh(system.table.h.cpu().numpy())
        phi_up = v[:, :system.nup] if phi_up is None else phi_up
        phi_dn = v[:, :system.ndn] if phi_dn is None else phi_dn
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)  # noqa: E731
    return empty_guiding(dev)._replace(
        phi_up=t(phi_up), phi_dn=t(phi_dn),
        g=torch.tensor(float(g), dtype=F64, device=dev))


def make_table_guiding(up, dn, values, device="cuda") -> Guiding:
    """Guiding from explicit per-det values (complete toy det spaces; ref
    read_psit).  The table is sorted on construction."""
    up = torch.as_tensor(np.asarray(up).view(np.int64), device=device)
    dn = torch.as_tensor(np.asarray(dn).view(np.int64), device=device)
    val = torch.as_tensor(np.asarray(values, np.float64), device=device)
    order = setalg.lexsort_dets(up, dn)
    return empty_guiding(device)._replace(
        tab_up=up[order], tab_dn=dn[order], tab_val=val[order])


def _det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _batched_det(m: torch.Tensor) -> torch.Tensor:
    """det of [..., k, k] float64: cofactor expansion for k <= 4 (plain
    arithmetic, no LU on the walk's path), torch.linalg.det beyond."""
    k = m.shape[-1]
    if k == 1:
        return m[..., 0, 0]
    if k == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if k == 3:
        return _det3(m)
    if k == 4:
        def minor(cols):
            return _det3(m[..., 1:, :][..., :, cols])
        return (m[..., 0, 0] * minor([1, 2, 3])
                - m[..., 0, 1] * minor([0, 2, 3])
                + m[..., 0, 2] * minor([0, 1, 3])
                - m[..., 0, 3] * minor([0, 1, 2]))
    return torch.linalg.det(m)


def eval_guiding(guide: Guiding, kind: str, up: torch.Tensor,
                 dn: torch.Tensor, norb: int, nup: int,
                 ndn: int) -> torch.Tensor:
    """Batched signed psi_g for packed dets [B, W] -> [B] float64.  Rows
    that hold the empty-slot sentinel give an arbitrary finite value."""
    if kind == "gutzwiller":
        occ_up = dets.occ_orbitals(dets.to_bits(up, norb), nup)
        occ_dn = dets.occ_orbitals(dets.to_bits(dn, norb), ndn)
        det_up = _batched_det(guide.phi_up[occ_up])
        det_dn = _batched_det(guide.phi_dn[occ_dn])
        ndouble = dets.popcount(up & dn).to(F64)
        return det_up * det_dn * guide.g ** ndouble
    if kind == "table":
        # setalg compares flipped words, so dets with bit 63 set keep the
        # table's unsigned order
        idx = setalg.search_dets(guide.tab_up, guide.tab_dn, up, dn)
        v = guide.tab_val[idx.clamp(min=0)]
        return torch.where(idx >= 0, v, torch.zeros_like(v))
    raise ValueError(f"unknown guiding kind {kind!r}")


def eval_guiding_np(guide: Guiding, kind: str, up: np.ndarray,
                    dn: np.ndarray, norb: int, nup: int,
                    ndn: int) -> np.ndarray:
    """Host-side psi_g, one det at a time (an independent check of
    eval_guiding; int64 or uint64 words)."""
    up = np.asarray(up).view(np.int64)
    dn = np.asarray(dn).view(np.int64)
    if kind == "gutzwiller":
        phi_up = guide.phi_up.cpu().numpy()
        phi_dn = guide.phi_dn.cpu().numpy()
        g = float(guide.g)
        out = np.empty(len(up))
        for i in range(len(up)):
            ou = dets.orbs_from_det(up[i], norb)
            od = dets.orbs_from_det(dn[i], norb)
            nd = len(set(ou) & set(od))
            out[i] = (np.linalg.det(phi_up[ou]) * np.linalg.det(phi_dn[od])
                      * g ** nd)
        return out
    if kind == "table":
        tu = guide.tab_up.cpu().numpy()
        td = guide.tab_dn.cpu().numpy()
        tv = guide.tab_val.cpu().numpy()
        out = np.zeros(len(up))
        for i in range(len(up)):
            m = np.all(tu == up[i], axis=1) & np.all(td == dn[i], axis=1)
            j = np.nonzero(m)[0]
            if len(j):
                out[i] = tv[j[0]]
        return out
    raise ValueError(f"unknown guiding kind {kind!r}")
