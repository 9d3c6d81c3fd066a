"""Integral storage with a uniform batched-lookup interface (port of
sqmc_tpu/systems/chem/integrals.py).

Two backends behind one dataclass:

  * dense: molecular integrals in the 8-fold-symmetric compact array
    (ref: chemistry.f90:538 read_integrals, :9106 integral_index);
  * analytic HEG: (pq|rs) = V(k_p - k_q) under momentum conservation,
    evaluated on the fly from O(norb^2) tables; with ``heg_mod`` the
    conservation holds modulo the reciprocal lattice (Hubbard-k umklapp).

Derived matrices: D[p,q]=(pp|qq), X[p,q]=(pq|qp), and the single-
excitation tensors sing_dir[(p,r),q]=(pr|qq), sing_exch[(p,r),q]=(pq|qr).
Conventions: 0-based orbitals, chemist notation.  Every float tensor is
float64; ``to(device)`` moves the table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def pair_index(a, b):
    """Compact symmetric pair index: max*(max+1)//2 + min (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        hi = torch.maximum(a, b).to(torch.int64)
        lo = torch.minimum(a, b).to(torch.int64)
    else:
        hi = np.maximum(a, b)
        lo = np.minimum(a, b)
    return hi * (hi + 1) // 2 + lo


quad_index = pair_index          # same formula over pair indices


def n_eri(norb: int) -> int:
    """Length of the compact 8-fold-symmetric two-electron array."""
    npair = norb * (norb + 1) // 2
    return npair * (npair + 1) // 2


def _f64(x, device):
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


@dataclasses.dataclass
class IntegralTable:
    """All integrals for one system.  Dense backend: ``eri`` holds the
    compact two-electron array.  HEG backend: ``eri`` is None, ``heg_V``
    [norb,norb] holds V(k_p-k_q) and ``heg_rel`` [norb,dim] the integer
    k-vectors; ``heg_mod`` [dim], when set, makes momentum conservation
    modular (Hubbard-k umklapp)."""

    norb: int
    core_energy: float
    h: torch.Tensor
    orb_sym: np.ndarray
    direct: torch.Tensor
    exchange: torch.Tensor
    eri: torch.Tensor | None = None
    sing_dir: torch.Tensor | None = None
    sing_exch: torch.Tensor | None = None
    heg_V: torch.Tensor | None = None
    heg_rel: torch.Tensor | None = None
    heg_mod: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.h.device

    @staticmethod
    def from_dense_arrays(h: np.ndarray, eri_compact: np.ndarray, core: float,
                          orb_sym: np.ndarray, device="cuda") -> "IntegralTable":
        norb = h.shape[0]
        eri_compact = np.asarray(eri_compact, np.float64)
        p = np.arange(norb)
        diag_pair = pair_index(p, p)
        D = eri_compact[quad_index(diag_pair[:, None], diag_pair[None, :])]
        pq = pair_index(p[:, None], p[None, :])
        X = eri_compact[quad_index(pq, pq)]
        P, R, Q = np.meshgrid(p, p, p, indexing="ij")
        sd = eri_compact[quad_index(pair_index(P, R), pair_index(Q, Q))]
        se = eri_compact[quad_index(pair_index(P, Q), pair_index(Q, R))]
        return IntegralTable(
            norb=norb, core_energy=float(core), h=_f64(h, device),
            orb_sym=np.asarray(orb_sym, dtype=np.int32),
            direct=_f64(D, device), exchange=_f64(X, device),
            eri=_f64(eri_compact, device),
            sing_dir=_f64(sd.reshape(norb * norb, norb), device),
            sing_exch=_f64(se.reshape(norb * norb, norb), device))

    @staticmethod
    def from_heg(h: np.ndarray, V: np.ndarray, k_rel: np.ndarray,
                 mod: np.ndarray | None = None,
                 device="cuda") -> "IntegralTable":
        """Momentum-space system with (pq|rs) = V[p,q] under momentum
        conservation, exact or (with `mod`) modulo the reciprocal lattice:
        D[p,q] = V[p,p], X[p,q] = V[p,q].  For jellium V has a zero
        diagonal; for Hubbard-k V = U/N everywhere and `mod` = (2Lx, 2Ly)
        brings the umklapp terms."""
        norb = h.shape[0]
        V = np.asarray(V, np.float64)
        D = np.broadcast_to(np.diag(V)[:, None], (norb, norb)).copy()
        return IntegralTable(
            norb=norb, core_energy=0.0, h=_f64(h, device),
            orb_sym=np.ones(norb, dtype=np.int32),
            direct=_f64(D, device), exchange=_f64(V, device),
            heg_V=_f64(V, device),
            heg_rel=torch.as_tensor(np.asarray(k_rel, np.int64),
                                    device=device),
            heg_mod=None if mod is None else torch.as_tensor(
                np.asarray(mod, np.int64), device=device))

    def to(self, device) -> "IntegralTable":
        """The same table with every tensor on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    # ------------------------------------------------------------------
    def eri_value(self, p, q, r, s) -> torch.Tensor:
        """(pq|rs) for batched index tensors (float64)."""
        if self.eri is not None:
            return self.eri[quad_index(pair_index(p, q), pair_index(r, s))]
        rel = self.heg_rel
        d = rel[p] - rel[q] + rel[r] - rel[s]
        if self.heg_mod is not None:
            # remainder is non-negative for a positive modulus, as numpy's
            # % is (fmod and the C % keep the dividend's sign)
            d = torch.remainder(d, self.heg_mod)
        conserve = (d == 0).all(dim=-1)
        return torch.where(conserve, self.heg_V[p, q],
                           torch.zeros((), dtype=torch.float64,
                                       device=self.heg_V.device))

    def eri_value_np(self, p, q, r, s) -> np.ndarray:
        """Host (numpy) version of eri_value, same semantics."""
        if self.eri is not None:
            eri = self.eri.cpu().numpy()
            return eri[quad_index(pair_index(np.asarray(p), np.asarray(q)),
                                  pair_index(np.asarray(r), np.asarray(s)))]
        rel = self.heg_rel.cpu().numpy()
        V = self.heg_V.cpu().numpy()
        d = rel[p] - rel[q] + rel[r] - rel[s]
        if self.heg_mod is not None:
            d = d % self.heg_mod.cpu().numpy()
        return np.where(np.all(d == 0, axis=-1), V[p, q], 0.0)
