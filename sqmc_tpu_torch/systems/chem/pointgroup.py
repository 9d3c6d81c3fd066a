"""Abelian point-group machinery (product tables, D-infinity-h Lz algebra;
the port's own copy of sqmc_tpu/systems/chem/pointgroup.py).

Re-design of init_point_group / product_table / get_lz / get_ind /
get_inverse_dih (ref: chemistry.f90:7232-7428, 9025-9104).  All supported
finite groups are abelian with XOR-structured multiplication in the Molpro
irrep ordering; d_infinity_h uses the (Lz, g/u) index packing.
"""

from __future__ import annotations

import numpy as np

_XOR_GROUPS = {
    "c1": 1, "cs": 2, "ci": 2, "c2": 2,
    "c2v": 4, "c2h": 4, "d2": 4,
    "d2h": 8,
}


class PointGroup:
    def __init__(self, name: str, orbital_symmetries: np.ndarray):
        self.name = name.strip().lower()
        self.dih = self.name in ("dih", "d_inf_h", "dinfh")
        if not self.dih and self.name not in _XOR_GROUPS:
            raise ValueError(f"unsupported point group {name}")
        self.orb_sym = np.asarray(orbital_symmetries, dtype=np.int32)
        if self.dih:
            self.n = int(12 * abs(self._lz(self.orb_sym.max())[0]) + 2)
        else:
            self.n = _XOR_GROUPS[self.name]

    # -- dih index algebra (ref get_lz:9081 / get_ind:9096) --
    @staticmethod
    def _lz(ind):
        ind = np.asarray(ind)
        lz = np.where(ind <= 2, 0, 1 + (ind - 3) // 4)
        neg = (np.mod((ind - 1) // 2, 2) == 0) & (ind > 2)
        lz = np.where(neg, -lz, lz)
        gu = np.where(ind <= 2, ind - 1, np.mod(ind + 1, 2))
        return lz, gu

    @staticmethod
    def _ind(lz, gu):
        lz = np.asarray(lz)
        gu = np.asarray(gu)
        ind = np.where(lz == 0, gu + 1, 4 * np.abs(lz) - 1 + gu)
        ind = np.where(lz < 0, ind + 2, ind)
        ind = np.where(lz == 0, gu + 1, ind)
        return ind

    def product(self, i, j):
        """Irrep product (1-based labels), vectorized."""
        i = np.asarray(i)
        j = np.asarray(j)
        if self.dih:
            lzi, gui = self._lz(i)
            lzj, guj = self._lz(j)
            return self._ind(lzi + lzj, np.mod(gui + guj, 2)).astype(np.int32)
        return (((i - 1) ^ (j - 1)) + 1).astype(np.int32)

    def inverse(self, i):
        """Inverse irrep (self-inverse except dih Lz sign flip;
        ref get_inverse_dih:9025)."""
        i = np.asarray(i)
        if not self.dih:
            return i
        lz, _ = self._lz(i)
        return np.where(lz > 0, i + 2, np.where(lz < 0, i - 2, i)).astype(np.int32)

    def det_symmetry(self, occ_orbitals_list) -> int:
        """Total irrep of a det given its occupied spatial orbitals."""
        sym = 1
        for o in occ_orbitals_list:
            sym = int(self.product(sym, int(self.orb_sym[o])))
        return sym
