"""FermionSystem: the uniform per-system interface (port of
sqmc_tpu/systems/base.py).

Every second-quantized system reduces to an IntegralTable plus heat-bath
tables, so HCI, Davidson, PT and the walk are system-agnostic.  A
molecular system comes from an FCIDUMP (:func:`make_chem_system`) or from
dense arrays (:func:`make_system_from_arrays`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dets
from .chem.integrals import IntegralTable
from .heatbath import HeatbathTable, build_heatbath


@dataclasses.dataclass
class FermionSystem:
    name: str
    norb: int
    nup: int
    ndn: int
    table: IntegralTable
    heatbath: HeatbathTable | None
    orb_sym_arr: torch.Tensor       # int32 [norb] irrep labels (1-based)
    has_singles: bool               # False when singles vanish (HEG)
    hf_up: np.ndarray               # int64 packed words [W]
    hf_dn: np.ndarray
    extra: dict
    time_sym: bool = False          # not ported: must stay False
    z: int = 1

    @property
    def nelec(self):
        return self.nup + self.ndn

    @property
    def n_words(self):
        return dets.n_words(self.norb)

    @property
    def device(self) -> torch.device:
        return self.table.device



def make_system_from_arrays(h, eri_compact, core, nup, ndn, orb_sym=None,
                            name="chem", device="cuda") -> FermionSystem:
    """Molecular-type system from dense integrals (the form
    tests/test_walk.py builds for sqmc_tpu), HF det = lowest orbitals."""
    norb = np.asarray(h).shape[0]
    orb_sym = (np.ones(norb, np.int32) if orb_sym is None
               else np.asarray(orb_sym, np.int32))
    table = IntegralTable.from_dense_arrays(h, eri_compact, core, orb_sym,
                                            device=device)
    return FermionSystem(
        name=name, norb=norb, nup=nup, ndn=ndn, table=table,
        heatbath=build_heatbath(table),
        orb_sym_arr=torch.as_tensor(orb_sym, device=device),
        has_singles=True, hf_up=dets.det_from_orbs(range(nup), norb),
        hf_dn=dets.det_from_orbs(range(ndn), norb), extra={})


def make_chem_system(fcidump_path: str, nup: int | None = None,
                     ndn: int | None = None, reorder: bool = True,
                     with_heatbath: bool = True, time_sym: bool = False,
                     point_group: str | None = None,
                     hf_symmetry: int | None = None, hf_up_occ_in=None,
                     hf_dn_occ_in=None, device="cuda") -> FermionSystem:
    """Molecular system from an FCIDUMP (ref workload: chemistry.f90), on
    `device`.  hf_up_occ_in / hf_dn_occ_in: explicit starting-det
    occupations in 1-based ORIGINAL orbital labels (the reference's
    ``&hf_det`` namelist), mapped through the reordering.

    Not ported (each raises ValueError): time_sym (ROADMAP A3 remainder),
    point_group and hf_symmetry (ROADMAP A8, systems/chem/pointgroup)."""
    if time_sym:
        raise ValueError("time-reversal symmetrized systems are not ported "
                         "(ROADMAP A3 remainder)")
    if point_group is not None or hf_symmetry is not None:
        raise ValueError("point groups and hf_symmetry are not ported "
                         "(ROADMAP A8)")
    from .chem.fcidump import load_fcidump_system

    table, hf_up_occ, hf_dn_occ, info = load_fcidump_system(
        fcidump_path, nup=nup, ndn=ndn, reorder=reorder, device=device)
    if hf_up_occ_in is not None:
        perm = np.asarray(info["perm"])       # perm[new] = original index
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))      # original -> new

        def _map(orbs):
            return np.sort(inv[np.asarray(orbs, np.int64) - 1])

        hf_up_occ = _map(hf_up_occ_in)
        hf_dn_occ = _map(hf_dn_occ_in if hf_dn_occ_in is not None
                         else hf_up_occ_in)
    return FermionSystem(
        name="chem", norb=table.norb, nup=info["nup"], ndn=info["ndn"],
        table=table, heatbath=build_heatbath(table) if with_heatbath else None,
        orb_sym_arr=torch.as_tensor(table.orb_sym.astype(np.int32),
                                    device=device),
        has_singles=True, hf_up=dets.det_from_orbs(hf_up_occ, table.norb),
        hf_dn=dets.det_from_orbs(hf_dn_occ, table.norb),
        extra=dict(info=info))
