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
    time_sym: bool = False          # time-reversal symmetrized basis
    z: int = 1                      # its sector: +1 or -1

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
                     z: int = 1, point_group: str | None = None,
                     hf_symmetry: int | None = None, hf_up_occ_in=None,
                     hf_dn_occ_in=None, device="cuda") -> FermionSystem:
    """Molecular system from an FCIDUMP (ref workload: chemistry.f90), on
    `device`.

    hf_up_occ_in / hf_dn_occ_in: explicit starting-det occupations in
    1-based ORIGINAL orbital labels (the reference's ``&hf_det``
    namelist), mapped through the reordering.  point_group: the abelian
    group of the FCIDUMP's irrep labels.  hf_symmetry: re-pick the start
    as the lowest-diagonal det of that spatial irrep within CISD of the
    aufbau det (ref: auto_assign_hci0_occs / find_lowest_energy_det_in_cisd,
    chemistry.f90:10359,10457; needs point_group).  time_sym: walk and
    diagonalize in the time-reversal symmetrized basis of sector z; the
    start is stored in its representative orientation, and z < 0 needs an
    open-shell start."""
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
    system = FermionSystem(
        name="chem", norb=table.norb, nup=info["nup"], ndn=info["ndn"],
        table=table, heatbath=build_heatbath(table) if with_heatbath else None,
        orb_sym_arr=torch.as_tensor(table.orb_sym.astype(np.int32),
                                    device=device),
        has_singles=True, hf_up=dets.det_from_orbs(hf_up_occ, table.norb),
        hf_dn=dets.det_from_orbs(hf_dn_occ, table.norb),
        extra=dict(info=info), time_sym=time_sym, z=z)
    if point_group is not None:
        from .chem.pointgroup import PointGroup
        system.extra["point_group"] = PointGroup(point_group, table.orb_sym)
    if hf_symmetry is not None:
        assign_hf_by_symmetry(system, hf_symmetry)
    if time_sym:
        if z < 0 and np.array_equal(system.hf_up, system.hf_dn):
            raise ValueError(
                "triplet (z=-1) run starting from a self-symmetric det; "
                "specify hf_symmetry to pick an open-shell start "
                "(ref: chemistry.f90 singlet/triplet error)")
        # representative orientation: (up, dn) <= (dn, up) in the unsigned
        # det order
        from ..ops import setalg
        u = torch.as_tensor(system.hf_up[None])
        d = torch.as_tensor(system.hf_dn[None])
        if bool(setalg.keys_less(d, u, u, d)[0]):
            system.hf_up, system.hf_dn = system.hf_dn, system.hf_up
    return system


def _cisd_candidates(occ_u, occ_d, norb: int):
    """The aufbau det and every single and double excitation of it,
    regardless of symmetry, in the JAX package's order (so the
    lowest-diagonal choice breaks ties the same way)."""
    from itertools import combinations

    virt_u = [o for o in range(norb) if o not in occ_u]
    virt_d = [o for o in range(norb) if o not in occ_d]
    su, sd = set(occ_u), set(occ_d)
    cands = [(tuple(occ_u), tuple(occ_d))]
    for p in occ_u:
        for r in virt_u:
            cands.append((tuple(sorted(su - {p} | {r})), tuple(occ_d)))
    for p in occ_d:
        for r in virt_d:
            cands.append((tuple(occ_u), tuple(sorted(sd - {p} | {r}))))
    for p, q in combinations(occ_u, 2):
        for r, s in combinations(virt_u, 2):
            cands.append((tuple(sorted(su - {p, q} | {r, s})), tuple(occ_d)))
    for p, q in combinations(occ_d, 2):
        for r, s in combinations(virt_d, 2):
            cands.append((tuple(occ_u), tuple(sorted(sd - {p, q} | {r, s}))))
    for p in occ_u:
        for r in virt_u:
            u1 = tuple(sorted(su - {p} | {r}))
            for q in occ_d:
                for s in virt_d:
                    cands.append((u1, tuple(sorted(sd - {q} | {s}))))
    bits_u = np.zeros((len(cands), norb), np.uint8)
    bits_d = np.zeros((len(cands), norb), np.uint8)
    for k, (u, d) in enumerate(cands):
        bits_u[k, list(u)] = 1
        bits_d[k, list(d)] = 1
    return bits_u, bits_d


def assign_hf_by_symmetry(system: FermionSystem, hf_symmetry: int):
    """Replace the starting det by the lowest-diagonal det of spatial irrep
    `hf_symmetry` within CISD of the aufbau det.  The candidates' diagonal
    elements are one batched evaluation on the system's device."""
    from .chem import slater

    pg = system.extra.get("point_group")
    if pg is None:
        raise ValueError("assign_hf_by_symmetry needs a point_group")
    norb = system.norb
    bits_u, bits_d = _cisd_candidates(dets.orbs_from_det(system.hf_up, norb),
                                      dets.orbs_from_det(system.hf_dn, norb),
                                      norb)
    dev = system.device
    bu = torch.as_tensor(bits_u, device=dev)
    bd = torch.as_tensor(bits_d, device=dev)
    diag = slater.diag_elements(system.table, bu, bd).cpu().numpy()
    # spatial irrep: the product over singly occupied orbitals
    sym_of = np.asarray(pg.orb_sym)
    syms = np.ones(len(bits_u), dtype=np.int64)
    single = (bits_u.astype(np.int64) + bits_d) % 2 == 1
    for o in range(norb):
        syms = np.where(single[:, o], pg.product(syms, sym_of[o]), syms)
    ok = syms == hf_symmetry
    if not ok.any():
        raise ValueError(f"no CISD det with symmetry {hf_symmetry}")
    best = int(np.argmin(np.where(ok, diag, np.inf)))
    words = dets.from_bits(torch.as_tensor(np.stack([bits_u[best],
                                                     bits_d[best]])), norb)
    system.hf_up = words[0].numpy()
    system.hf_dn = words[1].numpy()
