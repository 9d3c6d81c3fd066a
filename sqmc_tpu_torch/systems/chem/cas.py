"""Frozen-core CAS extraction (port of sqmc_tpu/systems/chem/cas.py): fold
core orbitals into effective integrals and write a standalone FCIDUMP for
the active space, whose full det space a dense eigensolver can take (an
exact anchor for HCI + PT and the walk).

The closed-shell frozen-core fold, with c over doubly occupied frozen
orbitals and p, q over the active window:

  E_core   = E_nuc + 2 sum_c h_cc + sum_{c,c'} [2 (cc|c'c') - (cc'|c'c)]
  h_eff_pq = h_pq + sum_c [2 (pq|cc) - (pc|cq)]

Two-body integrals restrict unchanged to the window.  The integrals are
small host arrays (numpy), as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from .fcidump import read_fcidump, reorder_orbitals, write_fcidump
from .integrals import pair_index, quad_index


def frozen_core_arrays(h: np.ndarray, eri: np.ndarray, core_energy: float,
                       core, act):
    """(h_eff [na, na], eri_act compact 8-fold, e_core) for the given
    frozen / active orbital index lists (labels into h / eri)."""
    core = np.asarray(core, np.int64)
    act = np.asarray(act, np.int64)

    def v(p, q, r, s):
        return eri[quad_index(pair_index(p, q), pair_index(r, s))]

    e_core = float(core_energy) + 2.0 * float(np.sum(h[core, core]))
    C1, C2 = np.meshgrid(core, core, indexing="ij")
    e_core += float(np.sum(2.0 * v(C1, C1, C2, C2) - v(C1, C2, C2, C1)))

    na = len(act)
    P, Q = np.meshgrid(act, act, indexing="ij")
    h_eff = h[np.ix_(act, act)].copy()
    for c in core:
        h_eff += 2.0 * v(P, Q, c, c) - v(P, c, c, Q)

    # compact active-space pair k <-> (hi, lo); quad k <-> (pair a, pair b)
    npair = na * (na + 1) // 2
    hi, lo = np.tril_indices(na)
    pair_hi = np.empty(npair, np.int64)
    pair_lo = np.empty(npair, np.int64)
    pair_hi[pair_index(hi, lo)] = hi
    pair_lo[pair_index(hi, lo)] = lo
    qa, qb = np.tril_indices(npair)
    qorder = quad_index(qa, qb)
    quad_a = np.empty_like(qorder)
    quad_b = np.empty_like(qorder)
    quad_a[qorder] = qa
    quad_b[qorder] = qb
    old_pair = pair_index(act[pair_hi], act[pair_lo])
    eri_act = eri[quad_index(old_pair[quad_a], old_pair[quad_b])]
    return h_eff, eri_act, e_core


def write_cas_fcidump(src_path: str, n_core: int, n_act: int,
                      out_path: str) -> dict:
    """Read src_path, reorder its orbitals as the loader does (HF-occupied
    first, then by estimated orbital energy; chemistry.f90:8921), freeze
    the first n_core, keep the next n_act, and write a standalone FCIDUMP
    (the JAX package's lines, byte for byte).

    Every frozen orbital must be occupied in both the up and the dn HF
    det: a singly occupied or empty one cannot be folded as a closed
    shell, and the JAX package checks only the count (ROADMAP C6).

    Returns dict(nelec, norb, e_core, core_labels, act_labels, hf_up,
    hf_dn), labels in the reordered basis (the one make_chem_system(src)
    uses)."""
    data = read_fcidump(src_path)
    nup = (data.nelec + data.ms2) // 2
    ndn = data.nelec - nup
    hf_up = data.hf_up_orbs if data.hf_up_orbs is not None else np.arange(nup)
    hf_dn = data.hf_dn_orbs if data.hf_dn_orbs is not None else np.arange(ndn)
    _, h2, eri2, sym2, hf_up2, hf_dn2, _ = reorder_orbitals(data, hf_up, hf_dn)
    if n_core + n_act > data.norb:
        raise ValueError(f"n_core + n_act = {n_core + n_act} exceeds norb "
                         f"{data.norb}")
    core = np.arange(n_core)
    act = np.arange(n_core, n_core + n_act)
    closed = np.intersect1d(hf_up2, hf_dn2)
    open_core = np.setdiff1d(core, closed)
    if len(open_core):
        raise ValueError(f"frozen core orbitals {open_core.tolist()} are not "
                         "doubly occupied in the HF det (up "
                         f"{np.sort(hf_up2).tolist()}, dn "
                         f"{np.sort(hf_dn2).tolist()})")
    h_eff, eri_act, e_core = frozen_core_arrays(h2, eri2, data.core_energy,
                                                core, act)
    nelec = data.nelec - 2 * n_core
    write_fcidump(out_path, h_eff, eri_act, e_core, np.asarray(sym2)[act],
                  nelec=nelec, ms2=data.ms2)
    return dict(nelec=nelec, norb=n_act, e_core=e_core, core_labels=core,
                act_labels=act, hf_up=hf_up2, hf_dn=hf_dn2)
