"""FCIDUMP reader and HF-aware orbital reordering (port of
sqmc_tpu/systems/chem/fcidump.py, numpy parse path; ref: chemistry.f90
read_integrals:538-872, sort_integrals:8921, compute_orbital_energies:9155).

Integrals are read into the 8-fold compact array; orbitals are reordered
with the HF-occupied ones first, then by ascending estimated orbital
energy, and the HF determinant is re-expressed in the new labels, so it
occupies the lowest nup / ndn orbitals.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from .integrals import IntegralTable, pair_index, quad_index


def n_eri(norb: int) -> int:
    npair = norb * (norb + 1) // 2
    return npair * (npair + 1) // 2


@dataclasses.dataclass
class FCIDumpData:
    norb: int
    nelec: int
    ms2: int
    orb_sym: np.ndarray            # int32 [norb], 1-based irrep labels
    h: np.ndarray                  # float64 [norb, norb]
    eri: np.ndarray                # float64 compact 8-fold
    core_energy: float
    hf_up_orbs: np.ndarray | None  # optional 0-based occupations from header
    hf_dn_orbs: np.ndarray | None


def read_fcidump(path: str) -> FCIDumpData:
    """Parse a Molpro-format FCIDUMP.

    Header: &FCI NORB=..,NELEC=..,MS2=.., ORBSYM=..., ISYM=.., optional
    ``hf_up`` / ``hf_dn`` occupation lines, &END (or /).  Body lines:
    value p q r s (1-based); p q 0 0 is h_pq, 0 0 0 0 the core energy.
    Entries with |value| <= 1e-9 do not overwrite, as in the reference
    (chemistry.f90:683)."""
    with open(path) as f:
        text = f.read()
    m = re.search(r"&FCI(.*?)(?:&END|/)", text, re.S | re.I)
    if not m:
        raise ValueError(f"no &FCI header in {path}")
    header = m.group(1)

    def _get_int(name, default=None):
        mm = re.search(rf"{name}\s*=\s*(\d+)", header, re.I)
        if mm:
            return int(mm.group(1))
        if default is None:
            raise ValueError(f"missing {name} in FCIDUMP header")
        return default

    norb = _get_int("NORB")
    nelec = _get_int("NELEC")
    ms2 = _get_int("MS2", 0)
    mm = re.search(r"ORBSYM\s*=\s*([\d,\s]+)", header, re.I)
    orb_sym = (np.array([int(x) for x in mm.group(1).replace(",", " ").split()][:norb],
                        dtype=np.int32) if mm else np.ones(norb, dtype=np.int32))

    def _occ(tag):
        mm = re.search(rf"^\s*([\d\s]+?)\s*{tag}", header, re.M)
        return (np.array([int(x) - 1 for x in mm.group(1).split()], np.int32)
                if mm else None)

    toks = text[m.end():].split()
    vals = np.array(toks[0::5], dtype=np.float64)
    p, q, r, s = (np.array(toks[k::5], dtype=np.int64) for k in range(1, 5))

    h = np.zeros((norb, norb), dtype=np.float64)
    eri = np.zeros(n_eri(norb), dtype=np.float64)
    core = 0.0
    two = (p > 0) & (q > 0) & (r > 0) & (s > 0)
    one = (p > 0) & (q > 0) & ~two
    for v in vals[(p == 0) & (q == 0) & (r == 0) & (s == 0)]:
        core = float(v)
    hp, hq, hv = p[one] - 1, q[one] - 1, vals[one]
    keep = np.abs(hv) > 1e-9
    h[hp[keep], hq[keep]] = hv[keep]
    h[hq[keep], hp[keep]] = hv[keep]
    idx = quad_index(pair_index(p[two] - 1, q[two] - 1),
                     pair_index(r[two] - 1, s[two] - 1))
    tv = vals[two]
    keep = np.abs(tv) > 1e-9
    eri[idx[keep]] = tv[keep]
    return FCIDumpData(norb=norb, nelec=nelec, ms2=ms2, orb_sym=orb_sym, h=h,
                       eri=eri, core_energy=core, hf_up_orbs=_occ("hf_up"),
                       hf_dn_orbs=_occ("hf_dn"))


def write_fcidump(path: str, h: np.ndarray, eri_compact: np.ndarray,
                  core: float, orb_sym, nelec: int, ms2: int = 0,
                  thresh: float = 1e-12):
    """Write a Molpro-format FCIDUMP with the lines and order of the JAX
    package's writer (sqmc_tpu/algo/rdm.py write_fcidump): the unique
    two-body entries (pq) >= (rs), p >= q, r >= s in (p, q, r, s) order,
    then h_pq for p >= q, then the core energy; entries with |value| <=
    thresh are left out."""
    norb = h.shape[0]
    g = np.indices((norb,) * 4).reshape(4, -1)
    p, q, r, s = g
    keep = (q <= p) & (r <= p) & (s <= np.where(r == p, q, r))
    p, q, r, s = p[keep], q[keep], r[keep], s[keep]
    v = eri_compact[quad_index(pair_index(p, q), pair_index(r, s))]
    nz = np.abs(v) > thresh
    lines = [f" &FCI NORB={norb},NELEC={nelec},MS2={ms2},\n",
             "  ORBSYM=" + ",".join(str(int(x)) for x in orb_sym) + ",\n",
             "  ISYM=1,\n &END\n"]
    lines += [f"{a:23.16e} {b + 1:3d} {c + 1:3d} {d + 1:3d} {e + 1:3d}\n"
              for a, b, c, d, e in zip(v[nz], p[nz], q[nz], r[nz], s[nz])]
    hp, hq = np.tril_indices(norb)
    hv = h[hp, hq]
    nz = np.abs(hv) > thresh
    lines += [f"{a:23.16e} {b + 1:3d} {c + 1:3d}   0   0\n"
              for a, b, c in zip(hv[nz], hp[nz], hq[nz])]
    lines.append(f"{core:23.16e}   0   0   0   0\n")
    with open(path, "w") as f:
        f.writelines(lines)


def orbital_energies(h: np.ndarray, eri: np.ndarray, hf_up_occ,
                     hf_dn_occ) -> np.ndarray:
    """The reference's estimated orbital energies (chemistry.f90:9155):
    e_i = h_ii + (exchange_i + direct_i) / 2, where the same-spin sums
    skip j == i and the cross-spin direct sums include it."""
    norb = h.shape[0]
    pidx = np.arange(norb)
    diag_pair = pair_index(pidx, pidx)
    D = eri[quad_index(diag_pair[:, None], diag_pair[None, :])]
    pq = pair_index(pidx[:, None], pidx[None, :])
    X = eri[quad_index(pq, pq)]
    up_occ = np.zeros(norb)
    up_occ[hf_up_occ] = 1.0
    dn_occ = np.zeros(norb)
    dn_occ[hf_dn_occ] = 1.0
    e = np.diag(h).copy()
    for i in range(norb):
        exch = -(np.dot(X[i], up_occ) - X[i, i] * up_occ[i]) \
               - (np.dot(X[i], dn_occ) - X[i, i] * dn_occ[i])
        dir_ = (np.dot(D[i], up_occ) - D[i, i] * up_occ[i]) \
            + np.dot(D[i], dn_occ) \
            + (np.dot(D[i], dn_occ) - D[i, i] * dn_occ[i]) \
            + np.dot(D[i], up_occ)
        e[i] += 0.5 * (exch + dir_)
    return e


def reorder_orbitals(data: FCIDumpData, hf_up_occ, hf_dn_occ):
    """HF-occupied orbitals first, then ascending estimated orbital
    energy, stable in the original label (sort_integrals,
    chemistry.f90:8921).  Returns (perm, h2, eri2, orb_sym2, new_hf_up,
    new_hf_dn, orb_e) with perm[new] = old label."""
    norb = data.norb
    orb_e = orbital_energies(data.h, data.eri, hf_up_occ, hf_dn_occ)
    keyed = orb_e.copy()
    keyed[hf_up_occ] -= 1e9
    keyed[np.asarray(hf_dn_occ)] -= 1e9
    perm = np.argsort(keyed, kind="stable")
    inv = np.empty(norb, dtype=np.int64)
    inv[perm] = np.arange(norb)
    h2 = data.h[np.ix_(perm, perm)]
    # compact pair k <-> (hi, lo); new pair k reads old pair (perm[hi], perm[lo])
    npair = norb * (norb + 1) // 2
    hi, lo = np.tril_indices(norb)
    order = pair_index(hi, lo)
    pair_hi = np.empty(npair, dtype=np.int64)
    pair_lo = np.empty(npair, dtype=np.int64)
    pair_hi[order] = hi
    pair_lo[order] = lo
    old_pair = pair_index(perm[pair_hi], perm[pair_lo])
    qa, qb = np.tril_indices(npair)
    qorder = quad_index(qa, qb)
    quad_a = np.empty_like(qorder)
    quad_b = np.empty_like(qorder)
    quad_a[qorder] = qa
    quad_b[qorder] = qb
    eri2 = data.eri[quad_index(old_pair[quad_a], old_pair[quad_b])]
    return (perm, h2, eri2, data.orb_sym[perm], np.sort(inv[hf_up_occ]),
            np.sort(inv[np.asarray(hf_dn_occ)]), orb_e)


def load_fcidump_system(path: str, nup: int | None = None,
                        ndn: int | None = None, reorder: bool = True,
                        device="cuda"):
    """Read an FCIDUMP: (IntegralTable on `device`, hf_up_occ, hf_dn_occ,
    info).  HF occupations default to the first nup / ndn orbitals, or
    the header's hf_up / hf_dn lines; reordering then puts them first."""
    data = read_fcidump(path)
    nelec = data.nelec
    if nup is None:
        nup = (nelec + data.ms2) // 2
    if ndn is None:
        ndn = nelec - nup
    hf_up = data.hf_up_orbs if data.hf_up_orbs is not None else np.arange(nup)
    hf_dn = data.hf_dn_orbs if data.hf_dn_orbs is not None else np.arange(ndn)
    if reorder:
        perm, h2, eri2, sym2, hf_up, hf_dn, orb_e = reorder_orbitals(
            data, hf_up, hf_dn)
    else:
        perm = np.arange(data.norb)
        h2, eri2, sym2 = data.h, data.eri, data.orb_sym
        orb_e = orbital_energies(data.h, data.eri, hf_up, hf_dn)
    table = IntegralTable.from_dense_arrays(h2, eri2, data.core_energy, sym2,
                                            device=device)
    info = dict(perm=perm, nelec=nelec, nup=nup, ndn=ndn, ms2=data.ms2,
                orb_energies=orb_e)
    return table, np.asarray(hf_up), np.asarray(hf_dn), info
