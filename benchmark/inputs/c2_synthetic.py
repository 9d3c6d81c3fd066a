"""The synthetic FCIDUMP at C2 CAS(8e,26o)'s shape, frozen in the benchmark.

A copy of the writer the program's repository keeps for the same file, so
that a later change there cannot move the benchmark's input: 26 orbitals
with the C2_v2z_curve decks' d2h irreps, 8 electrons (MS2 0), integrals
drawn from a seed.  Every integral whose irrep product is not totally
symmetric is zero; the diagonal h ascends (4 occupied orbitals in
[-2.5, -0.8], 22 virtual in [0, 3]); direct integrals (ii|jj) in
[0.4, 0.5]; every other one- and two-body integral normal with standard
deviation `scale`.  The file's lines and order are those of a Molpro
FCIDUMP writer: the unique two-body entries (pq) >= (rs), p >= q, r >= s,
then h_pq for p >= q, then the core energy.
"""

from __future__ import annotations

import numpy as np

# the C2_v2z_curve decks' orbital irreps (d2h labels 1..8)
C2_SYMS = [1, 5, 3, 2, 1, 7, 6, 5, 1, 2, 3, 1, 6, 7, 5, 4, 1, 5, 3, 2, 8, 5,
           1, 7, 6, 5]


def pair_index(a, b):
    """Compact symmetric pair index: max*(max+1)//2 + min."""
    hi, lo = np.maximum(a, b), np.minimum(a, b)
    return hi * (hi + 1) // 2 + lo


quad_index = pair_index


def n_eri(norb: int) -> int:
    npair = norb * (norb + 1) // 2
    return npair * (npair + 1) // 2


def _sym_mask(syms, norb):
    s0 = np.asarray(syms) - 1
    npair = norb * (norb + 1) // 2
    hi, lo = np.tril_indices(norb)
    ph, pl = np.empty(npair, int), np.empty(npair, int)
    ph[pair_index(hi, lo)], pl[pair_index(hi, lo)] = hi, lo
    qa, qb = np.tril_indices(npair)
    bad = np.zeros(npair * (npair + 1) // 2, bool)
    bad[quad_index(qa, qb)] = (s0[ph[qa]] ^ s0[pl[qa]] ^ s0[ph[qb]]
                               ^ s0[pl[qb]]) != 0
    return bad


def integrals(syms=C2_SYMS, scale=0.02, seed=26):
    """(h, compact eri) of the synthetic file."""
    rng = np.random.default_rng(seed)
    norb = len(syms)
    s0 = np.asarray(syms) - 1
    h = rng.normal(size=(norb, norb)) * scale
    h = 0.5 * (h + h.T)
    h[s0[:, None] != s0[None, :]] = 0.0
    h[np.diag_indices(norb)] = np.sort(np.concatenate(
        [rng.uniform(-2.5, -0.8, 4), rng.uniform(0.0, 3.0, norb - 4)]))
    eri = rng.normal(size=n_eri(norb)) * scale
    eri[_sym_mask(syms, norb)] = 0.0
    d = pair_index(np.arange(norb), np.arange(norb))
    J = 0.4 + 0.1 * rng.random((norb, norb))
    eri[quad_index(d[:, None], d[None, :])] = 0.5 * (J + J.T)
    return h, eri


def write(path, syms=C2_SYMS, scale=0.02, seed=26, core=-75.0, nelec=8,
          ms2=0, thresh=1e-12):
    """Write the file to `path`."""
    h, eri = integrals(syms, scale, seed)
    norb = h.shape[0]
    g = np.indices((norb,) * 4).reshape(4, -1)
    p, q, r, s = g
    keep = (q <= p) & (r <= p) & (s <= np.where(r == p, q, r))
    p, q, r, s = p[keep], q[keep], r[keep], s[keep]
    v = eri[quad_index(pair_index(p, q), pair_index(r, s))]
    nz = np.abs(v) > thresh
    lines = [f" &FCI NORB={norb},NELEC={nelec},MS2={ms2},\n",
             "  ORBSYM=" + ",".join(str(int(x)) for x in syms) + ",\n",
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
