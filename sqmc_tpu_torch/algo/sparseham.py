"""Sparse variational Hamiltonian by sort-join (port of
sqmc_tpu/algo/sparseham.py; ref: chemistry.f90
generate_sparse_ham_chem_upper_triangular:7639, get_n_minus_1_configs:9819).

Every determinant emits removal keys; pairs sharing a key differ by at
most a double excitation and are found by sorting the keys and pairing
within equal-key groups:
  F2: (up minus 2 occupied, dn), F4: (up, dn minus 2 occupied),
  F5: (up minus 1, dn minus 1).
Pairs among old determinants are remapped from the previous COO; only
pairs touching new determinants are joined and evaluated.  Runs on the
device of the det tensors.  In the time-reversal symmetrized basis the
dets are representatives, pairs are found by joining the doubled list
[dets; reversed] and elements use the symmetrized formula
(``slater.pair_matrix_elements_time_sym``).
"""

from __future__ import annotations

import dataclasses
from itertools import combinations

import torch

from .. import dets as dets_mod
from ..ops import setalg
from ..systems.chem import slater


@dataclasses.dataclass
class SparseHam:
    """Symmetric COO: strictly-upper entries (rows < cols, int64), float64
    values, and the float64 diagonal [n]; sorted by (row, col)."""
    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    diag: torch.Tensor

    def dense(self) -> torch.Tensor:
        """The full symmetric matrix (for small checks)."""
        M = torch.zeros((self.n, self.n), dtype=torch.float64,
                        device=self.vals.device)
        M[self.rows, self.cols] = self.vals
        return M + M.T + torch.diag(self.diag)


def _emit_group_pairs(sort_idx, group_id, new_start: int):
    """All unordered pairs within equal-key groups, keeping pairs that
    touch a det with index >= new_start; returns (lo, hi) index tensors."""
    n = len(sort_idx)
    dev = sort_idx.device
    empty = (torch.zeros(0, dtype=torch.int64, device=dev),) * 2
    if n == 0:
        return empty
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = group_id[1:] != group_id[:-1]
    group_start = torch.cummax(torch.where(first, ar, 0), 0).values
    counts = ar - group_start                   # rank within group
    offs = torch.cumsum(counts, 0)
    total = int(offs[-1])
    if total == 0:
        return empty
    tt = torch.arange(total, dtype=torch.int64, device=dev)
    t = torch.searchsorted(offs, tt, right=True)
    partner = group_start[t] + (tt - (offs[t] - counts[t]))
    a = sort_idx[t]
    b = sort_idx[partner]
    keep = (a >= new_start) | (b >= new_start)
    a, b = a[keep], b[keep]
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    keep2 = lo != hi
    return lo[keep2], hi[keep2]


def connected_pairs(up, dn, nup: int, ndn: int, norb: int,
                    new_start: int = 0):
    """All det-index pairs (i<j) within two excitations, deduped, touching
    at least one det with index >= new_start, sorted by (i, j)."""
    n = len(up)
    dev = up.device
    occ_up = dets_mod.occ_orbitals(dets_mod.to_bits(up, norb), nup)
    occ_dn = dets_mod.occ_orbitals(dets_mod.to_bits(dn, norb), ndn)
    det_idx = torch.arange(n, dtype=torch.int64, device=dev)
    pairs = []

    def join(key_up, key_dn, idx):
        order = setalg.lexsort_dets(key_up, key_dn)
        ku, kd, ix = key_up[order], key_dn[order], idx[order]
        gid = torch.cumsum((~setalg.dets_equal_adjacent(ku, kd)).to(torch.int64), 0)
        a, b = _emit_group_pairs(ix, gid, new_start)
        if len(a):
            pairs.append((a, b))

    # keys of different removal choices can match, so each family pools
    # all its removal choices into one join
    sets = []
    ku = [dets_mod.clear_orb(dets_mod.clear_orb(up, occ_up[:, c1]),
                              occ_up[:, c2])
          for c1, c2 in combinations(range(nup), 2)]
    sets.append((ku, [dn] * len(ku)))
    kd = [dets_mod.clear_orb(dets_mod.clear_orb(dn, occ_dn[:, c1]),
                              occ_dn[:, c2])
          for c1, c2 in combinations(range(ndn), 2)]
    sets.append(([up] * len(kd), kd))
    ku5, kd5 = [], []
    for c1 in range(nup):
        k1 = dets_mod.clear_orb(up, occ_up[:, c1])
        for c2 in range(ndn):
            ku5.append(k1)
            kd5.append(dets_mod.clear_orb(dn, occ_dn[:, c2]))
    sets.append((ku5, kd5))
    # fallback families when a spin channel has < 2 electrons
    if nup == 1 or ndn == 0:
        ku = [dets_mod.clear_orb(up, occ_up[:, c1]) for c1 in range(nup)]
        sets.append((ku, [dn] * len(ku)))
    if ndn == 1 or nup == 0:
        kd = [dets_mod.clear_orb(dn, occ_dn[:, c2]) for c2 in range(ndn)]
        sets.append(([up] * len(kd), kd))
    for ku_l, kd_l in sets:
        if ku_l:
            join(torch.cat(ku_l), torch.cat(kd_l), det_idx.repeat(len(ku_l)))

    if not pairs:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z.clone()
    a = torch.cat([p[0] for p in pairs])
    b = torch.cat([p[1] for p in pairs])
    key = torch.unique(a * n + b)
    return key // n, key % n


def eval_pairs(table, up, dn, a, b, norb: int, batch: int = 1 << 20,
               time_sym: bool = False, z: int = 1):
    """Signed H elements for det pairs (a, b): pairs are split by
    excitation class and each class runs its word-level kernel; the
    time-symmetrized basis uses the generic symmetrized element."""
    if time_sym:
        out = torch.empty(len(a), dtype=torch.float64, device=up.device)
        bs = batch // 4      # two generic elements a pair on full bit rows
        for beg in range(0, len(a), bs):
            ia, ib = a[beg:beg + bs], b[beg:beg + bs]
            out[beg:beg + bs] = slater.pair_matrix_elements_time_sym(
                table, dets_mod.to_bits(up[ia], norb),
                dets_mod.to_bits(dn[ia], norb), dets_mod.to_bits(up[ib], norb),
                dets_mod.to_bits(dn[ib], norb), z)
        return out
    ui, uj, di, dj = up[a], up[b], dn[a], dn[b]
    n_up = dets_mod.popcount(ui & ~uj)
    n_dn = dets_mod.popcount(di & ~dj)
    out = torch.zeros(len(a), dtype=torch.float64, device=up.device)

    def run(mask, fn, *arrs):
        idx = torch.nonzero(mask).reshape(-1)
        for beg in range(0, len(idx), batch):
            sl = idx[beg:beg + batch]
            out[sl] = fn(table, *[x[sl] for x in arrs])

    run((n_up == 2) & (n_dn == 0), slater.same_spin_double_words, ui, uj)
    run((n_up == 0) & (n_dn == 2), slater.same_spin_double_words, di, dj)
    run((n_up == 1) & (n_dn == 1), slater.opp_spin_double_words, ui, uj, di, dj)

    def single(t, wi, wj, wo):
        return slater.single_words(t, wi, wj, wo, norb)

    run((n_up == 1) & (n_dn == 0), single, ui, uj, di)
    run((n_up == 0) & (n_dn == 1), single, di, dj, ui)
    return out


def diag_elements_batched(table, up, dn, norb: int, batch: int = 1 << 17):
    """Diagonal elements of a det list, float64 [n]."""
    out = torch.empty(len(up), dtype=torch.float64, device=up.device)
    for beg in range(0, len(up), batch):
        end = min(beg + batch, len(up))
        out[beg:end] = slater.diag_elements(
            table, dets_mod.to_bits(up[beg:end], norb),
            dets_mod.to_bits(dn[beg:end], norb))
    return out


def ts_diag_elements(table, up, dn, norb: int, z: int,
                     batch: int = 1 << 17) -> torch.Tensor:
    """Diagonal elements of time-symmetrized basis states, float64 [n]:
    the det diagonal plus z <i|H|rev i> for non-self-symmetric ones."""
    out = torch.empty(len(up), dtype=torch.float64, device=up.device)
    for beg in range(0, len(up), batch):
        end = min(beg + batch, len(up))
        bu = dets_mod.to_bits(up[beg:end], norb)
        bd = dets_mod.to_bits(dn[beg:end], norb)
        out[beg:end] = slater.pair_matrix_elements_time_sym(table, bu, bd,
                                                            bu, bd, z)
    return out


def build_sparse_ham(table, up, dn, nup: int, ndn: int, norb: int,
                     prev: SparseHam | None = None,
                     prev_map: torch.Tensor | None = None,
                     time_sym: bool = False, z: int = 1) -> SparseHam:
    """Full sparse H over a det list, with incremental reuse: prev is the
    SparseHam of a previous (smaller) list and prev_map [prev.n] maps its
    rows to rows of the current list.

    time_sym: the dets are time-reversal representatives; elements use
    the symmetrized formula, and pairs connected only through the
    reversed orientation are found by joining [dets; reversed]."""
    n = len(up)
    if time_sym:
        diag = ts_diag_elements(table, up, dn, norb, z)
    else:
        diag = diag_elements_batched(table, up, dn, norb)

    def find_pairs(u, d, new_start):
        if not time_sym:
            return connected_pairs(u, d, nup, ndn, norb, new_start=new_start)
        m = len(u)
        a2, b2 = connected_pairs(torch.cat([u, d]), torch.cat([d, u]), nup,
                                 ndn, norb, new_start=0)
        a, b = a2 % m, b2 % m
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        keep = (lo != hi) & ((lo >= new_start) | (hi >= new_start))
        key = torch.unique(lo[keep] * m + hi[keep])
        return key // m, key % m

    ts = dict(time_sym=time_sym, z=z)
    if prev is not None and prev_map is not None and prev.n > 0:
        is_old = torch.zeros(n, dtype=torch.bool, device=up.device)
        is_old[prev_map] = True
        old_rows = torch.nonzero(is_old).reshape(-1)
        new_rows = torch.nonzero(~is_old).reshape(-1)
        perm = torch.cat([old_rows, new_rows])     # position -> current row
        a_p, b_p = find_pairs(up[perm], dn[perm], len(old_rows))
        a, b = perm[a_p], perm[b_p]
        vals = eval_pairs(table, up, dn, a, b, norb, **ts)
        keep = vals != 0.0
        a, b, vals = a[keep], b[keep], vals[keep]
        pa, pb = prev_map[prev.rows], prev_map[prev.cols]
        rows = torch.cat([torch.minimum(pa, pb), a])
        cols = torch.cat([torch.maximum(pa, pb), b])
        v = torch.cat([prev.vals, vals])
    else:
        a, b = find_pairs(up, dn, 0)
        vals = eval_pairs(table, up, dn, a, b, norb, **ts)
        keep = vals != 0.0
        rows, cols, v = a[keep], b[keep], vals[keep]
    order = torch.argsort(rows * n + cols, stable=True)
    return SparseHam(n=n, rows=rows[order], cols=cols[order], vals=v[order],
                     diag=diag)
