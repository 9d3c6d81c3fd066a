"""Heat-bath double-excitation tables (port of sqmc_tpu/systems/heatbath.py;
ref: chemistry.f90 setup_efficient_heatbath:872).

For every occupied orbital pair, the target pairs sorted by |H| descending,
so an eps cut is a prefix; stored as flat ragged arrays plus row offsets.

Row conventions (0-based spatial orbitals):
  * same-spin rows, one per p<q, row q*(q-1)//2 + p: entries r<s with
    |H| = |(pr|qs)-(ps|qr)| > 0;
  * opposite-spin rows, one per a<=b, row b*(b+1)//2 + a, meaning
    a(up)->r, b(dn)->s; a query with p_up > q_dn uses row (q_dn, p_up) and
    swaps the (r,s) meaning (ref: chemistry.f90:7038-7058).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .chem.integrals import IntegralTable


def tri_lt(p, q):
    """Row index for unordered p<q (strict)."""
    return q * (q - 1) // 2 + p


def tri_le(a, b):
    """Row index for unordered a<=b."""
    return b * (b + 1) // 2 + a


@dataclasses.dataclass
class HeatbathTable:
    """Flat ragged heat-bath tables.

    same_rs / opp_rs: int32 [total], packed r*norb+s target pairs
    same_val / opp_val: float64 [total], signed no-reference elements,
      |value|-descending within each row
    same_start / opp_start: int64 [n_rows]; same_count / opp_count: int32
    max_double: largest |H| over all rows; max_count: longest row
    """

    norb: int
    same_rs: torch.Tensor
    same_val: torch.Tensor
    same_start: torch.Tensor
    same_count: torch.Tensor
    opp_rs: torch.Tensor
    opp_val: torch.Tensor
    opp_start: torch.Tensor
    opp_count: torch.Tensor
    max_double: float
    max_count: int = 0


def heatbath_from_arrays(norb, same_rs, same_val, same_start, same_count,
                         opp_rs, opp_val, opp_start, opp_count, max_double,
                         device="cuda") -> HeatbathTable:
    """HeatbathTable from the flat numpy arrays (typed as documented)."""
    def t(x, dt):
        return torch.as_tensor(np.asarray(x).astype(dt), device=device)
    same_count = np.asarray(same_count)
    opp_count = np.asarray(opp_count)
    return HeatbathTable(
        norb=norb,
        same_rs=t(same_rs, np.int32), same_val=t(same_val, np.float64),
        same_start=t(same_start, np.int64), same_count=t(same_count, np.int32),
        opp_rs=t(opp_rs, np.int32), opp_val=t(opp_val, np.float64),
        opp_start=t(opp_start, np.int64), opp_count=t(opp_count, np.int32),
        max_double=float(max_double),
        max_count=int(max(same_count.max(initial=0), opp_count.max(initial=0))))


def build_heatbath(table: IntegralTable) -> HeatbathTable:
    """Host-side construction (once per system), vectorized numpy; the
    same arrays, in the same order, as sqmc_tpu.systems.heatbath."""
    norb = table.norb
    eri_v = table.eri_value_np
    rr, ss = np.meshgrid(np.arange(norb), np.arange(norb), indexing="ij")

    max_double = 0.0
    same_rs, same_h, same_counts = [], [], []
    tri_mask = rr < ss
    for q in range(norb):
        for p in range(q):
            H = eri_v(p, rr, q, ss) - eri_v(p, ss, q, rr)
            H = np.where(tri_mask, H, 0.0)
            for o in (p, q):     # targets must avoid the source pair
                H[o, :] = 0.0
                H[:, o] = 0.0
            r_i, s_i = np.nonzero(H != 0)
            h = H[r_i, s_i]
            order = np.argsort(-np.abs(h), kind="stable")
            same_rs.append((r_i * norb + s_i)[order].astype(np.int32))
            same_h.append(h[order])
            same_counts.append(len(h))
            if len(h):
                max_double = max(max_double, abs(h[order[0]]))

    opp_rs, opp_h, opp_counts = [], [], []
    for b in range(norb):
        for a in range(b + 1):
            H = eri_v(a, rr, b, ss).astype(np.float64).copy()
            H[a, :] = 0.0        # r == a: no up excitation
            H[:, b] = 0.0        # s == b: no dn excitation
            r_i, s_i = np.nonzero(H != 0)
            h = H[r_i, s_i]
            order = np.argsort(-np.abs(h), kind="stable")
            opp_rs.append((r_i * norb + s_i)[order].astype(np.int32))
            opp_h.append(h[order])
            opp_counts.append(len(h))
            if len(h):
                max_double = max(max_double, abs(h[order[0]]))

    def flat(rows_rs, rows_h, counts):
        counts = np.asarray(counts, dtype=np.int64)
        start = np.zeros(len(counts), dtype=np.int64)
        if len(counts) > 1:
            start[1:] = np.cumsum(counts[:-1])
        rs = np.concatenate(rows_rs) if rows_rs else np.zeros(0, np.int32)
        h = np.concatenate(rows_h) if rows_h else np.zeros(0, np.float64)
        if len(rs) == 0:     # keep flat arrays non-empty so gathers stay legal
            rs = np.zeros(1, np.int32)
            h = np.zeros(1, np.float64)
        return rs, h, start, counts

    s = flat(same_rs, same_h, same_counts)
    o = flat(opp_rs, opp_h, opp_counts)
    return heatbath_from_arrays(norb, *s, *o, max_double, device=table.device)


def rank_of_eps(val_flat: torch.Tensor, start: torch.Tensor,
                count: torch.Tensor, eps: torch.Tensor,
                n_iter: int) -> torch.Tensor:
    """Number of leading entries of each |value|-descending row with
    |H| > eps (the doubles scan exits at |H| <= eps, ref
    chemistry.f90:7040), by vectorized bisection; n_iter must cover the
    longest row (bit_length(max_count) + 1).  int64 [...]."""
    nflat = val_flat.shape[0]
    lo = torch.zeros_like(count, dtype=torch.int64)
    hi = count.to(torch.int64)
    for _ in range(n_iter):
        mid = (lo + hi) // 2
        v = val_flat[(start + mid).clamp(0, nflat - 1)].abs()
        take = (v > eps) & (lo < hi)
        lo = torch.where(take, mid + 1, lo)
        hi = torch.where(take, hi, mid)
    return lo
