"""Heat-bath pair (and single) selection of the walk's spawn slots, in
plain PyTorch.  The card runs this selection only inside the heat-bath
proposal kernel K3b (ops/hbspawn.py, csrc/hbselect.cu); here it serves
hbspawn's plain version.

Port of the selection rows of sqmc_tpu/algo/walk.py:1539-1631 (its row
cumsums are sqmc_tpu/ops/prefix.py `cumsum_rows`, triangular matmuls on
the TPU's MXU).  For each spawn slot's parent det, over its spin-orbitals
(up orbitals, then dn orbitals + norb):

  * with singles (``u_rowsum`` given): the occupied spin-orbital ``o_s``
    drawn from the cumulative row of ``u_rowsum[orb]`` at target
    ``u_pick * utot``, the row's total ``utot`` and the realized cell
    ``c_s`` (the probability the draw used, times ``utot``);
  * the first spin-orbital ``o1`` from the cumulative row of
    ``mu[a] = sum_occ_q R2[q, a]`` (total ``m_tot``, target ``u_pick *
    m_tot``), the second ``o2`` from the cumulative row of ``R2[o1]``
    (total ``s1q``, target ``u_entry * s1q``), the total ``s2q`` of the row
    of ``R2[o2]``, and ``p_pair_q``, the realized probability of the
    unordered pair summed over both orders, from the cells of those rows.

Draws count the cells <= target (capped at 2 norb - 1) and every
probability is a difference of the same running sums the draw compared
against (the exact S/diff correction of the spawn weight).

The uniform and Cauchy-Schwarz proposals draw from rows built here too
(:func:`singles_rows`, and the walk's pair rows), by :func:`flat_cumsum`:
plain torch, flat over zero weights by construction on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import dets

F32 = torch.float32
TINY = 1e-30


class Selection(NamedTuple):
    o1: torch.Tensor                 # [CAP] int64 first spin-orbital
    o2: torch.Tensor                 # [CAP] int64 second spin-orbital
    m_tot: torch.Tensor              # [CAP] f32 total of the mu row
    s1q: torch.Tensor                # [CAP] f32 total of R2[o1]'s row
    s2q: torch.Tensor                # [CAP] f32 total of R2[o2]'s row
    p_pair_q: torch.Tensor           # [CAP] f32 realized pair probability
    o_s: Optional[torch.Tensor]      # [CAP] int64 single's spin-orbital
    utot: Optional[torch.Tensor]     # [CAP] f32 total of the singles row
    c_s: Optional[torch.Tensor]      # [CAP] f32 realized singles cell


def count_le(rows: torch.Tensor, targ: torch.Tensor, top: int) -> torch.Tensor:
    """Index drawn from a cumulative row: #entries <= target, capped."""
    return (rows <= targ[:, None]).sum(dim=1).clamp(max=top)


def sel_cell(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Realized cumulative cell rows[idx] - rows[idx-1] (0 before the
    first column): the probability the count-based draw used."""
    hi = rows.gather(1, idx[:, None])[:, 0]
    lo = rows.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0]
    return hi - torch.where(idx > 0, lo, torch.zeros_like(lo))


def flat_rows(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Running sums `rows` of the [B, n] non-negative weights `w`, made
    flat over zero weights: every zero-weight entry takes the value at the
    last positive entry at or before it (0 before the first), whose index
    comes from an integer cummax, so the cell of every zero weight is
    exactly 0 however `rows` were associated."""
    ar = torch.arange(w.shape[1], device=w.device)
    last = torch.where(w > 0, ar, -1).cummax(dim=1).values
    flat = rows.gather(1, last.clamp(min=0))
    return torch.where(last >= 0, flat, torch.zeros_like(flat))


def flat_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Running sums along the rows of [B, n] non-negative weights that are
    flat over zero weights on any device (:func:`flat_rows` of
    torch.cumsum).  torch.cumsum promises no association order, and a scan
    associated in a tree leaves ulp-wide cells at zero weights: such a
    cell is drawn about once in 1e7 draws, with a spawn weight ~1e7 times
    too large.  On the CPU the cumsum adds in order and is already flat,
    and this returns the same bits."""
    return flat_rows(torch.cumsum(w, dim=1), w)


def singles_rows(bits2: torch.Tensor, u_rowsum: torch.Tensor,
                 u_pick: torch.Tensor):
    """(o_s, utot, c_s) from the [CAP, 2n] float32 occupancy: occupied
    spin-orbital o carries weight u_rowsum[orb(o)]."""
    u2 = u_rowsum.to(F32).repeat(2)
    sing_rows = flat_cumsum(bits2 * u2[None, :])
    utot = sing_rows[:, -1]
    o_s = count_le(sing_rows, (u_pick * utot).to(F32), bits2.shape[1] - 1)
    return o_s, utot, sel_cell(sing_rows, o_s)


def hb_select_plain(up_w, dn_w, norb: int, R2, u_rowsum, u_pick,
                    u_entry) -> Selection:
    """Heat-bath selection for every spawn slot, with torch row cumsums
    (hierarchical pair selection: spin-orbital a ~ m_a = sum_occ R2[a, q],
    then b | a ~ R2[a, b] over occupied b; the realized unordered-pair
    probability is the two-path sum of realized cumulative cells).

    up_w, dn_w: [CAP, W] int64 parent det words; R2: [2 norb, 2 norb]
    float32 pair rowsums (>= 0); u_rowsum: [norb] float64 singles rowsums,
    or None without singles (then o_s, utot and c_s are None); u_pick,
    u_entry: [CAP] float64 uniforms.  K3b adds each running sum in
    spin-orbital order and each mu in ascending q (csrc/hbselect.cu), this
    version with torch.cumsum and a matmul: integer-valued inputs give the
    same bits on both, others agree to float32 rounding."""
    bits2 = torch.cat([dets.to_bits(up_w, norb), dets.to_bits(dn_w, norb)],
                      dim=1).to(F32)                         # [CAP, 2n]
    n2 = 2 * norb
    o_s = utot = c_s = None
    if u_rowsum is not None:
        o_s, utot, c_s = singles_rows(bits2, u_rowsum, u_pick)
    mu = bits2 @ R2
    mu_rows = torch.cumsum(mu * bits2, dim=1)
    m_tot = mu_rows[:, -1]
    o1 = count_le(mu_rows, (u_pick * m_tot).to(F32), n2 - 1)
    r1_rows = torch.cumsum(R2[o1] * bits2, dim=1)
    s1q = r1_rows[:, -1]
    o2 = count_le(r1_rows, (u_entry * s1q).to(F32), n2 - 1)
    r2_rows = torch.cumsum(R2[o2] * bits2, dim=1)
    s2q = r2_rows[:, -1]
    p_pair_q = (sel_cell(mu_rows, o1) * sel_cell(r1_rows, o2) / s1q.clamp(min=TINY)
                + sel_cell(mu_rows, o2) * sel_cell(r2_rows, o1) / s2q.clamp(min=TINY)
                ) / m_tot.clamp(min=TINY)
    return Selection(o1, o2, m_tot, s1q, s2q, p_pair_q, o_s, utot, c_s)
