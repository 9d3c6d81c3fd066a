"""Batched Slater-Condon matrix elements (port of
sqmc_tpu/systems/chem/slater.py; ref: chemistry.f90 hamiltonian_chem:1260,
one_body:1382, two_body:1609; signs from tools.f90 permutation_factor:1294
and permutation_factor2:1342).

Diagonal elements are one fused [2B,norb]x[norb,2norb+2] matmul; singles
and doubles are gathers from the integral table with bit-window parity
signs.  Dense-bit functions take uint8 [B, norb] occupancies per spin;
the ``*_words`` kernels take packed int64 words.  Results are float64
unless a dtype is asked for.
"""

from __future__ import annotations

import torch

from ... import dets
from .integrals import IntegralTable


def diag_elements(table: IntegralTable, bits_up: torch.Tensor,
                  bits_dn: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """<D|H|D> for a batch of dets. [B, norb] x2 -> [B] of `dtype`.

    E = E_core + sum_p n_p h_pp
        + 1/2 (u^T D u - sum u_p D_pp) + 1/2 (d^T D d - sum d_p D_pp)
        + u^T D d - 1/2 (u^T X u - sum u_p X_pp) - 1/2 (d^T X d - ...)
    with D[p,q]=(pp|qq), X[p,q]=(pq|qp).  dtype=float32 is the f32
    walker-state path (full-f32 matmul: TF32 is kept off by the caller).
    """
    u = bits_up.to(dtype)
    d = bits_dn.to(dtype)
    norb = u.shape[-1]
    B = u.shape[0]
    Dd = torch.diagonal(table.direct)
    A = torch.cat([table.direct, table.exchange,
                   torch.diagonal(table.h)[:, None], Dd[:, None]],
                  dim=1).to(dtype)                       # [norb, 2norb+2]
    out = torch.cat([u, d], dim=0) @ A
    uD, dD = out[:B, :norb], out[B:, :norb]
    uX, dX = out[:B, norb:2 * norb], out[B:, norb:2 * norb]
    u_h, d_h = out[:B, 2 * norb], out[B:, 2 * norb]
    u_Dd, d_Dd = out[:B, 2 * norb + 1], out[B:, 2 * norb + 1]
    direct = (0.5 * ((uD * u).sum(-1) - u_Dd) + 0.5 * ((dD * d).sum(-1) - d_Dd)
              + (uD * d).sum(-1))
    exch = -0.5 * ((uX * u).sum(-1) - u_Dd) - 0.5 * ((dX * d).sum(-1) - d_Dd)
    return table.core_energy + (u_h + d_h) + direct + exch


def single_element_no_sign(table: IntegralTable, bits_same, bits_other,
                           p, r) -> torch.Tensor:
    """Unsigned <D|H|D_p^r> for a same-spin single p->r (source det):
    h_pr + sum_{q occ same, q!=p,r} [(pr|qq)-(pq|qr)] + sum_{q occ other} (pr|qq)
    (ref: chemistry.f90 one_body_single:1480 + two_body_single:1845)."""
    norb = table.norb
    p = p.to(torch.int64)
    r = r.to(torch.int64)
    qs = torch.arange(norb, device=p.device)
    if table.sing_dir is not None:
        row = p * norb + r
        direct_row = table.sing_dir[row]
        exch_row = table.sing_exch[row]
    else:
        qb = qs[None, :].expand(p.shape[0], norb)
        pb = p[:, None].expand_as(qb)
        rb = r[:, None].expand_as(qb)
        direct_row = table.eri_value(pb, rb, qb, qb)
        exch_row = table.eri_value(pb, qb, qb, rb)
    same = bits_same.to(torch.float64)
    other = bits_other.to(torch.float64)
    mask_pr = (qs[None, :] != p[:, None]) & (qs[None, :] != r[:, None])
    return (table.h[p, r] + ((direct_row - exch_row) * same * mask_pr).sum(-1)
            + (direct_row * other).sum(-1))


def single_element(table, bits_same, bits_other, p, r) -> torch.Tensor:
    """Signed single-excitation element (source det occupancies)."""
    return (dets.single_excite_sign(bits_same, p, r)
            * single_element_no_sign(table, bits_same, bits_other, p, r))


def double_same_spin(table, bits_same, p, q, r, s) -> torch.Tensor:
    """Signed same-spin double {p,q}->{r,s}, p<q, r<s: (pr|qs)-(ps|qr)."""
    gamma = dets.double_excite_sign_same_spin(bits_same, p, q, r, s)
    return gamma * (table.eri_value(p, r, q, s) - table.eri_value(p, s, q, r))


def double_opposite_spin(table, bits_up, bits_dn, p_up, r_up, q_dn, s_dn):
    """Signed opposite-spin double, up p->r and dn q->s: (pr|qs)."""
    sign = (dets.single_excite_sign(bits_up, p_up, r_up)
            * dets.single_excite_sign(bits_dn, q_dn, s_dn))
    return sign * table.eri_value(p_up, r_up, q_dn, s_dn)


def _extract_diff2(bits_a, bits_b):
    """Positions of up to 2 bits set in a & ~b, ascending (stable argsort,
    padded like sqmc_tpu's), and their count."""
    diff = (bits_a & (1 - bits_b)).to(torch.int32)
    order = torch.argsort(1 - diff, dim=-1, stable=True)
    return order[..., 0], order[..., 1], diff.sum(-1)


def pair_matrix_elements(table: IntegralTable, bits_up_i, bits_dn_i,
                         bits_up_j, bits_dn_j) -> torch.Tensor:
    """<D_i|H|D_j> for batches of det pairs at any excitation level:
    the full diagonal for i == j, 0 beyond doubles.  [B, norb] x4 -> [B]."""
    pu0, pu1, n_up = _extract_diff2(bits_up_i, bits_up_j)
    ru0, ru1, _ = _extract_diff2(bits_up_j, bits_up_i)
    pd0, pd1, n_dn = _extract_diff2(bits_dn_i, bits_dn_j)
    rd0, rd1, _ = _extract_diff2(bits_dn_j, bits_dn_i)
    level = n_up + n_dn
    diag = diag_elements(table, bits_up_i, bits_dn_i)
    single = torch.where(n_up == 1,
                         single_element(table, bits_up_i, bits_dn_i, pu0, ru0),
                         single_element(table, bits_dn_i, bits_up_i, pd0, rd0))
    double = torch.where(
        n_up == 2, double_same_spin(table, bits_up_i, pu0, pu1, ru0, ru1),
        torch.where(n_dn == 2,
                    double_same_spin(table, bits_dn_i, pd0, pd1, rd0, rd1),
                    double_opposite_spin(table, bits_up_i, bits_dn_i,
                                         pu0, ru0, pd0, rd0)))
    zero = torch.zeros((), dtype=torch.float64, device=diag.device)
    return torch.where(level == 0, diag,
                       torch.where(level == 1, single,
                                   torch.where(level == 2, double, zero)))


# ---------------------------------------------------------------------------
# Word-level per-class kernels (the sparse-H builder's hot path)
# ---------------------------------------------------------------------------

def same_spin_double_words(table: IntegralTable, wi, wj) -> torch.Tensor:
    """Signed same-spin double from the excited channel's words [B, W]."""
    p, q, _ = dets.diff2_words(wi, wj)
    r, s, _ = dets.diff2_words(wj, wi)
    val = table.eri_value(p, r, q, s) - table.eri_value(p, s, q, r)
    return dets.double_sign_same_spin_words(wi, wj, p, q, r, s) * val


def opp_spin_double_words(table: IntegralTable, wu_i, wu_j, wd_i, wd_j):
    """Signed opposite-spin double from packed words."""
    p, _, _ = dets.diff2_words(wu_i, wu_j)
    r, _, _ = dets.diff2_words(wu_j, wu_i)
    q, _, _ = dets.diff2_words(wd_i, wd_j)
    s, _, _ = dets.diff2_words(wd_j, wd_i)
    return (dets.single_sign_words(wu_i, p, r) * dets.single_sign_words(wd_i, q, s)
            * table.eri_value(p, r, q, s))


def single_words(table: IntegralTable, w_same_i, w_same_j, w_other_i,
                 norb: int) -> torch.Tensor:
    """Signed single-excitation element from packed words."""
    p, _, _ = dets.diff2_words(w_same_i, w_same_j)
    r, _, _ = dets.diff2_words(w_same_j, w_same_i)
    return dets.single_sign_words(w_same_i, p, r) * single_element_no_sign(
        table, dets.to_bits(w_same_i, norb), dets.to_bits(w_other_i, norb),
        p, r)


# ---------------------------------------------------------------------------
# Time-reversal symmetrized elements (ref: hamiltonian_chem_time_sym:1355)
# ---------------------------------------------------------------------------

SQRT2 = 1.4142135623730951
SQRT2INV = 0.7071067811865476


def pair_matrix_elements_time_sym(table: IntegralTable, bits_up_i, bits_dn_i,
                                  bits_up_j, bits_dn_j, z: int) -> torch.Tensor:
    """<i_ts|H|j_ts> between time-symmetrized basis states given by their
    representative orientations (up <= dn):

      norm_bra * norm_ketinv * (H(i, j) + z H(rev_i, j))

    with norm_bra = sqrt2 when i is self-symmetric, norm_ketinv = 1/sqrt2
    when j is, H(rev_i, j) replaced by H(i, j) when j is self-symmetric
    and dropped when i is (ref: chemistry.f90:1355-1413)."""
    sym_i = (bits_up_i == bits_dn_i).all(dim=-1)
    sym_j = (bits_up_j == bits_dn_j).all(dim=-1)
    m1 = pair_matrix_elements(table, bits_up_i, bits_dn_i, bits_up_j, bits_dn_j)
    m2 = pair_matrix_elements(table, bits_dn_i, bits_up_i, bits_up_j, bits_dn_j)
    m2 = torch.where(sym_j, m1, m2)
    m2 = torch.where(sym_i, torch.zeros_like(m2), m2)
    one = torch.ones_like(m1)
    norm = torch.where(sym_i, SQRT2 * one, one) * torch.where(
        sym_j, SQRT2INV * one, one)
    return norm * (m1 + z * m2)
