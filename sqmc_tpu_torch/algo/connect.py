"""Screened connected-determinant generation (port of
sqmc_tpu/algo/connect.py; ref: chemistry.f90:6819-7162
find_important_connected_dets_chem, semistoch.f90:1579).

The per-pair sorted-|H| scan with early exit becomes a vectorized
bisection for the eps cut over the flat heat-bath rows; ragged
per-reference candidate lists become one flat emission located by
searchsorted over the prefix sum of counts.  Singles are evaluated for
all (p, r) at once as matmuls against the precomputed (pr|qq) / (pq|qr)
tensors.  Every candidate carries its signed element and reference
index, so the same code serves HCI selection and the C(T) cache.

The emission order (batch, then doubles before singles, then reference,
pair and rank) equals the JAX package's, so the unmerged outputs match
row for row.  For a time-symmetrized system the candidates are mapped to
representatives with the sqrt2 norms and z signs
(:func:`_time_sym_postprocess`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dets
from ..ops import setalg
from ..systems.chem.slater import SQRT2, SQRT2INV
from ..systems.heatbath import rank_of_eps, tri_le, tri_lt


def _pair_descriptors(occ_up, occ_dn, nup: int, ndn: int):
    """Electron pairs per reference: same-up (kind 0, p<q), same-dn
    (kind 1), opposite (kind 2, p up / q dn)."""
    dev = occ_up.device
    iu, ju = (torch.as_tensor(x, device=dev) for x in np.triu_indices(nup, k=1))
    idn, jdn = (torch.as_tensor(x, device=dev) for x in np.triu_indices(ndn, k=1))
    io, jo = np.meshgrid(np.arange(nup), np.arange(ndn), indexing="ij")
    io = torch.as_tensor(io.ravel(), device=dev)
    jo = torch.as_tensor(jo.ravel(), device=dev)
    p = torch.cat([occ_up[:, iu], occ_dn[:, idn], occ_up[:, io]], dim=1)
    q = torch.cat([occ_up[:, ju], occ_dn[:, jdn], occ_dn[:, jo]], dim=1)
    B = occ_up.shape[0]
    kind = torch.cat([
        torch.zeros((B, len(iu)), dtype=torch.int64, device=dev),
        torch.ones((B, len(idn)), dtype=torch.int64, device=dev),
        torch.full((B, len(io)), 2, dtype=torch.int64, device=dev)], dim=1)
    return p, q, kind


def count_doubles(hb, ref_up, ref_dn, eps, min_H, *, nup: int, ndn: int):
    """Phase 1: per-(ref, pair) emission counts for the eps window
    [lo, hi): hi = #entries with |H| > eps, lo = #entries with
    |H| > min_H (already generated; ref: chemistry.f90:7043)."""
    norb = hb.norb
    occ_up = dets.occ_orbitals(dets.to_bits(ref_up, norb), nup)
    occ_dn = dets.occ_orbitals(dets.to_bits(ref_dn, norb), ndn)
    p, q, kind = _pair_descriptors(occ_up, occ_dn, nup, ndn)
    a = torch.minimum(p, q)
    b = torch.maximum(p, q)
    same_row = tri_lt(a, b).clamp(0, len(hb.same_start) - 1)
    opp_row = tri_le(a, b).clamp(0, len(hb.opp_start) - 1)
    is_opp = kind == 2
    start = torch.where(is_opp, hb.opp_start[opp_row], hb.same_start[same_row])
    count = torch.where(is_opp, hb.opp_count[opp_row],
                        hb.same_count[same_row]).to(torch.int64)
    swapped = is_opp & (p > q)
    eps_b = eps[:, None].expand_as(start)
    minH_b = min_H[:, None].expand_as(start)
    n_iter = hb.max_count.bit_length() + 1

    def rank(x):
        return torch.where(is_opp,
                           rank_of_eps(hb.opp_val, start, count, x, n_iter),
                           rank_of_eps(hb.same_val, start, count, x, n_iter))

    hi = rank(eps_b)
    lo = rank(minH_b)
    n_emit = (hi - lo).clamp(min=0)
    return n_emit, lo, (p, q, kind, start, is_opp, swapped)


def emit_doubles(hb, ref_up, ref_dn, n_emit, lo, desc, *, total: int,
                 norb: int):
    """Phase 2: materialize the `total` double-excitation candidates.
    Returns dict of flat tensors: new_up/new_dn (words), ref, helem
    (signed H), valid (False for occupied targets and zero elements)."""
    p, q, kind, start, is_opp, swapped = desc
    B, npairs = p.shape
    dev = p.device
    flat_emit = n_emit.reshape(-1)
    cum = torch.cumsum(flat_emit, 0)
    off = cum - flat_emit
    t = torch.arange(total, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(cum, t, right=True).clamp(max=B * npairs - 1)
    rank = t - off[seg] + lo.reshape(-1)[seg]

    bi = seg // npairs
    pr_i = seg % npairs
    pp, qq, kk = p[bi, pr_i], q[bi, pr_i], kind[bi, pr_i]
    opp, sw = is_opp[bi, pr_i], swapped[bi, pr_i]
    idx = start[bi, pr_i] + rank
    rs = torch.where(opp,
                     hb.opp_rs[idx.clamp(0, len(hb.opp_rs) - 1)],
                     hb.same_rs[idx.clamp(0, len(hb.same_rs) - 1)]).to(torch.int64)
    r_tab = rs // norb
    s_tab = rs % norb
    # swapped opposite rows: up target is s_tab, dn target is r_tab
    r = torch.where(sw, s_tab, r_tab)
    s = torch.where(sw, r_tab, s_tab)
    up_w = ref_up[bi]
    dn_w = ref_dn[bi]

    occupied = torch.where(
        opp, dets.get_orb(up_w, r) | dets.get_orb(dn_w, s),
        torch.where(kk == 0, dets.get_orb(up_w, r) | dets.get_orb(up_w, s),
                    dets.get_orb(dn_w, r) | dets.get_orb(dn_w, s)))
    valid = ~occupied

    same_up = kk == 0
    up_2 = dets.set_orb(dets.set_orb(dets.clear_orb(dets.clear_orb(up_w, pp), qq), r), s)
    dn_2 = dets.set_orb(dets.set_orb(dets.clear_orb(dets.clear_orb(dn_w, pp), qq), r), s)
    up_o = dets.set_orb(dets.clear_orb(up_w, pp), r)
    dn_o = dets.set_orb(dets.clear_orb(dn_w, qq), s)
    new_up = torch.where(opp[:, None], up_o,
                         torch.where(same_up[:, None], up_2, up_w))
    new_dn = torch.where(opp[:, None], dn_o,
                         torch.where(same_up[:, None], dn_w, dn_2))

    # signs from per-reference occupancy prefix sums: pref[b, o] = #set < o
    def prefix(words):
        bits = dets.to_bits(words, norb).to(torch.int64)
        return torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                          torch.cumsum(bits, 1)], dim=1)

    pref_up, pref_dn = prefix(ref_up), prefix(ref_dn)

    def in_window(x, a_pos, b_pos):
        return ((x >= torch.minimum(a_pos, b_pos))
                & (x < torch.maximum(a_pos, b_pos))).to(torch.int64)

    def wc(pref, a_pos, b_pos):
        return (pref[bi, torch.maximum(a_pos, b_pos)]
                - pref[bi, torch.minimum(a_pos, b_pos)])

    def wc_same(a_pos, b_pos):
        return torch.where(same_up, wc(pref_up, a_pos, b_pos),
                           wc(pref_dn, a_pos, b_pos))

    c1 = wc_same(pp, r) - in_window(pp, pp, r) - in_window(qq, pp, r)
    c2 = wc_same(qq, s) - in_window(pp, qq, s) - in_window(qq, qq, s)
    gamma_same = torch.where((c1 + c2) % 2 == 0, 1.0, -1.0)
    cu = wc(pref_up, pp, r) - in_window(pp, pp, r)
    cd = wc(pref_dn, qq, s) - in_window(qq, qq, s)
    gamma_opp = torch.where((cu + cd) % 2 == 0, 1.0, -1.0)
    val_tab = torch.where(opp,
                          hb.opp_val[idx.clamp(0, len(hb.opp_val) - 1)],
                          hb.same_val[idx.clamp(0, len(hb.same_val) - 1)])
    helem = torch.where(opp, gamma_opp, gamma_same).to(torch.float64) * val_tab
    valid = valid & (helem != 0.0)
    return dict(new_up=new_up, new_dn=new_dn, ref=bi, helem=helem, valid=valid)


def _single_targets(table, orb_sym, norb: int):
    """For each orbital p, the targets r (ascending, padded to the longest
    row) of the singles p -> r that can be nonzero: same irrep, r != p,
    and h[p, r] or some (pr|qq) or (pq|qr) nonzero.  Every other single's
    element is exactly 0 whatever the occupations, so leaving it out of
    the emission drops only rows the filter would drop (the survivors keep
    their order).  Returns (R [norb, K] int64, ok [norb, K] bool)."""
    dev = table.h.device
    can = ((table.h.reshape(-1) != 0) | (table.sing_dir != 0).any(dim=1)
           | (table.sing_exch != 0).any(dim=1)).reshape(norb, norb)
    can &= orb_sym[:, None] == orb_sym[None, :]
    can &= ~torch.eye(norb, dtype=torch.bool, device=dev)
    k = max(int(can.sum(dim=1).max()), 1)
    R = torch.argsort((~can).to(torch.int8), dim=1, stable=True)[:, :k]
    return R, can.gather(1, R)


def emit_singles(table, orb_sym, ref_up, ref_dn, eps, min_H, *, nup: int,
                 ndn: int, norb: int):
    """All symmetry-allowed singles with eps <= |H| <= min_H (ref:
    chemistry.f90:6903-6992): element(p->r) = h[p,r] + sum_q n_q (pr|qq)
    - sum_{q same spin} n_q (pq|qr), for all (p, r) as matmuls; the
    candidates are the targets of :func:`_single_targets` (on a Hubbard
    lattice the neighbours, not every orbital)."""
    nelec = nup + ndn
    B = ref_up.shape[0]
    dev = ref_up.device
    R, R_ok = _single_targets(table, orb_sym, norb)
    K = R.shape[1]
    bits_up = dets.to_bits(ref_up, norb)
    bits_dn = dets.to_bits(ref_dn, norb)
    occ = torch.cat([dets.occ_orbitals(bits_up, nup),
                     dets.occ_orbitals(bits_dn, ndn)], dim=1)
    u = bits_up.to(torch.float64)
    d = bits_dn.to(torch.float64)
    Mdir = (u + d) @ table.sing_dir.T
    h_flat = table.h.reshape(-1)
    M_up = h_flat[None, :] + Mdir - u @ table.sing_exch.T
    M_dn = h_flat[None, :] + Mdir - d @ table.sing_exch.T

    def prefix(bits):
        return torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                          torch.cumsum(bits.to(torch.int64), 1)], dim=1)

    pref_up, pref_dn = prefix(bits_up), prefix(bits_dn)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    pb = ar(B).repeat_interleave(nelec * K)
    pe = ar(nelec).repeat_interleave(K).repeat(B)
    kk = ar(K).repeat(B * nelec)
    p = occ[pb, pe]
    rr = R[p, kk]
    up_sel = pe < nup
    r_occ = torch.where(up_sel, bits_up[pb, rr] != 0, bits_dn[pb, rr] != 0)
    valid = (~r_occ) & R_ok[p, kk]
    unsigned = torch.where(up_sel, M_up[pb, p * norb + rr],
                           M_dn[pb, p * norb + rr])
    lo_ = torch.minimum(p, rr)
    hi_ = torch.maximum(p, rr)
    pref = torch.where(up_sel, pref_up[pb, hi_] - pref_up[pb, lo_],
                       pref_dn[pb, hi_] - pref_dn[pb, lo_])
    n_between = pref - ((p >= lo_) & (p < hi_)).to(torch.int64)
    helem = torch.where(n_between % 2 == 0, 1.0, -1.0).to(torch.float64) * unsigned
    keep = (helem.abs() >= eps[pb]) & (helem.abs() <= min_H[pb])
    valid = valid & keep & (helem != 0.0)
    up_w, dn_w = ref_up[pb], ref_dn[pb]
    new_up = torch.where(up_sel[:, None],
                         dets.set_orb(dets.clear_orb(up_w, p), rr), up_w)
    new_dn = torch.where(up_sel[:, None], dn_w,
                         dets.set_orb(dets.clear_orb(dn_w, p), rr))
    return dict(new_up=new_up, new_dn=new_dn, ref=pb, helem=helem, valid=valid)


def generate_connections(system, ref_up: torch.Tensor, ref_dn: torch.Tensor,
                         eps: torch.Tensor, min_H: torch.Tensor | None = None,
                         batch: int = 2048, mesh=None):
    """All screened connections of a reference det list.

    ref_up/ref_dn: int64 words [n, W]; eps: [n] per-ref |H| thresholds
    (typically eps_var/|c_i|); min_H: optional [n] already-done thresholds
    (emit eps < |H| <= min_H).  Returns (cand_up [m,W], cand_dn [m,W],
    helem [m] float64, ref_idx [m] int64), unmerged: duplicates across
    refs are kept and callers sort/merge.

    mesh: a parallel.dist.Mesh - this rank generates the connections of
    its contiguous slice of the references only (ref: the per-core
    reference split of find_doubly_excited, semistoch.f90:1743; the JAX
    package's ``devices=``); ref_idx still counts in the whole list."""
    n, W = ref_up.shape
    dev = ref_up.device
    norb = system.norb
    eps = torch.as_tensor(eps, dtype=torch.float64, device=dev)
    if min_H is None:
        min_H = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    min_H = torch.as_tensor(min_H, dtype=torch.float64, device=dev)
    if mesh is not None:
        from ..parallel.dist import rank_slice
        lo, hi = rank_slice(n, mesh)
        cu, cd, h, ref = generate_connections(
            system, ref_up[lo:hi], ref_dn[lo:hi], eps[lo:hi], min_H[lo:hi],
            batch=batch)
        return cu, cd, h, ref + lo
    outs = []
    for beg in range(0, n, batch):
        end = min(beg + batch, n)
        ru, rd = ref_up[beg:end], ref_dn[beg:end]
        ev, mh = eps[beg:end], min_H[beg:end]
        n_emit, lo, desc = count_doubles(system.heatbath, ru, rd, ev, mh,
                                         nup=system.nup, ndn=system.ndn)
        total = int(n_emit.sum())
        if total > 0:
            outs.append((beg, emit_doubles(system.heatbath, ru, rd, n_emit, lo,
                                           desc, total=total, norb=norb)))
        if system.has_singles:
            outs.append((beg, emit_singles(system.table, system.orb_sym_arr,
                                           ru, rd, ev, mh, nup=system.nup,
                                           ndn=system.ndn, norb=norb)))
    if not outs:
        z = torch.zeros((0, W), dtype=torch.int64, device=dev)
        return (z, z.clone(), torch.zeros(0, dtype=torch.float64, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    cu = torch.cat([o["new_up"][o["valid"]] for _, o in outs])
    cd = torch.cat([o["new_dn"][o["valid"]] for _, o in outs])
    h = torch.cat([o["helem"][o["valid"]] for _, o in outs])
    ref = torch.cat([o["ref"][o["valid"]] + beg for beg, o in outs])
    if system.time_sym:
        return _time_sym_postprocess(system, ref_up, ref_dn, cu, cd, h, ref)
    return cu, cd, h, ref


def _time_sym_postprocess(system, ref_up, ref_dn, cu, cd, h, ref):
    """Map det-basis candidates of representative references to
    time-reversal representatives (ref: chemistry.f90:6957-6992,
    7100-7140): drop self-symmetric candidates when z < 0 and candidates
    equal to their reference's reverse (a diagonal move in the
    symmetrized basis); h *= 1/sqrt2 when only the reference is
    self-symmetric, h *= sqrt2 when only the candidate is; swap (up, dn)
    to the representative orientation, with h *= z on a swap."""
    z = system.z
    ru, rd = ref_up[ref], ref_dn[ref]
    sym_ref = (ru == rd).all(dim=1)
    sym_cand = (cu == cd).all(dim=1)
    keep = ~((cu == rd).all(dim=1) & (cd == ru).all(dim=1))
    if z < 0:
        keep &= ~sym_cand
    one = torch.ones_like(h)
    h = h * torch.where(sym_ref & ~sym_cand, SQRT2INV * one, one)
    h = h * torch.where(sym_cand & ~sym_ref, SQRT2 * one, one)
    swap = setalg.keys_less(cd, cu, cu, cd)
    cu2 = torch.where(swap[:, None], cd, cu)
    cd2 = torch.where(swap[:, None], cu, cd)
    h = torch.where(swap, z * h, h)
    return cu2[keep], cd2[keep], h[keep], ref[keep]
