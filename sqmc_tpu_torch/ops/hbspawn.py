"""The heat-bath proposal of the walk's spawn slots (K3b): plain PyTorch
version and the wrapper around the hand CUDA kernel (csrc/hbselect.cu,
entry ``sqmc_hb_spawn``, which runs K3's selection code and goes on).

Port of the fast_heatbath branch of the JAX generation's proposal
(sqmc_tpu/algo/walk.py:1539-1700, :1812-1871).  For each spawn slot's
parent det (``up_w``, ``dn_w``, [CAP, W] int64) and its five uniforms
``streams`` = (ub, up_, ue, ua2, ur), with ``tau`` the walk's 0-d float64
tau:

  * the heat-bath selection (ops/hbselect.py): the pair of occupied
    spin-orbitals (o1, o2) from up_ and ue, and with singles the occupied
    spin-orbital o_s from up_;
  * p_single = utot / (utot + m_tot / 2); the slot takes a single when
    ub < p_single;
  * a double: the pair's row of the heat-bath table, an in-row target
    (r, s) by a uniform slot from ur and accept-or-alias from ua2, the
    target's occupancy and the excitation's sign from the det words, and
    the spawn factor -tau sign(H) S / ((1 - p_single) p_pair), divided
    by exactly the probability the draw realized (the exact S/diff
    correction);
  * a single: the target r ~ U[p, r] by the singles alias row (ue, ua2),
    the sign and the element h_pr + sum_q ..., from sng_pack's float32 row
    (a float32 state) or the float64 tables, and the factor -tau H /
    p(single) times S_p / c_s.

Returns (spawn_up, spawn_dn, factor, ok): the child's words, the spawn
factor (float64) and whether the slot spawns.

:func:`propose` dispatches on the device of ``up_w``: a CPU tensor takes
:func:`propose_plain`; a CUDA tensor launches the kernel (built from the
source on first use, ops/cudabuild.py) or raises.  :func:`singles_source`
picks the kernel's build for a walk's tables: none without singles, and
with singles sng_pack under a float32 state or the float64 singles rows
(``table.sing_dir``) under a float64 state, the two that
algo/walk.py's build_walk_tables makes.  The kernel
mirrors the plain version's op order and type promotion, so the words,
the flags and a double's factor are the plain version's bits on the same
inputs (with the same selection, K3 on the card); a single's element
differs only by the order of its two row sums over the orbitals.

:func:`excite_double` and :func:`propose_single` are the plain version's
double and single after their draws; the uniform and Cauchy-Schwarz
proposals of algo/walk.py use them too.
"""

from __future__ import annotations

import ctypes

import torch

from .. import dets
from ..systems.chem import slater
from ..systems.heatbath import tri_le, tri_lt
from . import cudabuild, hbselect

F32, F64, I32, I64 = torch.float32, torch.float64, torch.int32, torch.int64
TINY = 1e-30
NO_SINGLES, PACK, ROWS = 0, 1, 2     # the kernel's singles sources

launches = 0                         # kernel launches since reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def parity_sign(n: torch.Tensor) -> torch.Tensor:
    """+1.0 for an even count, -1.0 for an odd one (float64)."""
    return torch.where(n % 2 == 0, 1.0, -1.0).to(F64)


def in_window(x, a_pos, b_pos):
    """1 where min(a, b) <= x < max(a, b) (int32)."""
    return ((x >= torch.minimum(a_pos, b_pos))
            & (x < torch.maximum(a_pos, b_pos))).to(I32)


def excite_double(up_w, dn_w, pp, qq, r, s, kk):
    """The double {pp, qq} -> {r, s} of each slot's det: kk 0 up-up, 1
    dn-dn (pp < qq, r < s), 2 opposite spins (pp and r up, qq and s dn).
    Returns (spawn_up, spawn_dn, gamma, ok): the child's words, the
    excitation's sign (float64) and whether r and s are empty."""
    same_up_k = kk == 0
    opp = kk == 2
    r_occ = torch.where(opp | same_up_k, dets.get_orb(up_w, r),
                        dets.get_orb(dn_w, r))
    s_occ = torch.where(opp, dets.get_orb(dn_w, s),
                        torch.where(same_up_k, dets.get_orb(up_w, s),
                                    dets.get_orb(dn_w, s)))
    ok = ~(r_occ | s_occ)
    words_same = torch.where(same_up_k[:, None], up_w, dn_w)
    c1 = (dets.count_below(words_same, pp, r) - in_window(pp, pp, r)
          - in_window(qq, pp, r))
    c2 = (dets.count_below(words_same, qq, s) - in_window(pp, qq, s)
          - in_window(qq, qq, s))
    cu_ = dets.count_below(up_w, pp, r) - in_window(pp, pp, r)
    cd_ = dets.count_below(dn_w, qq, s) - in_window(qq, qq, s)
    gamma = torch.where(opp, parity_sign(cu_ + cd_), parity_sign(c1 + c2))
    spawn_up = torch.where(
        opp[:, None], dets.set_orb(dets.clear_orb(up_w, pp), r),
        torch.where(same_up_k[:, None],
                    dets.set_orb(dets.set_orb(dets.clear_orb(
                        dets.clear_orb(up_w, pp), qq), r), s), up_w))
    spawn_dn = torch.where(
        opp[:, None], dets.set_orb(dets.clear_orb(dn_w, qq), s),
        torch.where(same_up_k[:, None], dn_w,
                    dets.set_orb(dets.set_orb(dets.clear_orb(
                        dets.clear_orb(dn_w, pp), qq), r), s)))
    return spawn_up, spawn_dn, gamma, ok


def propose_single(tables, norb: int, up_w, dn_w, o_s, utot_b, diff_sng,
                   psing_b, ue, ua2, tau):
    """The single of each slot (chem, real-space Hubbard) from its drawn
    occupied spin-orbital o_s (the singles row's total utot_b, its
    realized cell diff_sng, p_single psing_b): the target r_s ~ U[p_s, r_s]
    by the alias row (ue, ua2).  Returns (spawn_up, spawn_dn, factor,
    ok)."""
    dev = up_w.device
    bits_up_c = dets.to_bits(up_w, norb)
    bits_dn_c = dets.to_bits(dn_w, norb)
    e_up = o_s < norb
    p_s = torch.where(e_up, o_s, o_s - norb)
    slot_r = (ue * norb).to(I64).clamp(max=norb - 1)
    ia = p_s * norb + slot_r
    r_s = torch.where(ua2.to(F32) < tables.u_alias_q[ia], slot_r,
                      tables.u_alias_J[ia])
    r_s_occ = torch.where(e_up, dets.get_orb(up_w, r_s), dets.get_orb(dn_w, r_s))
    bits_same = torch.where(e_up[:, None], bits_up_c, bits_dn_c)
    bits_other = torch.where(e_up[:, None], bits_dn_c, bits_up_c)
    words_same_s = torch.where(e_up[:, None], up_w, dn_w)
    sgn_s = parity_sign(dets.count_below(words_same_s, p_s, r_s)
                        - (p_s < r_s).to(I32))
    if tables.sng_pack.numel():
        # f32 state: (pr|qq), (pq|qr), h_pr and U[p,r] in one row gather
        srow = tables.sng_pack[p_s * norb + r_s]
        direct_row = srow[:, :norb]
        exch_row = srow[:, norb:2 * norb]
        qs = torch.arange(norb, device=dev)
        mask_pr = (qs[None, :] != p_s[:, None]) & (qs[None, :] != r_s[:, None])
        h_sng = sgn_s * (srow[:, 2 * norb]
                         + ((direct_row - exch_row) * bits_same.to(F32)
                            * mask_pr).sum(-1)
                         + (direct_row * bits_other.to(F32)).sum(-1))
        u_sel = srow[:, 2 * norb + 1]
    else:
        h_sng = sgn_s * slater.single_element_no_sign(
            tables.table, bits_same, bits_other, p_s, r_s)
        u_sel = tables.u_table[p_s, r_s]
    p_sel_sng = psing_b * u_sel / utot_b.clamp(min=TINY)
    w_s = -tau * h_sng / p_sel_sng.clamp(min=TINY)
    # realized p(spin-orbital) = diff / Utot from the cumulative, the
    # alias draw is normalized by the exact row sum: multiply by S/diff
    S_sng = tables.u_rowsum[p_s].to(w_s.dtype)
    diff_sng = diff_sng.to(w_s.dtype)
    w_sng = w_s * torch.where(diff_sng > 0, S_sng / diff_sng,
                              torch.ones((), dtype=w_s.dtype, device=dev))
    sng_up = torch.where(e_up[:, None],
                         dets.set_orb(dets.clear_orb(up_w, p_s), r_s), up_w)
    sng_dn = torch.where(e_up[:, None], dn_w,
                         dets.set_orb(dets.clear_orb(dn_w, p_s), r_s))
    # a draw past the last occupied spin-orbital (a target rounded up to
    # utot: the count is capped at 2n - 1) realizes no cell; without the
    # last two terms its child would carry one electron too many
    p_s_occ = torch.where(e_up, dets.get_orb(up_w, p_s),
                          dets.get_orb(dn_w, p_s))
    sng_ok = (~r_s_occ) & (u_sel > 0) & (diff_sng > 0) & p_s_occ
    return sng_up, sng_dn, w_sng, sng_ok


def propose_plain(tables, up_w, dn_w, norb: int, singles: bool, tau, wdt,
                  streams):
    """The heat-bath proposal with torch ops (the selection through
    hbselect.hb_select: K3 on the card, its plain version on the CPU)."""
    CAP = up_w.shape[0]
    dev = up_w.device
    ub, up_, ue, ua2, ur = streams
    ntri_s = norb * (norb - 1) // 2
    zero64 = torch.zeros((), dtype=F64, device=dev)
    # hierarchical pair selection (and the singles draw) in one kernel:
    # spin-orbital a ~ m_a = sum_occ R2[a, q], then b | a ~ R2[a, b] over
    # occupied b; the realized unordered-pair probability is the two-path
    # sum of realized cumulative cells
    sel = hbselect.hb_select(up_w, dn_w, norb, tables.R2,
                             tables.u_rowsum if singles else None, up_, ue)
    m_tot = sel.m_tot
    w2_b = (0.5 * m_tot).to(wdt)
    utot_b = sel.utot.to(wdt) if singles else \
        torch.zeros(CAP, dtype=F64, device=dev)
    psing_b = torch.where(utot_b + w2_b > 0, utot_b / (utot_b + w2_b), zero64)

    o1, o2, s1q, s2q, p_pair_q = sel.o1, sel.o2, sel.s1q, sel.s2q, sel.p_pair_q
    pair_fail = ((o1 == o2) | (m_tot <= 0) | (s1q <= 0) | (s2q <= 0)
                 | (p_pair_q <= 0))
    up1 = o1 < norb
    up2 = o2 < norb
    orb1 = torch.where(up1, o1, o1 - norb)
    orb2 = torch.where(up2, o2, o2 - norb)
    same_up_k = up1 & up2
    kk = torch.where(same_up_k, 0, torch.where(~up1 & ~up2, 1, 2))
    opp = kk == 2
    # opposite-spin: pp = the up orbital, qq = the dn orbital;
    # same-spin: pp < qq
    pp = torch.where(opp, torch.where(up1, orb1, orb2), torch.minimum(orb1, orb2))
    qq = torch.where(opp, torch.where(up1, orb2, orb1), torch.maximum(orb1, orb2))
    a_s = torch.minimum(pp, qq)
    b_s = torch.maximum(pp, qq)
    rc = torch.where(opp, ntri_s + tri_le(a_s, b_s), tri_lt(a_s, b_s))
    st = tables.hb_start[rc]
    cnt = tables.hb_count[rc]
    S_exact = tables.hb_rowsum[rc]
    # O(1) in-row target ~ |H|: uniform slot, then accept-or-alias
    n_cat = tables.hb_alias_q.shape[0]
    slot = torch.minimum((ur * cnt).to(I64), (cnt - 1).clamp(min=0))
    i0 = (st + slot).clamp(0, n_cat - 1)
    rv = torch.where(ua2.to(F32) < tables.hb_alias_q[i0],
                     tables.hb_rs_own[i0], tables.hb_rs_partner[i0])
    rs = rv.abs().to(I64) - 1
    r_tab = rs // norb
    s_tab = rs % norb
    swp = opp & (pp > qq)
    r = torch.where(swp, s_tab, r_tab)
    s = torch.where(swp, r_tab, s_tab)
    val_tab = rv.to(F64)                     # carries the sign only
    dbl_up, dbl_dn, gamma, dbl_ok = excite_double(up_w, dn_w, pp, qq, r, s, kk)
    h_signed_dbl = gamma * val_tab
    # p(spawn) = (1 - p_single) p{pair} |H| / S_exact: dividing by exactly
    # the realized probability keeps E[spawn] = -tau H w independent of how
    # the selection cumulatives were rounded (exact S/diff correction)
    w_dbl = torch.where(
        pair_fail, zero64,
        -tau * torch.sign(h_signed_dbl) * S_exact.to(wdt)
        / ((1.0 - psing_b) * p_pair_q.to(wdt)).clamp(min=TINY))
    if not singles:
        return dbl_up, dbl_dn, w_dbl, dbl_ok
    take_single = ub < psing_b
    sng_up, sng_dn, w_sng, sng_ok = propose_single(
        tables, norb, up_w, dn_w, sel.o_s, utot_b, sel.c_s, psing_b, ue, ua2,
        tau)
    return (torch.where(take_single[:, None], sng_up, dbl_up),
            torch.where(take_single[:, None], sng_dn, dbl_dn),
            torch.where(take_single, w_sng, w_dbl),
            torch.where(take_single, sng_ok, dbl_ok))


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

def singles_source(tables, singles: bool, wdt):
    """The kernel's source of a single's element for these tables and
    state precision: NO_SINGLES, PACK (sng_pack, float32 state) or ROWS
    (the float64 rows, float64 state).  Raises ValueError for any other
    (a table without float64 singles rows, or a precision its rows do not
    match)."""
    if not singles:
        return NO_SINGLES
    if tables.sng_pack.numel() and wdt == F32:
        return PACK
    if (not tables.sng_pack.numel() and wdt == F64
            and getattr(tables.table, "sing_dir", None) is not None):
        return ROWS
    raise ValueError("hb_spawn has no build for these singles tables at "
                     f"{wdt}: it reads sng_pack under a float32 state or "
                     "table.sing_dir under a float64 one")


def _load(dev):
    return cudabuild.load(hbselect._SOURCE, hbselect._PREFIX, hbselect._bind,
                          dev.index)


def launch_shape(cap: int, n_words: int, norb: int, f64: bool, src: int,
                 device) -> dict:
    """How the kernel launches for these shapes on ``device`` (a card); the
    keys of hbselect.launch_shape."""
    dev = torch.device(device)
    out = (ctypes.c_longlong * 8)()
    with torch.cuda.device(dev):
        lib = _load(dev)
        err = lib.sqmc_hb_spawn_shape(cap, n_words, norb, int(f64), src,
                                      ctypes.addressof(out))
    if err != 0:
        raise RuntimeError("hb_spawn launch shape: "
                           + cudabuild.error_string(lib, hbselect._PREFIX, err))
    keys = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "r2_in_smem",
            "registers", "spill_bytes", "reg_ne")
    return dict(zip(keys, list(out)))


def _expect(t, dtype, shape, dev, name):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, not {type(t).__name__}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on {dev}, "
                         f"not {tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def _pointers(ts):
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def propose_cuda(tables, up_w, dn_w, norb: int, singles: bool, tau, wdt,
                 streams):
    """Launch the kernel on CUDA tensors (checks everything it is handed:
    the tensors go to csrc/hbselect.cu's sqmc_hb_spawn in its order)."""
    global launches
    dev = up_w.device
    CAP, W = up_w.shape
    if up_w.dtype != I64 or W * 64 < norb:
        raise ValueError(f"up_w must be [CAP, W] int64 with 64 W >= {norb}")
    src = singles_source(tables, singles, wdt)
    n2 = 2 * norb
    n_cat = tables.hb_alias_q.shape[0]
    rows = tables.hb_start.shape[0]
    x = lambda t, dt, sh, name: _expect(t, dt, sh, dev, name)  # noqa: E731
    ins = [x(up_w, I64, (CAP, W), "up_w"), x(dn_w, I64, (CAP, W), "dn_w"),
           x(tables.R2, F32, (n2, n2), "R2"),
           x(tables.u_rowsum, F64, (norb,), "u_rowsum") if singles else None]
    ins += [x(u, F64, (CAP,), "each stream") for u in streams]
    ins += [x(tau, F64, (), "tau"),
            x(tables.hb_alias_q, F32, (n_cat,), "hb_alias_q"),
            x(tables.hb_rs_own, F32, (n_cat,), "hb_rs_own"),
            x(tables.hb_rs_partner, F32, (n_cat,), "hb_rs_partner"),
            x(tables.hb_start, I64, (rows,), "hb_start"),
            x(tables.hb_count, I64, (rows,), "hb_count"),
            x(tables.hb_rowsum, F32, (rows,), "hb_rowsum")]
    nn = norb * norb
    ins += ([x(tables.u_alias_q, F32, (nn,), "u_alias_q"),
             x(tables.u_alias_J, I64, (nn,), "u_alias_J")] if singles
            else [None, None])
    ins.append(x(tables.sng_pack, F32, (nn, n2 + 2), "sng_pack")
               if src == PACK else None)
    if src == ROWS:
        tb = tables.table
        ins += [x(tb.h, F64, (norb, norb), "table.h"),
                x(tb.sing_dir, F64, (nn, norb), "table.sing_dir"),
                x(tb.sing_exch, F64, (nn, norb), "table.sing_exch"),
                x(tables.u_table, F64, (norb, norb), "u_table")]
    else:
        ins += [None] * 4
    outs = (torch.empty((CAP, W), dtype=I64, device=dev),
            torch.empty((CAP, W), dtype=I64, device=dev),
            torch.empty(CAP, dtype=F64, device=dev),
            torch.empty(CAP, dtype=torch.bool, device=dev))
    if CAP == 0:
        return outs
    with torch.cuda.device(dev):
        lib = _load(dev)
        err = lib.sqmc_hb_spawn(CAP, W, norb, int(wdt == F64), src, n_cat,
                                _pointers(ins), _pointers(outs),
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("hb_spawn kernel launch failed: "
                           + cudabuild.error_string(lib, hbselect._PREFIX, err))
    launches += 1
    return outs


def propose(tables, up_w, dn_w, norb: int, singles: bool, tau, wdt,
            streams):
    """The heat-bath proposal of every spawn slot: (spawn_up, spawn_dn,
    factor, ok).  tables: the walk's WalkTables; up_w, dn_w: [CAP, W]
    int64 parent words; singles: whether the walk proposes singles; tau:
    0-d float64 tensor; wdt: the state's precision; streams: five [CAP]
    float64 uniforms (ub, up_, ue, ua2, ur)."""
    if up_w.device.type == "cpu":
        return propose_plain(tables, up_w, dn_w, norb, singles, tau, wdt,
                             streams)
    if up_w.device.type != "cuda":
        raise ValueError(f"hb_spawn has no path for device {up_w.device}")
    return propose_cuda(tables, up_w, dn_w, norb, singles, tau, wdt, streams)
