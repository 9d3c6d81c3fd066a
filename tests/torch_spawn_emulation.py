"""numpy emulation of the arithmetic of the heat-bath proposal kernel K3b
(sqmc_tpu_torch/csrc/hbselect.cu, entry sqmc_hb_spawn), and the inputs
that test it.

K3b runs the heat-bath selection (tests/torch_hb_emulation.py emulates
its sums) and then finishes each slot in the op order of the plain version
(sqmc_tpu_torch/ops/hbspawn.py `propose_plain`), one IEEE rounding an op
in the type torch promotes the operands to.  The one place where it adds
in an order of its own is a single's element: the two sums over the
orbitals run in ascending q over the occupied ones only (an empty q adds
a zero to the plain version's sum).  :func:`emulate_hb_spawn` does each
slot's ops in that order with numpy float32 / float64 arrays, vectorized
over the slots.

tests/test_torch_cuda.py holds the kernel bit for bit to this emulation on
the card; tests/test_torch_hbspawn.py holds the emulation bit for bit to
the plain version on the CPU (on tables whose sums are exact in any order).
The shapes the kernel is tested at, their inputs and the comparison of
the kernel with its plain version (:func:`compare_with_plain`) are here
too, for the card tests and chip_smoke.py's phase 2d alike.  The module
imports numpy; the functions that build inputs import torch and the port,
and nothing imports jax, so the card can use it.
"""

import numpy as np

import torch_hb_emulation as hb

F32, F64, I64 = np.float32, np.float64, np.int64
NO_SINGLES, PACK, ROWS = 0, 1, 2


def _get(words, orb):
    """dets.get_orb on [cap, W] int64 words: bit orb mod 64 of word 0 for
    one word, of word floor(orb / 64) for several."""
    u = words.view(np.uint64)
    W = u.shape[1]
    bit = np.left_shift(np.uint64(1), (orb & 63).astype(np.uint64))
    if W == 1:
        return (u[:, 0] & bit) != 0
    hit = np.zeros(len(orb), bool)
    for k in range(W):
        hit |= ((orb >> 6) == k) & ((u[:, k] & bit) != 0)
    return hit


def _mask_lt(x):
    x = np.clip(x, 0, 64)
    m = np.left_shift(np.uint64(1), np.minimum(x, 63).astype(np.uint64)) \
        - np.uint64(1)
    return np.where(x >= 64, np.uint64(0xFFFFFFFFFFFFFFFF), m)


def _popcount(x):
    """Set bits of each uint64 (SWAR)."""
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = ((x & np.uint64(0x3333333333333333))
         + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333)))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(I64)


def _count_below(words, lo, hi):
    u = words.view(np.uint64)
    a, b = np.minimum(lo, hi), np.maximum(lo, hi)
    c = np.zeros(len(lo), I64)
    for k in range(u.shape[1]):
        c += _popcount(u[:, k] & (_mask_lt(b - 64 * k) ^ _mask_lt(a - 64 * k)))
    return c


def _in_window(x, a, b):
    return ((x >= np.minimum(a, b)) & (x < np.maximum(a, b))).astype(I64)


def _parity(n):
    return np.where(n & 1, -1.0, 1.0)


def _move(words, c1, c2, s1, s2):
    """clear c1, c2 then set s1, s2 in every word (dets._bit_words)."""
    u = words.view(np.uint64).copy()
    W = u.shape[1]
    for k in range(W):
        def bit(o):
            b = np.left_shift(np.uint64(1), (o & 63).astype(np.uint64))
            return b if W == 1 else np.where((o >> 6) == k, b, np.uint64(0))
        u[:, k] = (u[:, k] & ~(bit(c1) | bit(c2))) | bit(s1) | bit(s2)
    return u.view(I64)


def _occupied(words, norb):
    """[cap, norb] bool occupancy of the first norb bits."""
    return hb.np_bits(words, norb) > 0


def emulate_hb_spawn(t, up, dn, norb, src, f64, tau, streams):
    """The kernel's outputs (spawn_up, spawn_dn, factor, ok) for numpy
    inputs: t a dict of the tables' arrays (R2, u_rowsum, hb_alias_q,
    hb_rs_own, hb_rs_partner, hb_start, hb_count, hb_rowsum, u_alias_q,
    u_alias_J, sng_pack, h, sing_dir, sing_exch, u_table), up / dn [cap, W]
    int64, src the singles source (NO_SINGLES, PACK, ROWS), f64 the
    state's precision, tau a float, streams (ub, up_, ue, ua2, ur)."""
    ub, up_, ue, ua2, ur = streams
    singles = src != NO_SINGLES
    WT = F64 if f64 else F32
    PS = WT if singles else F64
    sel, _, _ = hb.emulate_hb_select(up, dn, norb, t["R2"],
                                     t["u_rowsum"] if singles else None,
                                     up_, ue)
    cap = len(ub)
    tau = F64(tau)
    with np.errstate(divide="ignore", invalid="ignore"):
        m_tot = sel["m_tot"]
        if singles:
            ut = sel["utot"].astype(WT)
            tot = ut + (F32(0.5) * m_tot).astype(WT)
            psing = np.where(tot > 0, ut / tot, WT(0)).astype(WT)
            single = ub < psing.astype(F64)
        else:
            psing = np.zeros(cap, F64)
            single = np.zeros(cap, bool)

        # ---- doubles ----
        o1, o2 = sel["o1"].astype(I64), sel["o2"].astype(I64)
        fail = ((o1 == o2) | (m_tot <= 0) | (sel["s1q"] <= 0)
                | (sel["s2q"] <= 0) | (sel["p_pair_q"] <= 0))
        up1, up2 = o1 < norb, o2 < norb
        orb1, orb2 = np.where(up1, o1, o1 - norb), np.where(up2, o2, o2 - norb)
        same_up, opp = up1 & up2, up1 != up2
        pp = np.where(opp, np.where(up1, orb1, orb2), np.minimum(orb1, orb2))
        qq = np.where(opp, np.where(up1, orb2, orb1), np.maximum(orb1, orb2))
        a_s, b_s = np.minimum(pp, qq), np.maximum(pp, qq)
        ntri = norb * (norb - 1) // 2
        rc = np.where(opp, ntri + b_s * (b_s + 1) // 2 + a_s,
                      b_s * (b_s - 1) // 2 + a_s)
        st, cnt = t["hb_start"][rc], t["hb_count"][rc]
        n_cat = len(t["hb_alias_q"])
        k = np.minimum((ur * cnt.astype(F64)).astype(I64),
                       np.maximum(cnt - 1, 0))
        i0 = np.clip(st + k, 0, n_cat - 1)
        rv = np.where(ua2.astype(F32) < t["hb_alias_q"][i0],
                      t["hb_rs_own"][i0], t["hb_rs_partner"][i0])
        rs = np.abs(rv).astype(I64) - 1
        r_tab = rs // norb
        s_tab = rs - r_tab * norb
        swp = opp & (pp > qq)
        r, s = np.where(swp, s_tab, r_tab), np.where(swp, r_tab, s_tab)
        r_occ = np.where(opp | same_up, _get(up, r), _get(dn, r))
        s_occ = np.where(opp | ~same_up, _get(dn, s), _get(up, s))
        ok_d = ~(r_occ | s_occ)
        ws = np.where(same_up[:, None], up, dn)
        n_opp = (_count_below(up, pp, r) - _in_window(pp, pp, r)
                 + _count_below(dn, qq, s) - _in_window(qq, qq, s))
        n_same = (_count_below(ws, pp, r) - _in_window(pp, pp, r)
                  - _in_window(qq, pp, r) + _count_below(ws, qq, s)
                  - _in_window(pp, qq, s) - _in_window(qq, qq, s))
        hv = _parity(np.where(opp, n_opp, n_same)) * rv.astype(F64)
        sgn = np.sign(hv)
        den = ((PS(1) - psing.astype(PS))
               * sel["p_pair_q"].astype(WT).astype(PS)).astype(PS)
        den = np.where(den < PS(1e-30), PS(1e-30), den)
        fac_d = np.where(fail, 0.0,
                         ((-tau * sgn) * t["hb_rowsum"][rc].astype(WT)
                          .astype(F64)) / den.astype(F64))
        su_d = np.where(opp[:, None], _move(up, pp, pp, r, r),
                        np.where(same_up[:, None], _move(up, pp, qq, r, s), up))
        sd_d = np.where(opp[:, None], _move(dn, qq, qq, s, s),
                        np.where(same_up[:, None], dn, _move(dn, pp, qq, r, s)))
        if not singles:
            return su_d, sd_d, fac_d, ok_d

        # ---- singles ----
        U = F64 if src == ROWS else F32
        PU = F64 if F64 in (WT, U) else F32
        o_s = sel["o_s"].astype(I64)
        e_up = o_s < norb
        ps = np.where(e_up, o_s, o_s - norb)
        slot_r = np.minimum((ue * F64(norb)).astype(I64), norb - 1)
        ia = ps * norb + slot_r
        rs_ = np.where(ua2.astype(F32) < t["u_alias_q"][ia], slot_r,
                       t["u_alias_J"][ia])
        same = np.where(e_up[:, None], up, dn)
        other = np.where(e_up[:, None], dn, up)
        sgn_s = _parity(_count_below(same, ps, rs_) - (ps < rs_))
        cell = ps * norb + rs_
        if src == PACK:
            row = t["sng_pack"][cell]
            dir_, exch = row[:, :norb], row[:, norb:2 * norb]
            h, u_sel = row[:, 2 * norb], row[:, 2 * norb + 1]
        else:
            dir_, exch = t["sing_dir"][cell], t["sing_exch"][cell]
            h, u_sel = t["h"].reshape(-1)[cell], t["u_table"].reshape(-1)[cell]
        occ_s, occ_o = _occupied(same, norb), _occupied(other, norb)
        s1, s2 = np.zeros(cap, U), np.zeros(cap, U)
        for q in range(norb):            # ascending q, occupied ones only
            take = occ_s[:, q] & (q != ps) & (q != rs_)
            s1 = np.where(take, s1 + (dir_[:, q] - exch[:, q]), s1).astype(U)
            s2 = np.where(occ_o[:, q], s2 + dir_[:, q], s2).astype(U)
        hsum = ((h + s1) + s2).astype(U)
        h_sng = sgn_s * hsum.astype(F64)
        utc = np.where(ut < WT(1e-30), WT(1e-30), ut)
        psel = ((psing.astype(PU) * u_sel.astype(PU)) / utc.astype(PU)
                ).astype(PU)
        psel = np.where(psel < PU(1e-30), PU(1e-30), psel)
        w_s = (-tau * h_sng) / psel.astype(F64)
        diff = sel["c_s"].astype(F64)
        fac_s = np.where(diff > 0, w_s * (t["u_rowsum"][ps] / diff), w_s)
        ok_s = ~_get(same, rs_) & (u_sel > 0) & (diff > 0) & _get(same, ps)
        su_s = np.where(e_up[:, None], _move(up, ps, ps, rs_, rs_), up)
        sd_s = np.where(e_up[:, None], dn, _move(dn, ps, ps, rs_, rs_))
    pick = single[:, None]
    return (np.where(pick, su_s, su_d), np.where(pick, sd_s, sd_d),
            np.where(single, fac_s, fac_d), np.where(single, ok_s, ok_d))


def table_arrays(tables):
    """The numpy arrays of a WalkTables that emulate_hb_spawn reads."""
    out = {k: getattr(tables, k).cpu().numpy() for k in (
        "R2", "u_rowsum", "hb_alias_q", "hb_rs_own", "hb_rs_partner",
        "hb_start", "hb_count", "hb_rowsum", "u_alias_q", "u_alias_J",
        "sng_pack", "u_table")}
    tb = tables.table
    for k in ("h", "sing_dir", "sing_exch"):
        v = getattr(tb, k, None)
        out[k] = None if v is None else v.cpu().numpy()
    return out


def slot_inputs(rng, cap, norb, nup, ndn, walkers=None):
    """Parent dets and uniforms for cap slots: a third random dets (the
    first 7 rows empty, the next 7 the walk's empty-slot sentinel), the
    rest drawn from `walkers` = (up, dn) numpy words when given.  Returns
    (up, dn, streams)."""
    up = hb.random_dets(rng, cap, norb, nup)
    dn = hb.random_dets(rng, cap, norb, ndn)
    if walkers is not None:
        k = cap - cap // 3
        pick = rng.integers(0, len(walkers[0]), k)
        up[-k:], dn[-k:] = walkers[0][pick], walkers[1][pick]
    streams = tuple(rng.random(cap) for _ in range(5))
    return up, dn, streams


# ---------------------------------------------------------------------------
# The shapes the kernel is tested at (torch and the port, no jax)
# ---------------------------------------------------------------------------

# name: (system, f32 state, time_sym z or None)
SPAWN_CASES = {
    "c2_f32_pack": ("c2", True, None),       # the C2 walk cells' shape
    "heg14_f32": ("heg14", True, None),      # no singles
    "c2_f64_rows": ("c2", False, None),      # singles from the float64 rows
    "two_words_f32_pack": ("w2", True, None),  # norb = 70: two words a spin
    "heg38_f32": ("heg38", True, None),      # 38 electrons, 33 orbitals
    "heg54_f32": ("heg54", True, None),      # the heg54.walk cell's gas
    "heg17_f32": ("heg17", True, None),      # the first det past REG_NE
    "heg54_f32_tail": ("heg54", True, None),  # TAIL_CASES' layout
}

# the electron gases: (electrons, up electrons, cutoff radius) at r_s 0.5;
# past 16 electrons (one word a spin) K3b runs its wide kernel
HEG_SHAPES = {"heg14": (14, 7, 1.49), "heg17": (17, 9, 1.49),
              "heg38": (38, 19, 2.0), "heg54": (54, 27, 2.3)}

# shapes whose tables are made from a seed (synthetic_tables), not built
# from a system: name: (norb, up electrons, dn electrons).  norb124: two
# words a spin and 2 norb = 248 spin-orbitals, whose R2 (at its odd row
# stride, 247 KB) does not fit in the card's shared memory, so the kernel
# reads it through L1 / L2
SYNTHETIC_CASES = {"norb124_r2_in_l2": (124, 5, 5)}

# cases laid out as a generation hands its slots over: the slots past a
# spawn total that ends inside a warp are the all-bits sentinel, and the
# 40 slots before it hold dets with every spin-orbital but one occupied
# (more electrons than the walk's, past what the wide kernel's scratch
# holds a slot)
TAIL_CASES = ("heg54_f32_tail",)


def lay_out(case, up, dn, norb):
    """Give slot_inputs' dets ``up``, ``dn`` (in place) the layout of
    TAIL_CASES for such a case."""
    if case in TAIL_CASES:
        cap = len(up)
        total = cap - cap // 4 - 13          # not a multiple of 32
        full = (1 << norb) - 1
        up[total - 40:total], dn[total - 40:total] = full, full & ~1
        up[total:], dn[total:] = -1, -1


def electrons(case):
    """The walk's electrons a det in a SPAWN_CASES or SYNTHETIC_CASES
    shape."""
    if case in SYNTHETIC_CASES:
        return sum(SYNTHETIC_CASES[case][1:])
    kind = SPAWN_CASES[case][0]
    return HEG_SHAPES[kind][0] if kind in HEG_SHAPES else 8


def synthetic_tables(rng, norb, device):
    """Heat-bath tables of norb orbitals drawn from ``rng``, with singles
    from sng_pack (a float32 state): a WalkTables whose fields the
    heat-bath proposal does not read are None.  R2 exponential with a
    zero diagonal; each of the norb^2 pair rows (same-spin pairs
    first, then opposite-spin ones) 1-4 targets r * norb + s + 1 with a
    random sign and alias cell (r < s in a same-spin row); the singles'
    alias rows, row sums and U[p, r] positive, their integrals normal."""
    import torch

    from sqmc_tpu_torch.algo.walk import WalkTables
    n2, nn = 2 * norb, norb * norb
    R2 = rng.exponential(1.0, (n2, n2)).astype(F32)
    np.fill_diagonal(R2, 0.0)
    count = rng.integers(1, 5, nn)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    n_cat = int(count.sum())
    a = rng.integers(0, norb, n_cat)
    b = (a + rng.integers(1, norb, n_cat)) % norb        # b != a
    same = np.repeat(np.arange(nn) < norb * (norb - 1) // 2, count)
    r = np.where(same, np.minimum(a, b), a)
    s = np.where(same, np.maximum(a, b), rng.integers(0, norb, n_cat))
    code = lambda: (rng.choice([-1.0, 1.0], n_cat)  # noqa: E731
                    * (r * norb + s + 1)).astype(F32)
    pack = rng.normal(0.0, 0.1, (nn, n2 + 2)).astype(F32)
    pack[:, n2 + 1] = rng.uniform(0.1, 1.0, nn)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return WalkTables(*[None] * len(WalkTables._fields))._replace(
        R2=t(R2), u_rowsum=t(rng.uniform(0.5, 2.0, norb)),
        hb_alias_q=t(rng.random(n_cat).astype(F32)), hb_rs_own=t(code()),
        hb_rs_partner=t(code()), hb_start=t(start.astype(I64)),
        hb_count=t(count.astype(I64)),
        hb_rowsum=t(rng.uniform(0.1, 1.0, nn).astype(F32)),
        u_alias_q=t(rng.random(nn).astype(F32)),
        u_alias_J=t(rng.integers(0, norb, nn)), sng_pack=t(pack),
        u_table=t(np.zeros((0, 0))))


def two_word_system(device, seed=7):
    """A 70-orbital chem system (two words a spin, 4 + 4 electrons): random
    integrals over 12 live orbitals on both sides of the word boundary
    (0-5, 61-66); the others far up in energy in irreps of their own."""
    from sqmc_tpu_torch.systems.base import make_system_from_arrays
    from sqmc_tpu_torch.systems.chem.integrals import (n_eri, pair_index,
                                                        quad_index)
    npad = 70
    live = np.array([0, 1, 2, 3, 4, 5, 61, 62, 63, 64, 65, 66])
    n = len(live)
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, n))
    h = 0.5 * (h + h.T)
    eri = rng.normal(size=n_eri(n))
    hp = np.zeros((npad, npad))
    hp[np.ix_(live, live)] = h
    dead = np.setdiff1d(np.arange(npad), live)
    hp[dead, dead] = 100.0 + dead
    g = np.indices((n,) * 4).reshape(4, -1)
    erip = np.zeros(n_eri(npad))
    erip[quad_index(pair_index(live[g[0]], live[g[1]]),
                    pair_index(live[g[2]], live[g[3]]))] = \
        eri[quad_index(pair_index(g[0], g[1]), pair_index(g[2], g[3]))]
    sym = np.ones(npad, np.int32)
    sym[dead] = 2 + np.arange(len(dead))
    return make_system_from_arrays(hp, erip, 0.0, 4, 4, orb_sym=sym,
                                   device=device)


def one_det_trial(system):
    """A trial of the HF det alone (its C(T) and a one-det D)."""
    import torch
    from sqmc_tpu_torch.algo.semistoch import _assemble_trial
    dev = system.table.h.device
    u = torch.as_tensor(system.hf_up, device=dev)[None]
    d = torch.as_tensor(system.hf_dn, device=dev)[None]
    return _assemble_trial(system, u, d,
                           torch.ones(1, dtype=torch.float64, device=dev),
                           1, u, d)


def spawn_case(name, device, workdir, z=None):
    """(system, trial, cfg) of a SPAWN_CASES shape (z: the C2 system in
    the time-symmetrized basis of that sector, float64 state)."""
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig
    kind, f32 = (SPAWN_CASES[name][:2] if z is None else ("c2", False))
    if kind == "c2":
        from sqmc_tpu_torch.systems.base import make_chem_system
        from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump
        path = f"{workdir}/FCIDUMP"
        write_c2_fcidump(path)
        opts = {} if z is None else dict(time_sym=True, z=z, point_group="d2h",
                                         hf_symmetry=1 if z > 0 else 2)
        s = make_chem_system(path, device=device, **opts)
        trial = build_trial_wavefunction(s, eps_var=2e-2, n_psi_t=50,
                                         n_imp=100)
    elif kind in HEG_SHAPES:
        from sqmc_tpu_torch.systems.heg.system import make_heg_system
        s = make_heg_system(3, 0.5, *HEG_SHAPES[kind], device=device)
        trial = build_trial_wavefunction(s, eps_var=5e-2, n_psi_t=5, n_imp=5)
    else:
        s = two_word_system(device)
        trial = one_det_trial(s)
    cfg = WalkConfig(mwalk=8192, cap_spawn=8192, norb=s.norb, nup=s.nup,
                     ndn=s.ndn, n_words=s.n_words, tau=1e-3,
                     w_abs_target=1e3, has_singles=s.has_singles,
                     f32_state=f32, time_sym=s.time_sym, z=s.z)
    return s, trial, cfg


def exact_sum_tables(tables):
    """The walk tables with every table that the kernel and the plain
    version sum in different orders replaced by values whose sums are
    exact in any order: R2 and u_rowsum by integers (the selection), the
    singles rows (sng_pack's first 2 norb + 1 columns, or table.h,
    sing_dir and sing_exch) by multiples of 2^-8 (float32) or 2^-20
    (float64).  The other tables stay."""
    import dataclasses

    import torch
    R2 = torch.round(tables.R2 / tables.R2.max() * 64)
    u_rowsum = torch.ceil(tables.u_rowsum / tables.u_rowsum.max().clamp(
        min=1e-300) * 16)
    pack = tables.sng_pack.clone()
    if pack.numel():
        n = pack.shape[1] - 1
        pack[:, :n] = torch.round(pack[:, :n] * 256) / 256
    tb = tables.table
    if getattr(tb, "sing_dir", None) is not None:
        q = lambda x: torch.round(x * 2.0 ** 20) / 2.0 ** 20  # noqa: E731
        tb = dataclasses.replace(tb, h=q(tb.h), sing_dir=q(tb.sing_dir),
                                 sing_exch=q(tb.sing_exch))
    return tables._replace(R2=R2, u_rowsum=u_rowsum, sng_pack=pack, table=tb)


# ---------------------------------------------------------------------------
# The kernel against its plain version (the card tests and chip_smoke.py)
# ---------------------------------------------------------------------------

def spawn_inputs(case, dev, workdir, cap, seed, exact=False):
    """The walk tables of a SPAWN_CASES shape on ``dev`` (through
    exact_sum_tables where ``exact``) and (args of hbspawn.propose, numpy
    slot inputs): cap slots, a third random dets (empty ones and the
    all-bits sentinel among them), the rest the walk's own dets.  A
    SYNTHETIC_CASES shape: synthetic_tables and random dets alone, a
    float32 state with singles, tau 1e-3."""
    import torch
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    rng = np.random.default_rng(seed)
    if case in SYNTHETIC_CASES:
        norb, nup, ndn = SYNTHETIC_CASES[case]
        tables = synthetic_tables(rng, norb, dev)
        up, dn, streams = slot_inputs(rng, cap, norb, nup, ndn)
        singles, tau, wdt = True, t(np.float64(1e-3)), torch.float32
    else:
        from sqmc_tpu_torch.algo import walk as TW
        s, trial, cfg = spawn_case(case, dev, workdir)
        wdt = torch.float32 if cfg.f32_state else torch.float64
        tables = TW.build_walk_tables(s, trial, cfg)
        st = TW.init_walk_state(cfg, trial, 1e3, trial.e_trial, tables)
        n = int(st.nwalk)
        norb, singles, tau = s.norb, cfg.has_singles, st.tau
        up, dn, streams = slot_inputs(rng, cap, norb, s.nup, s.ndn,
                                      (st.up[:n].cpu().numpy(),
                                       st.dn[:n].cpu().numpy()))
        lay_out(case, up, dn, norb)
    if exact:
        tables = exact_sum_tables(tables)
    args = (tables, t(up), t(dn), norb, singles, tau, wdt,
            [t(u) for u in streams])
    return args, (up, dn, streams)


def singles_taken(args):
    """Which slots the proposal sends to a single: u_b < p_single, from
    the plain selection, as the plain version computes it."""
    import torch

    from sqmc_tpu_torch.ops import hbselect
    tables, up, dn, norb, singles, tau, wdt, streams = args
    if not singles:
        return torch.zeros(up.shape[0], dtype=torch.bool, device=up.device)
    sel = hbselect.hb_select_plain(up, dn, norb, tables.R2,
                                   tables.u_rowsum, streams[1], streams[2])
    ut, w2 = sel.utot.to(wdt), (0.5 * sel.m_tot).to(wdt)
    zero = torch.zeros((), dtype=torch.float64, device=up.device)
    return streams[0] < torch.where(ut + w2 > 0, ut / (ut + w2), zero)


def abs_singles(tables):
    """The tables with every term of a single's element made non-negative
    (h, (pr|qq) and -(pq|qr) by their absolute values): the element then
    reads the sum of the terms' magnitudes, which bounds the rounding of
    any order of the sums."""
    import dataclasses
    pack = tables.sng_pack.clone()
    if pack.numel():
        n = (pack.shape[1] - 2) // 2
        pack[:, :n] = pack[:, :n].abs()
        pack[:, n:2 * n] = -pack[:, n:2 * n].abs()
        pack[:, 2 * n] = pack[:, 2 * n].abs()
    tb = tables.table
    if tables.sng_pack.numel() == 0 and tb.sing_dir is not None:
        tb = dataclasses.replace(tb, h=tb.h.abs(), sing_dir=tb.sing_dir.abs(),
                                 sing_exch=-tb.sing_exch.abs())
    return tables._replace(sng_pack=pack, table=tb)


def compare_with_plain(args, got, ref):
    """Raise AssertionError unless the kernel's outputs ``got`` meet its
    plain version's ``ref`` on hbspawn.propose's ``args``: the same dtypes
    and shapes; the child's words and the flags bit for bit on every slot;
    a double's factor bit for bit; a single's factor within the rounding
    bound of reordering its two sums over the orbitals, 2 (norb + 2) u
    times the magnitude of its terms (u the unit roundoff of its rows),
    plus 8 float64 roundings after them; with singles, more than one slot
    in 50 takes one.  Returns a line with the slots that took a single,
    those whose factor differs, and the largest difference in units of
    the magnitude's u and relative to the factor."""
    import torch

    from sqmc_tpu_torch.ops import hbspawn
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
    for k in (0, 1, 3):
        assert torch.equal(got[k], ref[k]), k
    single = singles_taken(args)
    fac, fac_ref = got[2].view(torch.int64), ref[2].view(torch.int64)
    assert torch.equal(fac[~single], fac_ref[~single])
    n_single = int(single.sum())
    if not args[4]:
        assert n_single == 0
        return "doubles bitwise, no singles"
    assert n_single > args[1].shape[0] // 50
    mag = hbspawn.propose_plain(abs_singles(args[0]), *args[1:])[2]
    u = 2.0 ** -24 if args[0].sng_pack.numel() else 2.0 ** -53
    d = (got[2] - ref[2]).abs()[single]
    scale = mag.abs()[single]
    bound = (2 * (args[3] + 2) * u * scale
             + 8 * 2.0 ** -53 * ref[2].abs()[single])
    assert bool((d <= bound).all()), float((d / bound).max())
    return (f"singles={n_single} differ={int((d > 0).sum())} "
            f"max_diff_in_u_of_magnitude={float((d / (u * scale)).max()):.2f} "
            f"max_rel_diff={float((d / ref[2].abs()[single]).max()):.3e}")

