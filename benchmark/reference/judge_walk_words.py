"""The numbers that decide `correct` in a walk cell whose dets take W int64
words a spin (the electron gas past 64 plane waves).

The same numbers as judge_walk_wide.numbers (see judge_walk for what each
holds), worked out the same way, with these differences:

  * a det is a pair of strings [W] (reference/slater_words.py), keyed on
    all 2 W of its words, most significant first (up's words from the
    last to the first, then dn's), ordered by one stable sort a word;
  * E_ref's PT enumerates each D det's momentum-conserving doubles
    (judge_walk_wide.Momentum's pairs) with the orbitals read from the
    strings' occupations, and builds each child by flipping its four
    orbitals' bits; the lowest eigenvalue of H over D and each candidate's
    element come from slater_words.Hamiltonian.

The PT runs in blocks of D dets, so its candidates fit the card whatever
D's size.  Everything else (the rows, the eigenpair, the control's
roundings) is the reference's own, as in judge_walk_wide.
"""

from __future__ import annotations

import itertools
import math

import torch

from . import eigen
from . import precision as P
from . import slater_words as S
from .judge_walk_wide import Momentum, _rel, kvectors

F64 = torch.float64
I64 = torch.int64


# -- dets keyed on all their words -------------------------------------------

def keys(up, dn) -> torch.Tensor:
    """[n, 2 W] keys, most significant word first: up's words from the
    last to the first, then dn's."""
    return torch.cat([up.flip(-1), dn.flip(-1)], dim=-1)


def key_order(k) -> torch.Tensor:
    """The permutation that sorts the keys [n, K] lexicographically."""
    o = torch.arange(len(k), device=k.device)
    for c in range(k.shape[1] - 1, -1, -1):
        o = o[torch.argsort(k[o, c], stable=True)]
    return o


def _groups(sk):
    """For sorted keys: whether each row starts a new det."""
    new = torch.ones(len(sk), dtype=torch.bool, device=sk.device)
    new[1:] = (sk[1:] != sk[:-1]).any(-1)
    return new


def n_unique(up, dn) -> int:
    """The number of distinct dets."""
    if len(up) == 0:
        return 0
    k = keys(up, dn)
    return int(_groups(k[key_order(k)]).sum())


def member(q_up, q_dn, p_up, p_dn):
    """Index in the pool (p_up, p_dn) of each query det (-1 when absent):
    pool and queries sorted together, pool rows first among equal dets,
    each query reading the last pool row at or before it."""
    n_p, dev = len(p_up), q_up.device
    k = torch.cat([keys(p_up, p_dn), keys(q_up, q_dn)])
    tag = torch.cat([torch.zeros(n_p, dtype=I64, device=dev),
                     torch.ones(len(q_up), dtype=I64, device=dev)])
    o = torch.argsort(tag, stable=True)
    for c in range(k.shape[1] - 1, -1, -1):
        o = o[torch.argsort(k[o, c], stable=True)]
    is_pool = o < n_p
    at = torch.where(is_pool, torch.arange(len(o), device=dev), -1)
    last = torch.cummax(at, 0).values
    lc = last.clamp(min=0)
    hit = (last >= 0) & (k[o[lc]] == k[o]).all(-1)
    out = torch.full((len(q_up),), -1, dtype=I64, device=dev)
    q = ~is_pool
    out[o[q] - n_p] = torch.where(hit[q], o[lc[q]], -1)
    return out


# -- momentum-conserving doubles -----------------------------------------------

def _occupied(s, n_occ: int, norb: int):
    """Occupied orbitals of each string [B, W], ascending: [B, n_occ]."""
    b = S.bits(s, norb)
    return torch.argsort(1 - b, dim=1, stable=True)[:, :n_occ], b


def doubles(mom: Momentum, u, d, nup: int, ndn: int):
    """Every momentum-conserving double of each det (strings u, d [B, W]):
    (child up, child dn, index of its det), flat.  Same-spin: p < q
    occupied, r < s empty in that spin; opposite: p up, q dn occupied, r
    up, s dn empty."""
    dev, norb, W = u.device, mom.norb, u.shape[1]
    ou, bu = _occupied(u, nup, norb)
    od, bd = _occupied(d, ndn, norb)
    ref = torch.arange(len(u), device=dev)
    cu, cd, rf = [], [], []

    def empty(b, o):
        return b.gather(1, o.reshape(len(b), -1)).reshape(o.shape) == 0

    def same(s, b, occ, n_occ):
        c = torch.tensor(list(itertools.combinations(range(n_occ), 2)),
                         dtype=I64, device=dev).reshape(-1, 2)
        p, q = occ[:, c[:, 0]], occ[:, c[:, 1]]               # [B, C]
        r, t, ok = mom.targets(p, q)                          # [B, C, L]
        rc, tc = r.clamp(min=0), t.clamp(min=0)
        ok = ok & (r < t) & empty(b, rc) & empty(b, tc)
        i, j, _ = torch.nonzero(ok, as_tuple=True)
        flips = (S.onehot(p[i, j], W) ^ S.onehot(q[i, j], W)
                 ^ S.onehot(rc[ok], W) ^ S.onehot(tc[ok], W))
        return s[i] ^ flips, i

    ch, r_ = same(u, bu, ou, nup)
    cu.append(ch), cd.append(d[r_]), rf.append(r_)
    ch, r_ = same(d, bd, od, ndn)
    cu.append(u[r_]), cd.append(ch), rf.append(r_)
    p = ou[:, :, None].expand(-1, -1, ndn).reshape(len(u), -1)
    q = od[:, None, :].expand(-1, nup, -1).reshape(len(u), -1)
    r, t, ok = mom.targets(p, q)
    rc, tc = r.clamp(min=0), t.clamp(min=0)
    ok = ok & empty(bu, rc) & empty(bd, tc)
    i, j, _ = torch.nonzero(ok, as_tuple=True)
    cu.append(u[i] ^ S.onehot(p[i, j], W) ^ S.onehot(rc[ok], W))
    cd.append(d[i] ^ S.onehot(q[i, j], W) ^ S.onehot(tc[ok], W))
    rf.append(i)
    return torch.cat(cu), torch.cat(cd), torch.cat(rf)


def pt_en(H, nvec, up, dn, c, e_var: float, nup: int, ndn: int, eps: float,
          block: int = 64):
    """The screened Epstein-Nesbet PT of the plain dets (up, dn) with
    coefficients c, over the momentum-conserving doubles, `block` dets at
    a time: (PT, the unique candidates passing the screen with the space
    itself, each outside det's numerator and diagonal), in the order of
    judge_walk_wide.pt_en's outputs."""
    mom = Momentum(H, nvec)
    ceff = torch.where(c.abs() == 0, torch.full_like(c, 1e-300), c.abs())
    ku, kd, vals = [], [], []
    for b in range(0, len(up), block):
        u, d, cc = up[b:b + block], dn[b:b + block], c[b:b + block]
        cu, cd, rf = doubles(mom, u, d, nup, ndn)
        h = H.pairs(cu, cd, u[rf], d[rf])
        keep = h.abs() > eps / ceff[b:b + block][rf]
        ku.append(cu[keep]), kd.append(cd[keep])
        vals.append(h[keep] * cc[rf[keep]])
    ku, kd, vals = torch.cat(ku), torch.cat(kd), torch.cat(vals)
    k = keys(ku, kd)
    o = key_order(k)
    ku, kd, vals = ku[o], kd[o], vals[o]
    new = _groups(k[o])
    gid = torch.cumsum(new.to(I64), 0) - 1
    uu, ud = ku[new], kd[new]
    num = torch.zeros(len(uu), dtype=F64, device=up.device).index_add_(
        0, gid, vals)
    inside = member(uu, ud, up, dn) >= 0
    n_conn = len(uu) + int((member(up, dn, uu, ud) < 0).sum())
    eu, ed = uu[~inside], ud[~inside]
    diag = torch.cat([H.diag(eu[a:a + (1 << 18)], ed[a:a + (1 << 18)])
                      for a in range(0, len(eu), 1 << 18)]) if len(eu) \
        else torch.zeros(0, dtype=F64, device=up.device)
    pt = float((num[~inside] ** 2 / (e_var - diag)).sum())
    return pt, n_conn, num[~inside], diag


def reference_energy(H, nvec, iu, idn, nup: int, ndn: int, eps_pt: float):
    """(E_ref, E_var, PT) of the D space (strings iu, idn [n, W]): the
    lowest eigenpair of H over it, then the momentum-conserving PT of
    that eigenvector."""
    e_var, v = eigen.lowest(eigen.dense(H, iu, idn))
    pt = pt_en(H, nvec, iu, idn, v, e_var, nup, ndn, eps_pt)[0]
    return e_var + pt, e_var, pt


def numbers(H, out: dict, control: dict | None = None,
            info: dict | None = None) -> dict:
    """judge_walk_wide.numbers for dets of W words a spin; `out` holds the
    walk_words driver's outputs (every det as its strings [n, W]) and the
    electron gas's `basis` (n_dim, cutoff radius)."""
    dev = H.h.device
    t = lambda k: torch.as_tensor(out[k], device=dev)  # noqa: E731
    norb, nup, ndn = out["norb"], out["nup"], out["ndn"]
    if out["time_sym"]:
        raise ValueError("the words judge reads plain determinants")
    nvec = kvectors(out["basis"]["n_dim"], out["basis"]["cutoff_radius"])
    res = {}
    mv = dict(block=1 << 25) if dev.type == "cuda" else {}

    # Psi_T's energy
    pu, pd, c = t("psit_up"), t("psit_dn"), t("psit_coef").to(F64)
    if control:
        p = control["trial"]
        hc = P.rnd(H.matvec(pu, pd, pu, pd, P.rnd(c, p)), p)
        e_prog = float(P.dot(c, hc, p) / P.dot(c, c, p))
    else:
        e_prog = out["e_trial"]
    hc = H.matvec(pu, pd, pu, pd, c)
    e_ref = float(c @ hc / (c @ c))
    res["trial_energy"] = abs(e_prog - e_ref) / abs(e_ref)

    # the D-space projector's sampled rows
    iu, idn = t("imp_up"), t("imp_dn")
    rows = torch.as_tensor(out["d_rows"], device=dev)
    ref = H.rows(iu[rows], idn[rows], iu, idn)
    on = torch.zeros_like(ref, dtype=torch.bool)
    on[torch.arange(len(rows), device=dev), rows] = True
    if control:
        prog = P.rnd(ref, control["projector"])
        prog[on] = P.rnd(ref[on], control["diag"])
    else:
        prog = t("d_prog").to(F64)
    err = (prog - ref).abs()
    res["d_space"] = max(float(err[~on].max() / ref[~on].abs().max()),
                         float(err[on].max() / ref[on].abs().max()))

    # the walkers at the close
    up, dn, wt = t("walk_up"), t("walk_dn"), t("walk_wt").to(F64)
    nw = int(out["nwalk"])
    occ = torch.arange(len(up), device=dev) < nw
    empty = (up == -1).all(-1)
    bad = int((empty & occ).sum()) + int((~empty & ~occ).sum())
    u, d, w = up[:nw], dn[:nw], wt[:nw]
    bad += int(((S.count(u) != nup) | (S.count(d) != ndn)
                | S.past(u, norb) | S.past(d, norb)).sum())
    bad += nw - n_unique(u, d)
    bad += int((member(iu, idn, u, d) < 0).sum())
    bad += int((~torch.isfinite(w)).sum())
    bad += abs(nw - int(out["nwalk_trace"]))
    res["walkers"] = float(bad)

    # the mixed estimator and the population of the last generation
    hpsi = H.matvec(u, d, pu, pd, c, **mv)
    at = member(u, d, pu, pd)
    cw = torch.where(at >= 0, c[at.clamp(min=0)], torch.zeros_like(w))
    num_r, den_r = float(w @ hpsi), float(w @ cw)
    pop_r = float(w.abs().sum())
    if control:
        s = control["state"]
        num_p, den_p = float(P.dot(w, hpsi, s)), float(P.dot(w, cw, s))
        pop_p = float(P.rnd(P.rnd(w.abs(), s).sum(), s))
    else:
        num_p, den_p, pop_p = out["e_num"], out["e_den"], out["w_abs"]
    res["estimator"] = max(_rel(num_p, num_r), _rel(den_p, den_r))
    res["population"] = _rel(pop_p, pop_r)

    # weight left as it was at the window's start
    at = member(u, d, t("start_up"), t("start_dn"))
    s_wt = t("start_wt").to(F64)
    same = (at >= 0) & (s_wt[at.clamp(min=0)] == w)
    res["stale"] = float(w[same].abs().sum() / w.abs().sum())

    # what the window's generations projected
    e_ref, e_var, pt = reference_energy(H, nvec, iu, idn, nup, ndn,
                                        out["eps_pt"])
    # a walk with no weight left on Psi_T's dets has no mixed energy
    e_mix = (out["e_num_sum"] / out["e_den_sum"] if out["e_den_sum"]
             else math.nan)
    res["energy_mHa"] = 1e3 * abs(e_mix - e_ref)
    if info is not None:
        info.update(e_mix=e_mix, e_ref=e_ref, e_var_d=e_var, pt_d=pt,
                    gens=out["gens"])
    return res
