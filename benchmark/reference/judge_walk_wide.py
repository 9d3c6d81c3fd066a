"""The numbers that decide `correct` in a walk cell whose dets are too wide
for one int64 key: up to 62 orbitals, one word a spin.

The same numbers as judge_walk.numbers (see there for what each holds),
worked out the same way, with two differences:

  * a det is keyed on its pair of words (up, dn), ordered by two stable
    sorts (dn, then up), never on one shifted int64;
  * E_ref's PT enumerates, from each det of the D space, only the doubles
    that conserve momentum, from the electron gas's k-vectors (the plane
    waves of the cell's cutoff): (p, q) -> (r, s) with n_p + n_q = n_r +
    n_s.  The gas has no singles and every other double has a zero
    element, so this is the screened Epstein-Nesbet sum of
    judge_shci.pt_en over the same candidates, in blocks of dets, and it
    agrees with that full enumeration up to the order of the additions.

Everything else (the rows, the diagonals, the eigenpair, the control's
roundings) is the reference's own, as in judge_walk.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from . import eigen, judge_shci
from . import precision as P
from .slater import popcount

F64 = torch.float64
I64 = torch.int64
EPS = 1e-10


def _rel(x: float, ref: float) -> float:
    """|x - ref| / |ref|, infinite where ref is 0 and x is not (a walk
    left with no weight reads as broken, not as an error)."""
    if ref == 0:
        return 0.0 if x == 0 else math.inf
    return abs(x - ref) / abs(ref)


# -- dets keyed on their pair of words ---------------------------------------

def pair_order(up, dn):
    """The permutation that sorts the dets (up, dn) by up, then dn."""
    o = torch.argsort(dn, stable=True)
    return o[torch.argsort(up[o], stable=True)]


def _groups(su, sd):
    """For sorted dets: whether each row starts a new det."""
    new = torch.ones(len(su), dtype=torch.bool, device=su.device)
    new[1:] = (su[1:] != su[:-1]) | (sd[1:] != sd[:-1])
    return new


def n_unique(up, dn) -> int:
    """The number of distinct dets."""
    if len(up) == 0:
        return 0
    o = pair_order(up, dn)
    return int(_groups(up[o], dn[o]).sum())


def member(q_up, q_dn, p_up, p_dn):
    """Index in the pool (p_up, p_dn) of each query det (-1 when absent):
    pool and queries sorted together, pool rows first among equal dets,
    each query reading the last pool row at or before it."""
    n_p, dev = len(p_up), q_up.device
    u, d = torch.cat([p_up, q_up]), torch.cat([p_dn, q_dn])
    tag = torch.cat([torch.zeros(n_p, dtype=I64, device=dev),
                     torch.ones(len(q_up), dtype=I64, device=dev)])
    o = torch.argsort(tag, stable=True)
    o = o[torch.argsort(d[o], stable=True)]
    o = o[torch.argsort(u[o], stable=True)]
    is_pool = o < n_p
    at = torch.where(is_pool, torch.arange(len(o), device=dev), -1)
    last = torch.cummax(at, 0).values
    lc = last.clamp(min=0)
    hit = (last >= 0) & (u[o[lc]] == u[o]) & (d[o[lc]] == d[o])
    out = torch.full((len(q_up),), -1, dtype=I64, device=dev)
    q = ~is_pool
    out[o[q] - n_p] = torch.where(hit[q], o[lc[q]], -1)
    return out


# -- momentum-conserving doubles -----------------------------------------------

def kvectors(n_dim: int, cutoff: float) -> np.ndarray:
    """The integer vectors n of the plane waves, |n| <= cutoff, in the
    reference electron gas's orbital order (heg.integrals)."""
    if n_dim != 3:
        raise ValueError("the reference electron gas is three-dimensional")
    n_max = int(cutoff + EPS)
    r = np.arange(-n_max, n_max + 1)
    n = np.array([(a, b, c) for a in r for b in r for c in r])
    n = n[(n * n).sum(1) <= cutoff * cutoff + EPS]
    return n[np.argsort((n * n).sum(1), kind="stable")]


class Momentum:
    """The ordered orbital pairs of each total momentum: kid[a, b] names
    n_a + n_b, and tgt[kid] lists the pairs r * norb + s with that sum
    (padded with -1).  Checks that the vectors are the Hamiltonian's: its
    one-body part is diagonal and proportional to |n|^2."""

    def __init__(self, H, nvec: np.ndarray):
        norb = H.norb
        if len(nvec) != norb:
            raise ValueError(f"{len(nvec)} plane waves for {norb} orbitals")
        n2 = (nvec * nvec).sum(1)
        hd = torch.diagonal(H.h).cpu().numpy()
        scale = hd[n2 > 0] / n2[n2 > 0]
        off = H.h - torch.diag(torch.diagonal(H.h))
        if (len(scale) and np.ptp(scale) > 1e-12 * scale.max()) \
                or float(off.abs().max()) != 0.0 or hd[n2 == 0].any():
            raise ValueError("the k-vectors are not the Hamiltonian's basis")
        dev = H.h.device
        k = torch.as_tensor(nvec, dtype=I64, device=dev)
        tot = k[:, None, :] + k[None, :, :]
        span = int(2 * np.abs(nvec).max()) if len(nvec) else 0
        base = 2 * span + 1
        code = ((tot[..., 0] + span) * base + tot[..., 1] + span) * base \
            + tot[..., 2] + span
        uniq, inv = torch.unique(code.reshape(-1), return_inverse=True)
        counts = torch.bincount(inv, minlength=len(uniq))
        order = torch.argsort(inv, stable=True)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(norb * norb, device=dev) - start[inv[order]]
        self.tgt = torch.full((len(uniq), int(counts.max())), -1, dtype=I64,
                              device=dev)
        self.tgt[inv[order], rank] = order
        self.kid = inv.reshape(norb, norb)
        self.norb = norb

    def targets(self, p, q):
        """(r, s, listed) [..., L] of the pairs with n_r + n_s = n_p + n_q."""
        t = self.tgt[self.kid[p, q]]
        return t // self.norb, t % self.norb, t >= 0


def _bit(s, o):
    return (s[..., None] >> o) & 1


def doubles(mom: Momentum, u, d, nup: int, ndn: int):
    """Every momentum-conserving double of each det (words u, d [B]):
    (child up, child dn, index of its det), flat.  Same-spin: p < q
    occupied, r < s empty in that spin; opposite: p up, q dn occupied, r
    up, s dn empty."""
    dev, norb = u.device, mom.norb
    ou, _ = judge_shci._occ_virt(u, nup, norb)
    od, _ = judge_shci._occ_virt(d, ndn, norb)
    one = torch.ones((), dtype=I64, device=dev)
    ref = torch.arange(len(u), device=dev)
    cu, cd, rf = [], [], []

    def same(s, occ, n_occ):
        c = torch.tensor(list(itertools.combinations(range(n_occ), 2)),
                         dtype=I64, device=dev).reshape(-1, 2)
        p, q = occ[:, c[:, 0]], occ[:, c[:, 1]]               # [B, C]
        r, t, ok = mom.targets(p, q)                          # [B, C, L]
        rc, tc = r.clamp(min=0), t.clamp(min=0)
        ok = ok & (r < t) & (_bit(s[:, None], rc) == 0) \
            & (_bit(s[:, None], tc) == 0)
        ch = (s[:, None, None] ^ (one << p[..., None]) ^ (one << q[..., None])
              ^ (one << rc) ^ (one << tc))
        return ch[ok], ref[:, None, None].expand_as(ok)[ok]

    ch, r_ = same(u, ou, nup)
    cu.append(ch), cd.append(d[r_]), rf.append(r_)
    ch, r_ = same(d, od, ndn)
    cu.append(u[r_]), cd.append(ch), rf.append(r_)
    p = ou[:, :, None].expand(-1, -1, ndn).reshape(len(u), -1)
    q = od[:, None, :].expand(-1, nup, -1).reshape(len(u), -1)
    r, t, ok = mom.targets(p, q)
    rc, tc = r.clamp(min=0), t.clamp(min=0)
    ok = ok & (_bit(u[:, None], rc) == 0) & (_bit(d[:, None], tc) == 0)
    cu.append((u[:, None, None] ^ (one << p[..., None]) ^ (one << rc))[ok])
    cd.append((d[:, None, None] ^ (one << q[..., None]) ^ (one << tc))[ok])
    rf.append(ref[:, None, None].expand_as(ok)[ok])
    return torch.cat(cu), torch.cat(cd), torch.cat(rf)


def pt_en(H, nvec, up, dn, c, e_var: float, nup: int, ndn: int, eps: float,
          block: int = 256):
    """judge_shci.pt_en's screened Epstein-Nesbet PT of the plain dets
    (up, dn) with coefficients c, over the momentum-conserving doubles:
    (PT, the unique candidates passing the screen with the space itself,
    each outside det's numerator and diagonal)."""
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
    o = pair_order(ku, kd)
    ku, kd, vals = ku[o], kd[o], vals[o]
    new = _groups(ku, kd)
    gid = torch.cumsum(new.to(I64), 0) - 1
    uu, ud = ku[new], kd[new]
    num = torch.zeros(len(uu), dtype=F64, device=up.device).index_add_(
        0, gid, vals)
    inside = member(uu, ud, up, dn) >= 0
    n_conn = len(uu) + int((member(up, dn, uu, ud) < 0).sum())
    eu, ed = uu[~inside], ud[~inside]
    diag = torch.cat([H.diag(eu[a:a + (1 << 20)], ed[a:a + (1 << 20)])
                      for a in range(0, len(eu), 1 << 20)]) if len(eu) \
        else torch.zeros(0, dtype=F64, device=up.device)
    pt = float((num[~inside] ** 2 / (e_var - diag)).sum())
    return pt, n_conn, num[~inside], diag


def reference_energy(H, nvec, iu, idn, nup: int, ndn: int, eps_pt: float):
    """(E_ref, E_var, PT) of the D space (plain dets iu, idn): the lowest
    eigenpair of H over it, then the momentum-conserving PT of that
    eigenvector."""
    if H.time_sym:
        raise ValueError("the wide judge reads plain determinants")
    e_var, v = eigen.lowest(eigen.dense(H, iu, idn))
    pt = pt_en(H, nvec, iu, idn, v, e_var, nup, ndn, eps_pt)[0]
    return e_var + pt, e_var, pt


def numbers(H, out: dict, control: dict | None = None,
            info: dict | None = None) -> dict:
    """judge_walk.numbers for dets of up to 62 orbitals; `out` holds the
    walk driver's outputs and the electron gas's `basis` (n_dim, cutoff
    radius), from which the PT takes its k-vectors."""
    dev = H.h.device
    t = lambda k: torch.as_tensor(out[k], device=dev)  # noqa: E731
    norb, nup, ndn = out["norb"], out["nup"], out["ndn"]
    if norb > 62:
        raise ValueError("one word a spin: at most 62 orbitals")
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
    bad = int(((up == -1) & occ).sum()) + int(((up != -1) & ~occ).sum())
    u, d, w = up[:nw], dn[:nw], wt[:nw]
    bad += int(((popcount(u) != nup) | (popcount(d) != ndn)
                | ((u >> norb) != 0) | ((d >> norb) != 0)).sum())
    bad += nw - n_unique(u, d)
    if out["time_sym"]:
        bad += int((u > d).sum())
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

