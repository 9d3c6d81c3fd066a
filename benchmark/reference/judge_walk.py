"""The numbers that decide `correct` in a walk cell.

The walk is stochastic, so the reference cannot draw the program's
walkers again.  It follows the program from its own state: it reads the
walkers the timed window produced (dets and weights) and the trial
wavefunction set-up produced, and works out again, with its own matrix
elements, everything the program derived from them.  The start of that
chain, the trial and the D-space projector, is checked by itself.

    trial_energy  |E_T(program) - c.Hc / c.c| / |.|, Psi_T's dets and c
    d_space       over rows of the D-space projector drawn from the
                  seed, the larger of max |H_prog - H| / max |H| over
                  the off-diagonal entries and over the diagonal
    estimator     the larger relative gap of the mixed estimator's
                  numerator sum_i w_i (H Psi_T)_i and denominator
                  sum_i w_i <i|Psi_T> against the last generation's trace
    population    |sum_i |w_i| - the trace's w_abs| / sum_i |w_i|
    walkers       count of broken walker rows: an empty slot among the
                  occupied or a det past them, a det with the wrong
                  number of electrons or bits past norb, a det twice, a
                  time-symmetrized det not in its representative
                  orientation, a D det missing, a weight not finite, and
                  the state's walker count against the trace's
    stale         share of the close's |weight| on dets whose weight is
                  bit for bit the one they had at the window's start
    energy_mHa    |E_mix - E_ref| in mHa: E_mix is the window's mixed
                  energy (its summed numerators over its summed
                  denominators, every generation of the window), E_ref
                  the lowest eigenvalue of H over the D space plus the
                  screened Epstein-Nesbet PT of that eigenvector, both
                  worked out here.  The one number that holds what the
                  generations project: a spawn, a projection or a merge
                  that goes wrong moves the walk's stationary state

The control puts the reference in the program's place one precision
below what the configuration states for each quantity (precision.py):
Psi_T's energy and the diagonal in float32, the walker state and the
projector's entries as the traffic's `precision` says, lowered.  The
reference cannot walk, so `energy_mHa` reads the program's window in
the control too: its upper reading comes from the faults planted inside
the generation (faults.py).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import eigen, judge_shci
from . import precision as P
from .slater import SQRT2, popcount

F64 = torch.float64
D_ROWS = 64


def _keys(up, dn):
    """One int64 key a det (norb <= 31: up << 31 | dn)."""
    return (up << 31) | dn


def _member(keys, pool):
    """Index of each key in pool (-1 when absent)."""
    s, order = torch.sort(pool)
    pos = torch.searchsorted(s, keys).clamp(max=max(len(s) - 1, 0))
    hit = (s[pos] == keys) if len(s) else torch.zeros_like(keys, dtype=bool)
    return torch.where(hit, order[pos], -1)


def d_rows(n_imp: int, seed: int) -> np.ndarray:
    """The D-space rows compared, drawn from the seed."""
    rng = np.random.default_rng([seed, 16])
    return np.sort(rng.choice(n_imp, size=min(D_ROWS, n_imp), replace=False))


def reference_energy(H, iu, idn, nup: int, ndn: int, eps_pt: float):
    """(E_ref, E_var, PT) of the D space (words iu, idn): the lowest
    eigenpair of H over it, then the PT of that eigenvector over plain
    dets (a time-symmetrized eigenvector is written out in plain dets
    first: (u, d) and (d, u) each with c / sqrt 2, the second times z)."""
    e_var, v = eigen.lowest(eigen.dense(H, iu, idn))
    up, dn, c, Hp = iu, idn, v, H
    if H.time_sym:
        pair = iu != idn
        up = torch.cat([iu, idn[pair]])
        dn = torch.cat([idn, iu[pair]])
        c = torch.cat([torch.where(pair, v / SQRT2, v), H.z * v[pair] / SQRT2])
        Hp = copy.copy(H)
        Hp.time_sym = False
    pt = judge_shci.pt_en(Hp, up, dn, c, e_var, nup, ndn, eps_pt)[0]
    return e_var + pt, e_var, pt


def numbers(H, out: dict, control: dict | None = None,
            info: dict | None = None) -> dict:
    """The cell's numbers from the program's outputs `out` (see the walk
    driver's outputs()).  control: {quantity: precision} puts the
    reference in those precisions in the program's place.  info, when
    given, gets the energies that `energy_mHa` compares."""
    dev = H.h.device
    t = lambda k: torch.as_tensor(out[k], device=dev)  # noqa: E731
    norb, nup, ndn = out["norb"], out["nup"], out["ndn"]
    if norb > 31:
        raise ValueError("the walk judge keys a det in one int64 (norb <= 31)")
    res = {}

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
    if control:
        diag = ref[torch.arange(len(rows), device=dev), rows]
        prog = P.rnd(ref, control["projector"])
        prog[torch.arange(len(rows), device=dev), rows] = P.rnd(
            diag, control["diag"])
    else:
        prog = t("d_prog").to(F64)
    on = torch.zeros_like(ref, dtype=torch.bool)
    on[torch.arange(len(rows), device=dev), rows] = True
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
    keys = _keys(u, d)
    bad += nw - int(torch.unique(keys).numel())
    if out["time_sym"]:
        bad += int((u > d).sum())
    bad += int((_member(_keys(iu, idn), keys) < 0).sum())
    bad += int((~torch.isfinite(w)).sum())
    bad += abs(nw - int(out["nwalk_trace"]))
    res["walkers"] = float(bad)

    # the mixed estimator and the population of the last generation
    hpsi = H.matvec(u, d, pu, pd, c)
    at = _member(keys, _keys(pu, pd))
    cw = torch.where(at >= 0, c[at.clamp(min=0)], torch.zeros_like(w))
    num_r, den_r = float(w @ hpsi), float(w @ cw)
    pop_r = float(w.abs().sum())
    if control:
        s = control["state"]
        num_p, den_p = float(P.dot(w, hpsi, s)), float(P.dot(w, cw, s))
        pop_p = float(P.rnd(P.rnd(w.abs(), s).sum(), s))
    else:
        num_p, den_p, pop_p = out["e_num"], out["e_den"], out["w_abs"]
    res["estimator"] = max(abs(num_p - num_r) / abs(num_r),
                           abs(den_p - den_r) / abs(den_r))
    res["population"] = abs(pop_p - pop_r) / pop_r

    # weight left as it was at the window's start
    s_up, s_dn, s_wt = t("start_up"), t("start_dn"), t("start_wt")
    at = _member(keys, _keys(s_up, s_dn))
    same = (at >= 0) & (s_wt.to(F64)[at.clamp(min=0)] == w)
    res["stale"] = float(w[same].abs().sum() / w.abs().sum())

    # what the window's generations projected
    e_ref, e_var, pt = reference_energy(H, iu, idn, nup, ndn, out["eps_pt"])
    e_mix = out["e_num_sum"] / out["e_den_sum"]
    res["energy_mHa"] = 1e3 * abs(e_mix - e_ref)
    if info is not None:
        info.update(e_mix=e_mix, e_ref=e_ref, e_var_d=e_var, pt_d=pt,
                    gens=out["gens"])
    return res
