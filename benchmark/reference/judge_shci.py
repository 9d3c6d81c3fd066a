"""The numbers that decide `correct` in an SHCI cell.

The reference reads the program's selected dets and coefficients (its
output) and works out again, with its own matrix elements:

    e_var        |E_var(program) - c.Hc / c.c| / |.|
    pt           |PT(program) - PT| / |PT|, where PT is the screened
                 Epstein-Nesbet sum over every det a outside the space
                 reached from a det i of it by one or two excitations with
                 |H_ai| > eps_pt / |c_i|:  sum_a (sum_i H_ai c_i)^2 /
                 (E_var - H_aa), every excitation enumerated here
    n_connected  |n_connected(program) - the same count here| (the unique
                 candidates that pass the screen, with the space itself)
    ndets        |selected dets - the count the configuration states|
    e_var_eig    |E_var(program) - the lowest eigenvalue of H over the
                 program's dets| / |.|: H built and diagonalized here, so
                 a Davidson that stopped short shows
    e_var_stated |E_var(program) - the E_var the configuration states| /
                 |.|: a different space of the same size shows

The control puts the reference in the program's place in float32 (the
configuration states float64): E_var, each candidate's sum, the
denominators and the sums rounded through float32.
"""

from __future__ import annotations

import itertools

import torch

from . import eigen
from . import precision as P

F64 = torch.float64


def _occ_virt(s, n_occ, norb):
    """Occupied and empty orbitals of each string, ascending: [B, n_occ],
    [B, norb - n_occ]."""
    orbs = torch.arange(norb, device=s.device)
    bits = (s[:, None] >> orbs[None, :]) & 1
    order = torch.argsort(1 - bits, dim=1, stable=True)
    return order[:, :n_occ], order[:, n_occ:]


def _singles(s, occ, virt):
    one = torch.ones_like(s)
    a = occ[:, :, None].expand(-1, -1, virt.shape[1])
    r = virt[:, None, :].expand(-1, occ.shape[1], -1)
    return (s[:, None, None] ^ (one[:, None, None] << a)
            ^ (one[:, None, None] << r)).reshape(len(s), -1)


def _doubles(s, occ, virt):
    dev = s.device
    po = torch.tensor(list(itertools.combinations(range(occ.shape[1]), 2)),
                      device=dev, dtype=torch.long).reshape(-1, 2)
    pv = torch.tensor(list(itertools.combinations(range(virt.shape[1]), 2)),
                      device=dev, dtype=torch.long).reshape(-1, 2)
    one = torch.ones_like(s)[:, None]
    rem = (one << occ[:, po[:, 0]]) | (one << occ[:, po[:, 1]])    # [B, O]
    add = (one << virt[:, pv[:, 0]]) | (one << virt[:, pv[:, 1]])  # [B, V]
    return (s[:, None, None] ^ rem[:, :, None] ^ add[:, None, :]).reshape(
        len(s), -1)


def candidates(H, up, dn, c, nup, ndn, eps, block=128):
    """Every det one or two excitations from a det of the space that
    passes |H_ai| > eps / |c_i|: (keys up << 31 | dn, H_ai c_i)."""
    norb = H.norb
    keys, vals = [], []
    ceff = torch.where(c.abs() == 0, torch.full_like(c, 1e-300), c.abs())
    for b in range(0, len(up), block):
        u, d, cc = up[b:b + block], dn[b:b + block], c[b:b + block]
        ou, vu = _occ_virt(u, nup, norb)
        od, vd = _occ_virt(d, ndn, norb)
        su, sd = _singles(u, ou, vu), _singles(d, od, vd)
        du, dd = _doubles(u, ou, vu), _doubles(d, od, vd)
        n, nsu, nsd = len(u), su.shape[1], sd.shape[1]
        rep = lambda x, k: x[:, None].expand(-1, k)  # noqa: E731
        cu = torch.cat([su, rep(u, nsd), du, rep(u, dd.shape[1]),
                        su[:, :, None].expand(-1, -1, nsd).reshape(n, -1)], 1)
        cd = torch.cat([rep(d, nsu), sd, rep(d, du.shape[1]), dd,
                        sd[:, None, :].expand(-1, nsu, -1).reshape(n, -1)], 1)
        ref = torch.arange(n, device=u.device)[:, None].expand_as(cu)
        cu, cd, ref = cu.reshape(-1), cd.reshape(-1), ref.reshape(-1)
        h = H.pairs(cu, cd, u[ref], d[ref])
        keep = h.abs() > eps / ceff[b:b + block][ref]
        keys.append((cu[keep] << 31) | cd[keep])
        vals.append(h[keep] * cc[ref[keep]])
    return torch.cat(keys), torch.cat(vals)


def pt_en(H, up, dn, c, e_var: float, nup: int, ndn: int, eps: float):
    """The screened Epstein-Nesbet PT of the space (plain dets up, dn with
    coefficients c, variational energy e_var): (PT, the unique candidates
    passing the screen with the space itself, each outside det's
    numerator sum_i H_ai c_i and diagonal H_aa)."""
    keys, vals = candidates(H, up, dn, c, nup, ndn, eps)
    var_keys = (up << 31) | dn
    uk, inv = torch.unique(keys, return_inverse=True)
    num = torch.zeros(len(uk), dtype=F64, device=up.device).index_add_(
        0, inv, vals)
    n_conn = int(torch.unique(torch.cat([uk, var_keys])).numel())
    vs, _ = torch.sort(var_keys)
    pos = torch.searchsorted(vs, uk).clamp(max=len(vs) - 1)
    ext = vs[pos] != uk
    ku = uk[ext]
    diag = H.diag(ku >> 31, ku & ((1 << 31) - 1))
    pt = float((num[ext] ** 2 / (e_var - diag)).sum())
    return pt, n_conn, num[ext], diag


def numbers(H, out: dict, control: str | None = None,
            info: dict | None = None) -> dict:
    """The cell's numbers from the program's outputs `out`; control: the
    precision the reference takes the program's place in; info, when
    given, gets the energies compared."""
    dev = H.h.device
    if H.time_sym:
        raise ValueError("the SHCI judge enumerates plain determinants")
    up = torch.as_tensor(out["up"], device=dev)
    dn = torch.as_tensor(out["dn"], device=dev)
    c = torch.as_tensor(out["coef"], device=dev).to(F64)
    res = {}
    hc = H.matvec(up, dn, up, dn, c)
    e_ref = float(c @ hc / (c @ c))
    e_prog = (float(P.dot(c, P.rnd(hc, control), control)
                    / P.dot(c, c, control)) if control else out["e_var"])
    res["e_var"] = abs(e_prog - e_ref) / abs(e_ref)
    e_low, _ = eigen.lowest(eigen.dense(H, up, dn))
    res["e_var_eig"] = abs(e_prog - e_low) / abs(e_low)
    res["e_var_stated"] = abs(e_prog - out["e_var_stated"]) \
        / abs(out["e_var_stated"])

    pt_ref, n_conn, num, diag = pt_en(H, up, dn, c, e_ref, out["nup"],
                                     out["ndn"], out["eps_pt"])
    if control:
        p = control
        terms = P.rnd(P.rnd(P.rnd(num, p) ** 2, p)
                      / P.rnd(P.rnd(torch.tensor(e_ref, device=dev), p)
                              - P.rnd(diag, p), p), p)
        pt_prog = float(P.rnd(terms.sum(), p))
    else:
        pt_prog = out["pt"]
    res["pt"] = abs(pt_prog - pt_ref) / abs(pt_ref)
    res["n_connected"] = float(abs((n_conn if control else out["n_connected"])
                                   - n_conn))
    res["ndets"] = float(abs(len(up) - out["ndets_stated"]))
    if info is not None:
        info.update(e_var=e_prog, e_var_rq=e_ref, e_low=e_low, pt=pt_prog,
                    pt_ref=pt_ref)
    return res
