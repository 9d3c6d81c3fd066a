"""One-body reduced density matrix, natural orbitals and the
natural-orbital FCIDUMP (port of sqmc_tpu/algo/rdm.py; ref: hci.f90
get_1rdm:3198, get_1rdm_with_pt:3400, generate_natorb_integrals:3554).

The RDM accumulates over the single-excitation det pairs of the sparse
Hamiltonian's sort-join (``sparseham.connected_pairs``), on the system's
device: each pair's orbitals (p, q) and fermion sign come from its XOR
bits, vectorized over pairs, and the products accumulate into a
flattened [norb * norb] float64 tensor with ``index_put_(accumulate=
True)``.  Natural orbitals diagonalize the RDM per irrep block with
numpy ``eigh`` on the host (the JAX package's rotation, column signs
included); the integral rotation is a float64 einsum on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dets as dets_mod
from ..ops import setalg
from ..systems.chem.fcidump import write_fcidump
from ..systems.chem.integrals import n_eri, pair_index, quad_index
from .sparseham import connected_pairs

__all__ = ["get_1rdm", "natural_orbitals", "rotate_integrals",
           "write_fcidump", "generate_natorb_fcidump",
           "first_order_pt_vector", "get_1rdm_with_pt",
           "expand_time_symmetrized"]


def _f64(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def _add_single_pairs(gamma, bu, bd, c, a, b, norb: int):
    """gamma[p, q] += gamma[q, p] += c_a c_b sign for the pairs (a, b) that
    differ by one single excitation in one spin (p occupied in a, q in b).
    gamma: flat [norb * norb] float64; bu / bd: uint8 bits [n, norb]."""
    du, dd = bu[a] ^ bu[b], bd[a] ^ bd[b]
    n_up = du.sum(dim=1, dtype=torch.int64) // 2
    n_dn = dd.sum(dim=1, dtype=torch.int64) // 2
    sing_up = (n_up == 1) & (n_dn == 0)
    sel = sing_up | ((n_dn == 1) & (n_up == 0))
    a, b, u_sel = a[sel], b[sel], sing_up[sel][:, None]
    if len(a) == 0:
        return
    diff = torch.where(u_sel, du[sel], dd[sel])
    src = torch.where(u_sel, bu[a], bd[a]).to(torch.int64)
    # the two differing orbitals, ascending; p is the one occupied in a
    pos = torch.argsort((diff == 0).to(torch.int8), dim=1, stable=True)[:, :2]
    p1, p2 = pos[:, 0], pos[:, 1]
    p_in_a = src.gather(1, p1[:, None])[:, 0] > 0
    p = torch.where(p_in_a, p1, p2)
    q = torch.where(p_in_a, p2, p1)
    # fermion sign: parity of the occupied orbitals strictly between p, q
    pref = torch.cumsum(src, dim=1) - src
    lo, hi = torch.minimum(p, q), torch.maximum(p, q)
    cnt = (pref.gather(1, hi[:, None])[:, 0] - pref.gather(1, lo[:, None])[:, 0]
           - ((p >= lo) & (p < hi)).to(torch.int64))
    val = c[a] * c[b] * torch.where(cnt % 2 == 0, 1.0, -1.0).to(torch.float64)
    gamma.index_put_((p * norb + q,), val, accumulate=True)
    gamma.index_put_((q * norb + p,), val, accumulate=True)


def get_1rdm(system, up, dn, wts, batch: int = 1 << 18) -> np.ndarray:
    """Spin-summed 1-RDM gamma[p, q] (float64 [norb, norb], host) of a CI
    wavefunction over the det list up / dn (int64 words [n, W])."""
    norb = system.norb
    dev = system.device
    up, dn = up.to(dev), dn.to(dev)
    c = _f64(wts, dev)
    bu, bd = dets_mod.to_bits(up, norb), dets_mod.to_bits(dn, norb)
    gamma = torch.zeros(norb * norb, dtype=torch.float64, device=dev)
    occ = bu.to(torch.float64) + bd.to(torch.float64)
    diag = torch.arange(norb, device=dev) * (norb + 1)
    gamma[diag] = (c[:, None] ** 2 * occ).sum(dim=0)
    a, b = connected_pairs(up, dn, system.nup, system.ndn, norb)
    for beg in range(0, len(a), batch):
        _add_single_pairs(gamma, bu, bd, c, a[beg:beg + batch],
                          b[beg:beg + batch], norb)
    return gamma.reshape(norb, norb).cpu().numpy()


def natural_orbitals(gamma: np.ndarray, orb_sym: np.ndarray):
    """Diagonalize the RDM within irrep blocks (host numpy eigh, as the
    JAX package); returns (occupations, rotation U [norb, norb]) with
    descending occupation inside each block."""
    gamma = np.asarray(gamma, np.float64)
    orb_sym = np.asarray(orb_sym)
    norb = gamma.shape[0]
    U = np.zeros((norb, norb))
    occs = np.zeros(norb)
    for irrep in np.unique(orb_sym):
        idx = np.nonzero(orb_sym == irrep)[0]
        w, v = np.linalg.eigh(gamma[np.ix_(idx, idx)])
        order = np.argsort(-w)
        occs[idx] = w[order]
        U[np.ix_(idx, idx)] = v[:, order]
    return occs, U


def rotate_integrals(table, U: np.ndarray) -> tuple:
    """Rotate h and the compact two-body array into the basis U (columns
    = new orbitals): the dense [norb]^4 tensor, four float64 einsums on
    the table's device.  Returns numpy (h2 [norb, norb], eri2 compact)."""
    norb = table.norb
    dev = table.device
    Ut = _f64(U, dev)
    h2 = Ut.T @ table.h @ Ut
    p = torch.arange(norb, device=dev)
    P, Q, R, S = torch.meshgrid(p, p, p, p, indexing="ij")
    V = table.eri[quad_index(pair_index(P, Q), pair_index(R, S))]
    V = torch.einsum("pi,pqrs->iqrs", Ut, V)
    V = torch.einsum("qj,iqrs->ijrs", Ut, V)
    V = torch.einsum("rk,ijrs->ijks", Ut, V)
    V = torch.einsum("sl,ijks->ijkl", Ut, V)
    # each compact entry from its canonical element (p >= q, r >= s,
    # pq >= rs): the one the JAX package's scatter writes last
    hi, lo = np.tril_indices(norb)
    npair = len(hi)
    pair_hi = np.empty(npair, np.int64)
    pair_lo = np.empty(npair, np.int64)
    pair_hi[pair_index(hi, lo)] = hi
    pair_lo[pair_index(hi, lo)] = lo
    qa, qb = np.tril_indices(npair)
    qorder = quad_index(qa, qb)
    ia, ib = np.empty_like(qorder), np.empty_like(qorder)
    ia[qorder], ib[qorder] = qa, qb
    assert len(qorder) == n_eri(norb)
    idx = [torch.as_tensor(x, device=dev) for x in
           (pair_hi[ia], pair_lo[ia], pair_hi[ib], pair_lo[ib])]
    return h2.cpu().numpy(), V[idx[0], idx[1], idx[2], idx[3]].cpu().numpy()


def generate_natorb_fcidump(system, up, dn, wts, path: str, nelec: int):
    """1-RDM -> natural orbitals -> rotated FCIDUMP at `path`.  Returns
    (occupations, U)."""
    gamma = get_1rdm(system, up, dn, wts)
    sym = np.asarray(system.table.orb_sym)
    occs, U = natural_orbitals(gamma, sym)
    h2, eri2 = rotate_integrals(system.table, U)
    write_fcidump(path, h2, eri2, system.table.core_energy, sym, nelec)
    return occs, U


def first_order_pt_vector(system, up, dn, wts, var_energy: float,
                          eps_pt_big: float):
    """PT dets outside the variational space with first-order coefficients
    c_a = sum_j H_aj c_j / (E_var - H_aa), |H_aj c_j| screened at
    eps_pt_big (ref: hci.f90 get_1rdm_with_pt:3400-3470).  Returns
    (up [m, W], dn [m, W], c1 [m] float64) on the system's device, sorted
    by det key."""
    from .connect import generate_connections
    from .pt import _diag

    dev = system.device
    up, dn = up.to(dev), dn.to(dev)
    c = _f64(wts, dev)
    coeffs = torch.where(c.abs() == 0.0, 1e-300, c.abs())
    cu, cd, h, ref = generate_connections(system, up, dn, eps_pt_big / coeffs)
    cu_u, cd_u, (num,), _ = setalg.unique_dets(cu, cd, [h * c[ref]])
    ext = setalg.setdiff_dets(cu_u, cd_u, up, dn)
    cu_e, cd_e = cu_u[ext], cd_u[ext]
    return cu_e, cd_e, num[ext] / (var_energy - _diag(system, cu_e, cd_e))


def get_1rdm_with_pt(system, up, dn, wts, var_energy: float,
                     eps_pt_big: float, batch: int = 1 << 18) -> np.ndarray:
    """1-RDM to the lowest nonzero order in PT:
    <psi|rho|psi> ~ <psi0|rho|psi0> + 2 <psi0|rho|psi1>
    (ref: get_1rdm_with_pt, hci.f90:3400)."""
    gamma0 = get_1rdm(system, up, dn, wts)
    pu, pd, c1 = first_order_pt_vector(system, up, dn, wts, var_energy,
                                       eps_pt_big)
    if len(pu) == 0:
        return gamma0
    norb = system.norb
    dev = system.device
    n0 = len(up)
    all_up = torch.cat([up.to(dev), pu])
    all_dn = torch.cat([dn.to(dev), pd])
    all_c = torch.cat([_f64(wts, dev), c1])
    # cross transition RDM: join var + PT lists, keep the cross pairs (each
    # once per orientation: the factor 2 of 2 <psi0|rho|psi1>)
    a, b = connected_pairs(all_up, all_dn, system.nup, system.ndn, norb)
    cross = (a < n0) != (b < n0)
    a, b = a[cross], b[cross]
    bu, bd = dets_mod.to_bits(all_up, norb), dets_mod.to_bits(all_dn, norb)
    gamma = torch.as_tensor(gamma0, device=dev).reshape(-1).clone()
    for beg in range(0, len(a), batch):
        _add_single_pairs(gamma, bu, bd, all_c, a[beg:beg + batch],
                          b[beg:beg + batch], norb)
    return gamma.reshape(norb, norb).cpu().numpy()


def expand_time_symmetrized(up, dn, wts, z: int = 1):
    """A time-symmetrized wavefunction (representatives) in the plain det
    basis (ref: convert_time_symmetrized_to_dets, hci.f90:4365):
    |rep> = (|up,dn> + z |dn,up>) / sqrt2 for up != dn, |up,up> as it is.
    Returns (up2, dn2, wts2) sorted by det key, on up's device."""
    dev = up.device
    w = _f64(wts, dev)
    sym = (up == dn).all(dim=1)
    s2 = 1.0 / np.sqrt(2.0)
    up2 = torch.cat([up[sym], up[~sym], dn[~sym]])
    dn2 = torch.cat([dn[sym], dn[~sym], up[~sym]])
    w2 = torch.cat([w[sym], w[~sym] * s2, z * w[~sym] * s2])
    order = setalg.lexsort_dets(up2, dn2)
    return up2[order], dn2[order], w2[order]
