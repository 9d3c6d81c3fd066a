"""The older deterministic selection algorithms and the matrix-free
Lanczos solvers (port of sqmc_tpu/algo/legacy_ci.py).

  * perform_selected_ci (ref: semistoch.f90:893-1297): from HF, apply the
    projector 1 + tau (E_ref - H) through the connections of the
    largest-|c| initiators, truncate to n_truncate by |c|, and finally
    diagonalize H in the surviving set;
  * perform_truncated_lanczos (ref: semistoch.f90:1299-1578): Krylov
    vectors built through the initiators, orthogonalized, truncated, and
    the exact H in the truncated Krylov space diagonalized each step;
  * matrix_lanczos_on_the_fly (ref: chemistry.f90:8680) and
    hubbard_lanczos_full (ref: hubbard.f90:6700): Lanczos with full
    reorthogonalization over a fixed det list, H applied matrix-free.

Everything det-sized lives on the system's device: the connections
(``generate_connections`` with eps = 0), the sort / search set algebra,
the sparse vectors and the Krylov vectors.  The tridiagonal and Krylov
eigenproblems are small and stay on the host in numpy.  The matrix-free
H application runs over the references in chunks and computes the
diagonal once per Lanczos; where up and dn fit one int64 key (one word,
2 norb <= 62 bits) the det lookup is a ``torch.searchsorted`` over the
fused keys.  Both H applications accumulate with ``index_put_(accumulate=
True)``, which sums duplicates in a fixed order on the card (``index_add_``
uses atomics): a truncation to the largest |c| cuts through shells of
equal |c| on a symmetric lattice, and one rounding there changes the
selected dets, so the selected CI and the truncated Lanczos give the same
dets on every run.
"""

from __future__ import annotations

from itertools import combinations
from typing import NamedTuple

import numpy as np
import torch

from .. import dets as dets_mod
from ..ops import setalg
from .connect import generate_connections
from .davidson import davidson
from .sparseham import build_sparse_ham, diag_elements_batched


def _diag_elements(system, up, dn) -> torch.Tensor:
    return diag_elements_batched(system.table, up, dn, system.norb)


def _f64(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def _words(x, dev) -> torch.Tensor:
    """int64 det words on `dev` (numpy words of either signedness)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.ascontiguousarray(x).view(np.int64), device=dev)


def _zeros(n, dev) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float64, device=dev)


def _finder(up, dn, norb: int):
    """Index of each query det in the sorted list up / dn (-1 if absent):
    a searchsorted over fused (up << norb | dn) keys when one int64 holds
    both (the key order is the det order there), else the set algebra's
    bisection."""
    if up.shape[1] > 1 or 2 * norb > 62:
        return lambda qu, qd: setalg.search_dets(up, dn, qu, qd)
    keys = (up[:, 0] << norb) | dn[:, 0]
    n = len(keys)

    def find(qu, qd):
        if n == 0:
            return torch.full((len(qu),), -1, dtype=torch.int64,
                              device=qu.device)
        qk = (qu[:, 0] << norb) | qd[:, 0]
        pos = torch.searchsorted(keys, qk).clamp(max=n - 1)
        return torch.where(keys[pos] == qk, pos, torch.full_like(pos, -1))
    return find


def apply_h(system, up, dn, c, n_initiators: int | None = None):
    """y = H c expanded through the connections of the top-|c|
    n_initiators references: every reference adds into existing rows,
    only initiators open new rows (the initiator rule, ref
    semistoch.f90:988-1016).  Returns (u_up, u_dn, y, c_on_union) over
    the sorted union det list, on the system's device."""
    dev = system.device
    up, dn, c = _words(up, dev), _words(dn, dev), _f64(c, dev)
    n = len(up)
    n_init = n if n_initiators is None else min(n_initiators, n)
    init_rows = torch.argsort(-c.abs(), stable=True)[:n_init]
    cu, cd, _, _ = generate_connections(system, up[init_rows], dn[init_rows],
                                        _zeros(n_init, dev))
    u_up, u_dn, _, _ = setalg.unique_dets(torch.cat([up, cu]),
                                          torch.cat([dn, cd]))
    # off-diagonal contributions of every reference into the union
    cu2, cd2, h2, ref2 = generate_connections(system, up, dn, _zeros(n, dev))
    find = _finder(u_up, u_dn, system.norb)
    pos = find(cu2, cd2)
    ok = pos >= 0
    y = _zeros(len(u_up), dev)
    y.index_put_((pos[ok],), h2[ok] * c[ref2[ok]], accumulate=True)
    ref_pos = find(up, dn)
    y[ref_pos] += _diag_elements(system, u_up, u_dn)[ref_pos] * c
    c_u = _zeros(len(u_up), dev)
    c_u[ref_pos] = c
    return u_up, u_dn, y, c_u


def _truncate(up, dn, w, n_keep: int):
    """The n_keep largest-|w| entries with |w| > 0, sorted by det key."""
    order = torch.argsort(-w.abs(), stable=True)[:n_keep]
    order = order[w[order].abs() > 0]
    keep = order[setalg.lexsort_dets(up[order], dn[order])]
    return up[keep], dn[keep], w[keep]


class LegacyCIResult(NamedTuple):
    energy: float
    up: torch.Tensor            # [n, W] int64, sorted
    dn: torch.Tensor
    coef: np.ndarray            # [n] float64
    energies_per_iter: list


def _start_vector(system, start):
    dev = system.device
    if start is not None:
        return (_words(start[0], dev), _words(start[1], dev),
                _f64(start[2], dev))
    return (torch.as_tensor(system.hf_up[None], device=dev),
            torch.as_tensor(system.hf_dn[None], device=dev),
            torch.ones(1, dtype=torch.float64, device=dev))


def perform_selected_ci(system, iters: int, n_initiators, n_truncate,
                        tau: float = 0.01, verbose: bool = False,
                        start=None) -> LegacyCIResult:
    """ref: perform_selected_ci (semistoch.f90:893).  n_initiators and
    n_truncate may be scalars or per-iteration schedules.  start: optional
    (up, dn, coef) initial vector, e.g. the degenerate-HF multiplet the
    reference uses for hubbardk (semistoch.f90:966-973)."""
    n_init = np.broadcast_to(np.asarray(n_initiators), (iters,))
    n_trunc = np.broadcast_to(np.asarray(n_truncate), (iters,))
    up, dn, c = _start_vector(system, start)
    e_ref = float(_diag_elements(system, up, dn)[0])
    energies = []
    for it in range(iters):
        u_up, u_dn, y, c_u = apply_h(system, up, dn, c,
                                     n_initiators=int(n_init[it]))
        w = c_u + tau * (e_ref * c_u - y)
        up, dn, c = _truncate(u_up, u_dn, w, int(n_trunc[it]))
        c = c / torch.linalg.norm(c)
        # Rayleigh quotient for the running energy estimate
        _, _, y2, c2 = apply_h(system, up, dn, c, n_initiators=0)
        e_ref = float(torch.dot(c2, y2) / torch.dot(c2, c2))
        energies.append(e_ref)
        if verbose:
            print(f"selected_ci iter {it + 1}: ndet={len(up)} "
                  f"E={e_ref:.8f}")
    # final diagonalization in the selected space (ref :1240
    # rediagonalize=.true.)
    H = build_sparse_ham(system.table, up, dn, system.nup, system.ndn,
                         system.norb, time_sym=system.time_sym, z=system.z)
    evals, evecs = davidson(H, n_states=1)
    if verbose:
        print(f"selected_ci final: ndet={len(up)} E={evals[0]:.8f}")
    return LegacyCIResult(float(evals[0]), up, dn, np.asarray(evecs[:, 0]),
                          energies)


def _sparse_dot(a, b, norb: int) -> float:
    """Dot of two sparse det vectors (up, dn, coef); b searched in a."""
    pos = _finder(a[0], a[1], norb)(b[0], b[1])
    ok = pos >= 0
    return float(torch.dot(a[2][pos[ok]], b[2][ok]))


def _subtract(vec, v, ov: float, norb: int):
    """vec[2] -= ov * v[2] on the rows of v present in vec (in place)."""
    pos = _finder(vec[0], vec[1], norb)(v[0], v[1])
    ok = pos >= 0
    vec[2][pos[ok]] -= ov * v[2][ok]


def perform_truncated_lanczos(system, iters: int, n_initiators: int,
                              n_truncate: int, verbose: bool = False,
                              start=None) -> LegacyCIResult:
    """ref: perform_truncated_lanczos (semistoch.f90:1299).  Returns the
    Krylov ground state of the final iteration over the union of the
    truncated Krylov vectors' dets.  Lanczos converges to the lowest
    eigenstate that overlaps `start` (default the HF det; pass the
    symmetrized degenerate-HF multiplet for a degenerate shell, as the
    reference does, semistoch.f90:1370-1376)."""
    norb = system.norb
    up, dn, c = _start_vector(system, start)
    if start is not None:
        c = c / torch.linalg.norm(c)
    vecs = [(up, dn, c)]                       # orthonormal Krylov vectors
    hu0, hd0, hy0, _ = apply_h(system, up, dn, c, n_initiators=0)
    h00 = _sparse_dot((hu0, hd0, hy0), (up, dn, c), norb)
    K = np.zeros((iters, iters))
    K[0, 0] = h00
    energies = [h00]
    for it in range(1, iters):
        pu, pd, pc = vecs[-1]
        u_up, u_dn, y, _ = apply_h(system, pu, pd, pc,
                                   n_initiators=n_initiators)
        # orthogonalize H v against every previous vector (ref step 2)
        w = (u_up, u_dn, y.clone())
        for v in vecs:
            _subtract(w, v, _sparse_dot(w, v, norb), norb)
        w2 = _truncate(*w, n_truncate)
        # re-orthogonalize the truncated vector (ref step 4)
        for v in vecs:
            _subtract(w2, v, _sparse_dot(w2, v, norb), norb)
        nrm = float(torch.linalg.norm(w2[2]))
        if nrm < 1e-12:
            break
        w2 = (w2[0], w2[1], w2[2] / nrm)
        vecs.append(w2)
        # the exact H in the Krylov space (ref step 6): H v_k through ALL
        # connections, so that rows of the other vectors are represented
        hu, hd, hy, _ = apply_h(system, *w2)
        k = len(vecs) - 1
        for i, v in enumerate(vecs):
            K[i, k] = K[k, i] = _sparse_dot((hu, hd, hy), v, norb)
        evals, _ = np.linalg.eigh(K[:k + 1, :k + 1])
        energies.append(float(evals[0]))
        if verbose:
            print(f"trunc_lanc iter {it + 1}: ndet={len(w2[0])} "
                  f"E={evals[0]:.8f}")
    # the ground state over the union of the Krylov supports
    m = len(vecs)
    evals, evecs = np.linalg.eigh(K[:m, :m])
    g_up, g_dn, _, _ = setalg.unique_dets(torch.cat([v[0] for v in vecs]),
                                          torch.cat([v[1] for v in vecs]))
    coef = _zeros(len(g_up), system.device)
    find = _finder(g_up, g_dn, norb)
    for i, (vu, vd, vc) in enumerate(vecs):
        coef[find(vu, vd)] += float(evecs[i, 0]) * vc
    coef = coef / torch.linalg.norm(coef)
    return LegacyCIResult(float(evals[0]), g_up, g_dn, coef.cpu().numpy(),
                          energies)


def apply_h_on_the_fly(system, up, dn, x, diag=None, chunk: int = 1 << 18):
    """y = H x restricted to a fixed key-sorted det list, matrix-free: the
    connections are regenerated per application, `chunk` references at a
    time, instead of storing the sparse matrix (ref: apply_H_on_the_fly,
    chemistry.f90:8865).  diag: the list's diagonal elements, computed
    here when not given."""
    dev = system.device
    up, dn, x = _words(up, dev), _words(dn, dev), _f64(x, dev)
    if diag is None:
        diag = _diag_elements(system, up, dn)
    y = diag * x
    find = _finder(up, dn, system.norb)
    for beg in range(0, len(up), chunk):
        end = min(beg + chunk, len(up))
        cu, cd, h, ref = generate_connections(
            system, up[beg:end], dn[beg:end], _zeros(end - beg, dev),
            batch=end - beg)
        pos = find(cu, cd)
        ok = pos >= 0
        y.index_put_((pos[ok],), h[ok] * x[beg + ref[ok]], accumulate=True)
    return y


def matrix_lanczos_on_the_fly(system, up, dn, iters: int = 40,
                              tol: float = 1e-10, seed: int = 0,
                              verbose: bool = False, chunk: int = 1 << 18,
                              random_start: bool = False):
    """Lowest eigenpair of H over a fixed det list by Lanczos with
    matrix-free H applications and full reorthogonalization (ref:
    matrix_lanczos_on_the_fly, chemistry.f90:8680, for when the sparse
    matrix does not fit).  The Krylov vectors stay on the system's
    device, the tridiagonal eigenproblem on the host.  The start is the
    lowest-diagonal det, as in the JAX package, or with random_start a
    normal vector from a torch.Generator seeded with `seed`: a single det
    can lie in a symmetry sector without the ground state (the 2x3
    periodic Hubbard lattice at 3 + 3), a random vector overlaps every
    sector.  Returns (energy, vec), vec a float64 tensor in the order of
    the given list."""
    dev = system.device
    up, dn = _words(up, dev), _words(dn, dev)
    order = setalg.lexsort_dets(up, dn)
    up, dn = up[order], dn[order]
    n = len(up)
    diag = _diag_elements(system, up, dn)
    if random_start:
        gen = torch.Generator(device=dev).manual_seed(seed)
        v = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
        v /= torch.linalg.norm(v)
    else:
        v = _zeros(n, dev)
        v[int(torch.argmin(diag))] = 1.0
    V = [v]
    alphas, betas = [], []
    e_prev = np.inf
    for it in range(min(iters, n)):
        w = apply_h_on_the_fly(system, up, dn, V[-1], diag=diag, chunk=chunk)
        alphas.append(float(torch.dot(V[-1], w)))
        for vk in V:                      # full reorthogonalization
            w -= float(torch.dot(vk, w)) * vk
        T = np.diag(alphas)
        for k, b in enumerate(betas):
            T[k, k + 1] = T[k + 1, k] = b
        evals, evecs = np.linalg.eigh(T)
        e = float(evals[0])
        if verbose:
            print(f"lanczos_on_the_fly it={it + 1} E={e:.10f}", flush=True)
        b = float(torch.linalg.norm(w))
        if abs(e - e_prev) < tol or b < 1e-12:
            break
        e_prev = e
        betas.append(b)
        V.append(w / b)
    vec = _zeros(n, dev)
    for k, ck in enumerate(evecs[:len(V), 0]):
        vec += float(ck) * V[k]
    vec /= torch.linalg.norm(vec)
    inv = torch.empty(n, dtype=torch.int64, device=dev)
    inv[order] = torch.arange(n, device=dev)
    return e, vec[inv]


def hubbard_lanczos_full(system, iters: int = 60, tol: float = 1e-10,
                         verbose: bool = False, chunk: int = 1 << 18,
                         random_start: bool = False, seed: int = 0):
    """Full-space Lanczos ground state of a Hubbard system (ref:
    arnoldi_hubbard_binary_search, hubbard.f90:6700): every det of the
    (nup, ndn) sector, sorted by key on the system's device, through
    matrix_lanczos_on_the_fly (random_start, seed: its start vector).
    Returns (energy, vec, up, dn)."""
    norb, nup, ndn = system.norb, system.nup, system.ndn
    dev = system.device
    ups = torch.as_tensor(np.stack([dets_mod.det_from_orbs(o, norb)
                                    for o in combinations(range(norb), nup)]),
                          device=dev)
    dns = torch.as_tensor(np.stack([dets_mod.det_from_orbs(o, norb)
                                    for o in combinations(range(norb), ndn)]),
                          device=dev)
    up = ups.repeat_interleave(len(dns), dim=0)
    dn = dns.repeat(len(ups), 1)
    order = setalg.lexsort_dets(up, dn)
    up, dn = up[order], dn[order]
    del order
    e, vec = matrix_lanczos_on_the_fly(system, up, dn, iters=iters, tol=tol,
                                       seed=seed, verbose=verbose, chunk=chunk,
                                       random_start=random_start)
    return e, vec, up, dn
