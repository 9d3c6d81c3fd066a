"""Variational Monte Carlo for Gutzwiller-projected Slater wavefunctions
on the Hubbard lattice: psi(R) = g^{D(R)} det(Phi_up[R_up]) det(Phi_dn[R_dn])
(port of sqmc_tpu/systems/hubbard/vmc.py).

ref: hubbard.f90 wf_type 'gutz' machinery - set_gutzwiller:1432,
compute_vmc_energy_gutz_wf:1061, Sherman-Morrison determinant ratios
det_ratio_hubbard:4346, choose_random_electron:1027.

The whole walker population advances together on one device: electron
positions [nw, ne], per-walker inverse Slater matrices [nw, ne, ne] updated
by batched Sherman-Morrison row replacements, and the local energy
evaluated over all electron hops of all walkers at once.  Every function
here is written for the batch (the JAX package writes them for one walker
and maps them); a sweep runs without a host sync, and on the card it is
one replay of a captured CUDA graph (utils/cudagraph.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...utils.cudagraph import GraphCache, StepGraph
from .meanfield import hopping_matrix

F64 = torch.float64


def neighbor_table(l_x: int, l_y: int, pbc: bool = True):
    """[nsites, 4] neighbor site ids (or -1 if not allowed): the four
    hop directions of the reference's get_nbr."""
    nsites = l_x * l_y
    nbr = -np.ones((nsites, 4), np.int32)

    def site(ix, iy):
        return ix * l_y + iy

    for ix in range(l_x):
        for iy in range(l_y):
            for d, (dx, dy) in enumerate(((1, 0), (-1, 0), (0, 1), (0, -1))):
                jx, jy = ix + dx, iy + dy
                ok = 0 <= jx < l_x and 0 <= jy < l_y
                if not ok and pbc:
                    # mirror make_hubbard_real_system: wrap only when the
                    # wrapped bond is not a duplicate of the open bond
                    if (dx and l_x > 2) or (dy and l_y > 2):
                        jx %= l_x
                        jy %= l_y
                        ok = True
                if ok:
                    nbr[site(ix, iy), d] = site(jx, jy)
    return nbr


class VmcState(NamedTuple):
    r_up: torch.Tensor       # [nw, nup] electron sites (int64)
    r_dn: torch.Tensor       # [nw, ndn]
    minv_up: torch.Tensor    # [nw, nup, nup] inverse of Phi_up[r_up, :]
    minv_dn: torch.Tensor
    rng_state: torch.Tensor  # generator.get_state()


def _occ(r, nsites: int):
    """[nw, nsites] occupancy (0/1, int64) from electron site lists."""
    out = torch.zeros((r.shape[0], nsites), dtype=torch.int64, device=r.device)
    return out.scatter_(1, r, 1)


def _sm_row_update(minv, k, v):
    """Batched Sherman-Morrison row replacement: row k[w] of walker w's
    matrix becomes v[w].  minv: [nw, ne, ne], k: [nw], v: [nw, ne];
    returns (ratio [nw], new_minv)."""
    vm = torch.einsum("wi,wij->wj", v, minv)               # [nw, ne]
    kk = k[:, None]
    ratio = vm.gather(1, kk)[:, 0]
    col_k = minv.gather(2, kk[:, None, :].expand(-1, minv.shape[1], 1))
    onehot = torch.zeros_like(vm).scatter_(1, kk, 1.0)
    corr = col_k * (vm - onehot)[:, None, :]
    return ratio, minv - corr / ratio[:, None, None]


def init_vmc(phi_up, phi_dn, l_x, l_y, n_walkers: int, seed: int = 0,
             pbc: bool = True, device="cuda"):
    """Start walkers from random non-overlapping (per spin) positions with
    nonsingular Slater matrices: drawn on the host with numpy (the JAX
    package's draws), then moved to `device`."""
    nsites = l_x * l_y
    phi_up, phi_dn = np.asarray(phi_up), np.asarray(phi_dn)
    nup = phi_up.shape[1]
    ndn = phi_dn.shape[1]
    rng = np.random.default_rng(seed)
    r_up = np.empty((n_walkers, nup), np.int64)
    r_dn = np.empty((n_walkers, ndn), np.int64)
    for w in range(n_walkers):
        while True:
            ru = rng.choice(nsites, nup, replace=False)
            rd = rng.choice(nsites, ndn, replace=False)
            if (abs(np.linalg.det(phi_up[ru])) > 1e-10 and
                    abs(np.linalg.det(phi_dn[rd])) > 1e-10):
                r_up[w], r_dn[w] = np.sort(ru), np.sort(rd)
                break
    minv_up = np.linalg.inv(phi_up[r_up])
    minv_dn = np.linalg.inv(phi_dn[r_dn])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return VmcState(torch.as_tensor(r_up, device=device),
                    torch.as_tensor(r_dn, device=device),
                    torch.as_tensor(minv_up, device=device),
                    torch.as_tensor(minv_dn, device=device),
                    gen.get_state())


def _local_energy(r_up, r_dn, minv_up, minv_dn, phi_up, phi_dn, nbr,
                  g, U, t, nsites: int):
    """E_L = U*D + sum_hops (-t) * psi(R')/psi(R) for every walker: [nw]."""
    occ_u = _occ(r_up, nsites)
    occ_d = _occ(r_dn, nsites)
    D = (occ_u * occ_d).sum(dim=1)

    def hops(r, minv, phi, occ_same, occ_opp):
        nw, ne = r.shape
        tgt = nbr[r]                                   # [nw, ne, 4]
        tgt_s = tgt.clamp(min=0)
        flat = tgt_s.reshape(nw, ne * 4)
        ok = (tgt >= 0) & (occ_same.gather(1, flat).reshape(nw, ne, 4) == 0)
        dD = torch.where(ok, occ_opp.gather(1, flat).reshape(nw, ne, 4)
                         - occ_opp.gather(1, r)[:, :, None], 0)
        # det ratio for electron k -> site tgt[k,d]: phi[tgt] @ minv[:,k]
        ratio = torch.einsum("wkdo,wok->wkd", phi[tgt_s], minv)
        amp = torch.where(ok, torch.pow(g, dD.to(F64)) * ratio, 0.0)
        return amp.sum(dim=(1, 2))

    kin = -t * (hops(r_up, minv_up, phi_up, occ_u, occ_d) +
                hops(r_dn, minv_dn, phi_dn, occ_d, occ_u))
    return U * D + kin


def _metropolis_step(gen, r_up, r_dn, minv_up, minv_dn, phi_up, phi_dn, nbr,
                     g, nsites: int):
    """One single-electron hop proposal per walker, accepted with
    min(1, |psi'/psi|^2)."""
    nw, nup = r_up.shape
    ndn = r_dn.shape[1]
    dev = r_up.device
    ie = torch.randint(0, nup + ndn, (nw,), device=dev, generator=gen)
    d = torch.randint(0, 4, (nw,), device=dev, generator=gen)
    u = torch.rand(nw, dtype=F64, device=dev, generator=gen)
    is_up = ie < nup
    k_up = torch.where(is_up, ie, 0).clamp(0, nup - 1)
    k_dn = torch.where(is_up, 0, ie - nup).clamp(0, ndn - 1)
    occ_u = _occ(r_up, nsites)
    occ_d = _occ(r_dn, nsites)
    src = torch.where(is_up, r_up.gather(1, k_up[:, None])[:, 0],
                      r_dn.gather(1, k_dn[:, None])[:, 0])
    tgt = nbr[src, d]
    same = torch.where(is_up[:, None], occ_u, occ_d)
    opp = torch.where(is_up[:, None], occ_d, occ_u)
    tgt_s = tgt.clamp(min=0)
    ok = (tgt >= 0) & (same.gather(1, tgt_s[:, None])[:, 0] == 0)
    dD = opp.gather(1, tgt_s[:, None])[:, 0] - opp.gather(1, src[:, None])[:, 0]

    ru_up, new_minv_up = _sm_row_update(minv_up, k_up, phi_up[tgt_s])
    ru_dn, new_minv_dn = _sm_row_update(minv_dn, k_dn, phi_dn[tgt_s])
    ratio = torch.where(is_up, ru_up, ru_dn) * torch.pow(g, dD.to(F64))
    accept = ok & (u < (ratio ** 2).clamp(max=1.0))

    up_sel = accept & is_up
    dn_sel = accept & ~is_up
    r_up = torch.where(up_sel[:, None],
                       r_up.scatter(1, k_up[:, None], tgt_s[:, None]), r_up)
    r_dn = torch.where(dn_sel[:, None],
                       r_dn.scatter(1, k_dn[:, None], tgt_s[:, None]), r_dn)
    minv_up = torch.where(up_sel[:, None, None], new_minv_up, minv_up)
    minv_dn = torch.where(dn_sel[:, None, None], new_minv_dn, minv_dn)
    return r_up, r_dn, minv_up, minv_dn


def _sweep_body(state: VmcState, gen, phi_up, phi_dn, nbr, g, U, t,
                nsteps: int, nsites: int):
    """nsteps Metropolis steps + the local energy, over the state's
    tensors (g a 0-dim float64 tensor on their device)."""
    r_up, r_dn, mu, md = state[:4]
    for _ in range(nsteps):
        r_up, r_dn, mu, md = _metropolis_step(
            gen, r_up, r_dn, mu, md, phi_up, phi_dn, nbr, g, nsites)
    e_loc = _local_energy(r_up, r_dn, mu, md, phi_up, phi_dn, nbr, g, U, t,
                          nsites)
    return state._replace(r_up=r_up, r_dn=r_dn, minv_up=mu,
                          minv_dn=md), {"e_loc": e_loc}


def vmc_sweep(state: VmcState, phi_up, phi_dn, nbr, g, U, t,
              nsteps: int, nsites: int):
    """nsteps Metropolis steps for every walker + one local-energy
    measurement, with no host sync.  Returns (new_state, e_loc [nw]).
    The random stream continues from state.rng_state.  On the card one
    replay of the captured sweep (_replay_sweep), the counterpart of the
    JAX package's jit over fori_loop; on the CPU the eager sweep."""
    if state.r_up.device.type != "cuda":
        return _vmc_sweep_eager(state, phi_up, phi_dn, nbr, g, U, t, nsteps,
                                nsites)
    return _replay_sweep(state, phi_up, phi_dn, nbr, g, U, t, nsteps, nsites)


def _vmc_sweep_eager(state: VmcState, phi_up, phi_dn, nbr, g, U, t,
                     nsteps: int, nsites: int):
    """vmc_sweep as eager operations: the CPU's path, and on the card the
    reference the captured sweep is held to."""
    dev = state.r_up.device
    gen = torch.Generator(device=dev)
    gen.set_state(state.rng_state)
    g = torch.as_tensor(g, dtype=F64, device=dev)
    new, stats = _sweep_body(state, gen, phi_up, phi_dn, nbr, g, U, t,
                             nsteps, nsites)
    return new._replace(rng_state=gen.get_state()), stats["e_loc"]


# The captured sweep and its generator: a new (orbitals, neighbors, g, U,
# t, nsteps, nsites, shapes, device) drops it before the next capture;
# run_vmc drops it when it returns.
_GRAPH = GraphCache()


def release_graphs() -> None:
    """Free the captured sweep and its memory pool."""
    _GRAPH.clear()


def _replay_sweep(state, phi_up, phi_dn, nbr, g, U, t, nsteps, nsites):
    """vmc_sweep through the captured sweep (on a CPU state the runner runs
    the same body eagerly): copy in, one replay, clones out."""
    dev = state.r_up.device

    def build(gen):
        # g on the device once, not copied from the host in every sweep
        g_t = torch.as_tensor(g, dtype=F64, device=dev)
        return StepGraph(
            lambda s: _sweep_body(s, gen, phi_up, phi_dn, nbr, g_t, U, t,
                                  nsteps, nsites),
            state._replace(rng_state=None), gen, ())
    gen, graph = _GRAPH.get(
        (id(phi_up), id(phi_dn), id(nbr), float(g), U, t, nsteps, nsites,
         state.r_up.shape, state.r_dn.shape, dev), dev, build)
    gen.set_state(state.rng_state)
    new, stats = graph.step(state._replace(rng_state=None))
    return new._replace(rng_state=gen.get_state()), stats["e_loc"]


def run_vmc(l_x, l_y, t, U, nup, ndn, g: float, phi_up=None, phi_dn=None,
            n_walkers: int = 256, n_sweeps: int = 200, n_eq: int = 50,
            steps_per_sweep: int = 10, seed: int = 0, pbc: bool = True,
            device="cuda"):
    """Gutzwiller VMC energy (mean, error) on `device` - ref
    compute_vmc_energy_gutz_wf (hubbard.f90:1061).  One host sync per
    sweep (the sweep's mean local energy)."""
    if phi_up is None:
        from .meanfield import hartree_fock
        phi_up, phi_dn, _ = hartree_fock(l_x, l_y, t, U, nup, ndn, pbc)
    nsites = l_x * l_y
    nbr = torch.as_tensor(neighbor_table(l_x, l_y, pbc), dtype=torch.int64,
                          device=device)
    pu = torch.as_tensor(np.asarray(phi_up), dtype=F64, device=device)
    pd = torch.as_tensor(np.asarray(phi_dn), dtype=F64, device=device)
    state = init_vmc(phi_up, phi_dn, l_x, l_y, n_walkers, seed, pbc,
                     device=device)
    es = []
    for sweep in range(n_sweeps):
        state, e_loc = vmc_sweep(state, pu, pd, nbr, g, U, t,
                                 steps_per_sweep, nsites)
        if sweep >= n_eq:
            es.append(float(e_loc.mean()))
        if (sweep + 1) % 50 == 0:
            # refresh inverses to kill Sherman-Morrison drift
            state = state._replace(minv_up=torch.linalg.inv(pu[state.r_up]),
                                   minv_dn=torch.linalg.inv(pd[state.r_dn]))
    release_graphs()
    es = np.asarray(es)
    return float(es.mean()), float(es.std() / np.sqrt(max(len(es) - 1, 1)))


def exact_vmc_energy(l_x, l_y, t, U, nup, ndn, g, phi_up, phi_dn,
                     pbc: bool = True):
    """Brute-force <psi|H|psi>/<psi|psi> of the Gutzwiller wavefunction by
    full enumeration on the host (small lattices; test oracle)."""
    import itertools
    nsites = l_x * l_y
    h = hopping_matrix(l_x, l_y, t, pbc)
    phi_up, phi_dn = np.asarray(phi_up), np.asarray(phi_dn)
    configs_u = list(itertools.combinations(range(nsites), nup))
    configs_d = list(itertools.combinations(range(nsites), ndn))

    def amp(u, d):
        D = len(set(u) & set(d))
        return (g ** D * np.linalg.det(phi_up[list(u)]) *
                np.linalg.det(phi_dn[list(d)]))

    num = 0.0
    den = 0.0
    psi = {}
    for u in configs_u:
        for d in configs_d:
            psi[(u, d)] = amp(u, d)
    for (u, d), a in psi.items():
        den += a * a
        num += a * a * U * len(set(u) & set(d))
        # hopping: move one electron, sign = (-1)^(crossings)
        for spin, occ in ((0, u), (1, d)):
            for k, s in enumerate(occ):
                for s2 in range(nsites):
                    if h[s, s2] == 0 or s2 in occ:
                        continue
                    new = sorted(occ[:k] + occ[k + 1:] + (s2,))
                    # fermion sign: permutation parity of reinsertion
                    pos_new = new.index(s2)
                    sign = (-1) ** (k + pos_new)
                    b = psi[(tuple(new), d)] if spin == 0 else \
                        psi[(u, tuple(new))]
                    num += a * h[s, s2] * sign * b
    return num / den
