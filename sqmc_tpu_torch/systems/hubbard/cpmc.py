"""Constrained-path auxiliary-field QMC (CPMC) for the Hubbard model (port
of sqmc_tpu/systems/hubbard/cpmc.py).

The reference's CPMC experiment (ref: hubbard.f90 cpmc:8768 - RHF trial
from the hopping spectrum, half-K projector exp(-tau K/2), Hirsch spin
auxiliary-field decomposition of exp(-tau U n_up n_dn), overlap-ratio
weights, constrained path).

The walker population is a batched tensor Phi[nw, nsites, ne] on one
device and every operation is batched: the half-K projector is one einsum
over all walkers, the auxiliary-field kick is a per-site diagonal scale,
and overlaps / Green's functions come from batched determinants and
inverses.  Fields are sampled symmetrically (p = 1/2) and the exact
overlap ratio reweights the walker; the constrained-path approximation
kills walkers whose trial overlap goes non-positive (the standard CP
sign-problem cure; exact when the trial has exact overlap signs).  On the
card a step is one replay of a captured CUDA graph (utils/cudagraph.py).

The Hirsch site factors: with cosh(gamma) = exp(tau U / 2), scale_up(x) =
exp(gamma x - tau U / 2) and scale_dn(x) = exp(-gamma x - tau U / 2),
averaging over x = +-1 gives 1 on an empty site, 1 on a singly occupied
one and exp(-tau U) on a doubly occupied one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ...utils.cudagraph import GraphCache, StepGraph
from .meanfield import hopping_matrix

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class CpmcConfig:
    l_x: int
    l_y: int
    t: float
    U: float
    nup: int
    ndn: int
    tau: float = 0.05
    n_walkers: int = 256
    pbc: bool = True
    constrained: bool = True     # False = free projection (unbiased, noisy)


class CpmcState(NamedTuple):
    phi_up: torch.Tensor    # [nw, ns, nup]
    phi_dn: torch.Tensor
    logw: torch.Tensor      # [nw] log |weight|
    alive: torch.Tensor     # [nw] bool (constrained-path kill flag)
    rng_state: torch.Tensor  # generator.get_state()


def _setup(cfg: CpmcConfig, device="cuda"):
    """Projector, trial orbitals and Hirsch constant on `device`."""
    ns = cfg.l_x * cfg.l_y
    K = hopping_matrix(cfg.l_x, cfg.l_y, cfg.t, cfg.pbc)
    w, v = np.linalg.eigh(K)
    exp_half_k = v @ np.diag(np.exp(-0.5 * cfg.tau * w)) @ v.T
    # Hirsch: exp(-tau*U*(n_up - 1/2)(n_dn - 1/2)) =
    #   (1/2) sum_x exp(gamma*x*(n_up - n_dn)),  cosh(gamma)=exp(tau*U/2)
    gamma = float(np.arccosh(np.exp(0.5 * cfg.tau * cfg.U)))

    def on(x):
        return torch.as_tensor(x, dtype=F64, device=device)

    return dict(ns=ns, exp_half_k=on(exp_half_k), phi_t_up=on(v[:, :cfg.nup]),
                phi_t_dn=on(v[:, :cfg.ndn]), gamma=gamma, K=on(K),
                e_trial=float(np.sum(w[:cfg.nup]) + np.sum(w[:cfg.ndn])))


def init_cpmc(cfg: CpmcConfig, seed: int = 0, device="cuda"):
    s = _setup(cfg, device)
    nw = cfg.n_walkers
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return s, CpmcState(
        phi_up=s["phi_t_up"][None].repeat(nw, 1, 1),
        phi_dn=s["phi_t_dn"][None].repeat(nw, 1, 1),
        logw=torch.zeros(nw, dtype=F64, device=device),
        alive=torch.ones(nw, dtype=torch.bool, device=device),
        rng_state=gen.get_state())


def _overlap(phi_t, phi):
    """sign and log|det(phi_t^T phi)|, batched."""
    m = torch.einsum("si,wsj->wij", phi_t, phi)
    sign, logdet = torch.linalg.slogdet(m)
    return sign, logdet


def _greens(phi_t, phi):
    """G[w, s, s'] = [phi (phi_t^T phi)^-1 phi_t^T]_{s s'} (mixed-estimator
    one-body Green's function)."""
    m = torch.einsum("si,wsj->wij", phi_t, phi)
    minv = torch.linalg.inv_ex(m)[0]      # no info check: no host sync
    return torch.einsum("wsi,wij,tj->wst", phi, minv, phi_t)


def _orthonormalize(p, method: str = "cholesky"):
    """An orthonormal basis of each walker's columns, [nw, ns, ne].  Any
    such basis is valid: the overlap baseline is measured again against
    the stored walker at the next step.  "cholesky" (what the walk uses):
    p = Q L^T with L the Cholesky factor of p^T p (one batched matmul, one
    batched Cholesky, one triangular solve; the columns are
    near-orthonormal after one short step, so squaring the condition
    number costs nothing).  "qr" is torch.linalg.qr, kept to hold the
    first against and to time it: on CUDA it factors the small matrices
    one by one."""
    if method == "qr":
        return torch.linalg.qr(p)[0]
    L = torch.linalg.cholesky_ex(p.transpose(1, 2) @ p)[0]   # no host sync
    # Q = p L^-T  <=>  Q^T = L^-1 p^T
    return torch.linalg.solve_triangular(L, p.transpose(1, 2),
                                         upper=False).transpose(1, 2)


@contextlib.contextmanager
def _linalg_library(dev):
    """cuSOLVER / cuBLAS for the batched factorizations on the card, in the
    eager and the captured step alike, so that both pick one library (the
    same bits) whatever torch's heuristics would route to MAGMA, whose
    calls were not tried under a capture.  Nothing changes on the CPU."""
    if dev.type != "cuda":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def _cpmc_step(state: CpmcState, setup, cfg: CpmcConfig, gen):
    """One CPMC step over the state's tensors, with no host sync."""
    ehk = setup["exp_half_k"]
    ptu = setup["phi_t_up"]
    ptd = setup["phi_t_dn"]
    g = setup["gamma"]
    hu = 0.5 * cfg.tau * cfg.U
    dev = state.logw.device
    phi_up, phi_dn, logw, alive = state[:4]
    # baseline overlap of the stored (orthonormalized) walker
    s0u, l0u = _overlap(ptu, phi_up)
    s0d, l0d = _overlap(ptd, phi_dn)
    # B = exp(-tau K/2) B_V(x) exp(-tau K/2)
    pu = torch.einsum("st,wti->wsi", ehk, phi_up)
    pd = torch.einsum("st,wti->wsi", ehk, phi_dn)
    x = torch.where(torch.rand(pu.shape[:2], dtype=F64, device=dev,
                               generator=gen) < 0.5, 1.0, -1.0)
    pu = pu * torch.exp(g * x - hu)[:, :, None]
    pd = pd * torch.exp(-g * x - hu)[:, :, None]
    pu = torch.einsum("st,wti->wsi", ehk, pu)
    pd = torch.einsum("st,wti->wsi", ehk, pd)
    s1u, l1u = _overlap(ptu, pu)
    s1d, l1d = _overlap(ptd, pd)
    # w <- w * <psiT|B phi>/<psiT|phi> (importance-sampled free
    # projection); constrained path kills sign-flipped walkers
    dlog = (l1u + l1d) - (l0u + l0d)
    if cfg.constrained:
        alive = alive & ((s1u * s1d * s0u * s0d) > 0)
    logw = logw + torch.where(alive, dlog, -1e30)
    # re-orthonormalize to tame column overflow; the factor it drops moves
    # the overlap baseline, and the next step's ratio is measured against
    # the normalized walker, so the telescoping product stays exact
    return state._replace(phi_up=_orthonormalize(pu),
                          phi_dn=_orthonormalize(pd), logw=logw,
                          alive=alive), {}


def _mixed_energy(state: CpmcState, setup, cfg: CpmcConfig):
    """The block's measurement: E = sum_K K G + U sum_i Gu_ii Gd_ii over
    the live walkers, weighted (0-dim tensor, no host sync)."""
    phi_up, phi_dn, logw, alive = state[:4]
    Gu = _greens(setup["phi_t_up"], phi_up)
    Gd = _greens(setup["phi_t_dn"], phi_dn)
    K = setup["K"]
    e_k = torch.einsum("st,wts->w", K, Gu) + torch.einsum("st,wts->w", K, Gd)
    du = torch.diagonal(Gu, dim1=1, dim2=2)
    dd = torch.diagonal(Gd, dim1=1, dim2=2)
    e_loc = e_k + cfg.U * (du * dd).sum(dim=1)
    neg_inf = torch.full_like(logw, -float("inf"))
    w = torch.where(alive, torch.exp(logw - torch.where(alive, logw,
                                                        neg_inf).max()),
                    torch.zeros_like(logw))
    # a dead walker's Green's function may be singular: it carries no weight
    return torch.where(alive, w * e_loc, torch.zeros_like(w)).sum() \
        / w.sum().clamp(min=1e-30)


def cpmc_block(state: CpmcState, setup, cfg: CpmcConfig, nstep: int):
    """nstep CPMC steps + one mixed-energy measurement, with no host sync.
    Returns (state, e_mix 0-dim tensor).  The random stream continues from
    state.rng_state.  On the card the steps are replays of one captured
    step (_replay_steps), the counterpart of the JAX package's jit over
    lax.scan; on the CPU the eager loop (_cpmc_steps_eager)."""
    dev = state.logw.device
    with _linalg_library(dev):
        if dev.type == "cuda":
            state = _replay_steps(state, setup, cfg, nstep)
        else:
            state = _cpmc_steps_eager(state, setup, cfg, nstep)
        return state, _mixed_energy(state, setup, cfg)


def _cpmc_block_eager(state: CpmcState, setup, cfg: CpmcConfig, nstep: int):
    """cpmc_block with its steps as an eager loop: on the card the
    reference the captured block is held to."""
    with _linalg_library(state.logw.device):
        state = _cpmc_steps_eager(state, setup, cfg, nstep)
        return state, _mixed_energy(state, setup, cfg)


def _cpmc_steps_eager(state, setup, cfg, nstep):
    gen = torch.Generator(device=state.logw.device)
    gen.set_state(state.rng_state)
    for _ in range(nstep):
        state, _ = _cpmc_step(state, setup, cfg, gen)
    return state._replace(rng_state=gen.get_state())


# The captured step and its generator: a new (setup, cfg, device) drops it
# before the next capture; run_cpmc drops it when it returns.
_GRAPH = GraphCache()


def release_graphs() -> None:
    """Free the captured step and its memory pool."""
    _GRAPH.clear()


def _replay_steps(state, setup, cfg, nstep):
    """nstep replays of the captured step (on a CPU state the runner runs
    the same body eagerly); the generator's state handed back."""
    dev = state.logw.device
    gen, graph = _GRAPH.get(
        (id(setup), cfg, dev), dev,
        lambda gen: StepGraph(lambda s: _cpmc_step(s, setup, cfg, gen),
                              state._replace(rng_state=None), gen, (),
                              rows=max(nstep, 128)), rows=nstep)
    gen.set_state(state.rng_state)
    new, _, _ = graph.block(state._replace(rng_state=None), nstep)
    return new._replace(rng_state=gen.get_state())


def run_cpmc(cfg: CpmcConfig, n_blocks: int = 20, nstep: int = 20,
             n_eq: int = 5, seed: int = 0, verbose: bool = False,
             device="cuda"):
    """Block loop on `device` with comb population control between
    blocks (on the host, with the JAX package's draws).  Returns (e_mean,
    e_err); verbose prints each block's energy and alive count."""
    setup, state = init_cpmc(cfg, seed, device=device)
    nw = cfg.n_walkers
    es = []
    for blk in range(n_blocks):
        state, e_mix = cpmc_block(state, setup, cfg, nstep)
        logw = state.logw.cpu().numpy()          # the block's one sync
        alive = state.alive.cpu().numpy()
        if blk >= n_eq:
            es.append(float(e_mix))
        if verbose:
            print(f"cpmc block {blk}: e_mix={float(e_mix):.6f} "
                  f"alive={int(alive.sum())}")
        # comb reconfiguration (weights -> equal, resample walkers)
        w = np.where(alive, np.exp(logw - logw[alive].max()), 0.0) \
            if alive.any() else np.ones_like(logw)
        tot = w.sum()
        u = np.random.default_rng(seed + blk).random()
        pts = (u + np.arange(nw)) * (tot / nw)
        idx = torch.as_tensor(
            np.searchsorted(np.cumsum(w), pts).clip(0, nw - 1), device=device)
        state = CpmcState(
            phi_up=state.phi_up[idx], phi_dn=state.phi_dn[idx],
            logw=torch.zeros(nw, dtype=F64, device=device),
            alive=torch.ones(nw, dtype=torch.bool, device=device),
            rng_state=state.rng_state)
    release_graphs()
    es = np.asarray(es)
    err = es.std() / max(np.sqrt(len(es) - 1), 1) if len(es) > 1 else np.inf
    return float(es.mean()), float(err)
