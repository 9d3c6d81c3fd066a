"""Dense-vector projector Monte Carlo for toy/dense Hamiltonians, with the
full run_type family: none/no_fixed_node, fixed_node1..4, partial_node,
release_node, vmc, and sr (stochastic reconfiguration) (port of
sqmc_tpu/algo/densewalk.py).

The reference's small-model walk path (ref: do_walk.f90
move_heat_bath2:4395-4550 for the per-column projector variants, run_type
dispatch :38-50,240-330; sr: stochastic_reconfiguration :7258-7392; guiding
wavefunction psi_g: read_psi_trial.f90).  Where the reference keeps a
walker list of indices and spawns column by column, here the whole signed
population is a dense float64 weight vector w[N] on the device and one
generation is

    w  <-  P @ w        (an [N,N]x[N] matrix-vector product = FCIQMC with
                         perfect annihilation; the walker list is a sparse
                         view of the same vector)

followed by stochastic min_wt rounding (which keeps the vector sparse in
expectation and reproduces walker-population statistics), population
control, and mixed-estimator accumulation - the formulas of algo/walk.py.

This engine and algo/walk.py stay separate by design: the run_type
semantics (fixed_node1..4, partial_node, release_node, sr) are implemented
twice and both are held against the same dense-oracle energies; a new
run_type lands in both files with a shared oracle test.

Projector construction per run_type (column j, off-diagonal i):
  base          P_ij = -tau*Ht_ij,  P_jj = 1 + tau*(E_T - H_jj), where
                Ht = (psi_g_i/psi_g_j) H_ij under importance sampling.
  fixed_node1   sign-violating P_ij<0 are deleted and their sum added to
                P_jj (the standard discrete-space FN effective Hamiltonian).
  fixed_node2   P_ij -> |P_ij| (spawn with flipped sign).
  fixed_node3   sign-violating P_ij dropped (no diagonal dump).
  fixed_node4   alias of fixed_node1 in a dense basis (the reference's
                mode-4 differs only through the Gutzwiller factors of the
                hubbard2 path).
  partial_node  eps=0 exact .. eps=1 fixed_node1: violators scaled by
                (1-eps), eps of their sum dumped on the diagonal.
  release_node  fixed_node1 projector until `release_step`, exact after.
  vmc           violators dropped, then each column normalized to sum 1
                (weights stay positive; samples the guiding distribution).
  sr            partial_node(eps) + importance sampling + comb
                reconfiguration of the weight vector each step.

The tables are built with torch on the system's device.  A block of
generations runs without a host sync: the per-generation statistics stay
on the device and run_dense_walk reads them once a block.  On the card a
block replays one captured generation (a CUDA graph, utils/cudagraph.py),
the counterpart of the JAX package's jit over lax.scan; on the CPU it is
the eager loop.  The random stream is an explicit ``torch.Generator`` on
the device; the state carries its ``get_state()`` between blocks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils.cudagraph import GraphCache, StepGraph

F64 = torch.float64

RUN_TYPES = ("none", "no_fixed_node", "fixed_node1", "fixed_node2",
             "fixed_node3", "fixed_node4", "partial_node", "release_node",
             "vmc", "sr")


@dataclasses.dataclass(frozen=True)
class DenseWalkConfig:
    ndet: int
    tau: float
    w_abs_target: float
    run_type: str = "none"
    importance_sampling: int = 0
    partial_node_eps: float = 0.0
    release_step: int = 0              # release_node: switch step
    min_wt: float = 0.5
    pop_ctrl_exponent: float = 10.0
    reweight_factor_inv_max: float = 2.0
    sr_nwalk: int = 0                  # sr: comb size (0 = w_abs_target)
    # exponential projector exp(-tau(H - E_T)) instead of the linear
    # 1 - tau(H - E_T) (ref: use_exponential_projector card,
    # do_walk.f90:335-340); built once by eigendecomposition of the
    # run_type-modified effective H
    use_exponential_projector: bool = False

    def __post_init__(self):
        if self.run_type not in RUN_TYPES:
            raise ValueError(f"unknown run_type {self.run_type!r}; one of "
                             f"{RUN_TYPES} (hci/selected_ci/trunc_lanc are "
                             "run separately)")


class DenseTables(NamedTuple):
    p_off: torch.Tensor        # [N,N] off-diagonal propagator (selected type)
    p_diag0: torch.Tensor      # [N] diagonal at e_trial=0 (incl. FN dump)
    p_off_exact: torch.Tensor  # exact projector (for release_node)
    p_diag0_exact: torch.Tensor
    a_num: torch.Tensor        # estimator vectors: E = (a_num.w)/(a_den.w)
    a_den: torch.Tensor
    e_loc_g: torch.Tensor      # local energy of psi_g (vmc estimator)


class DenseWalkState(NamedTuple):
    w: torch.Tensor                    # [N] float64
    step: int                          # generations done (host count)
    e_trial: torch.Tensor              # 0-dim float64 tensors from here on
    e_est: torch.Tensor
    reweight_factor_inv: torch.Tensor
    equilibrated: bool
    e_num_blkabs_cum: torch.Tensor
    e_den_blkabs_cum: torch.Tensor
    e_num_blk: torch.Tensor
    e_den_blk: torch.Tensor
    w_abs_gen: torch.Tensor
    rng_state: torch.Tensor | None = None   # generator.get_state()


def _projector_parts(ham, tau, run_type, psi_g, importance_sampling,
                     partial_node_eps):
    """(p_off, p_diag0) for one run_type, as float64 tensors on ham's
    device; p_diag0 is the diagonal column entry at e_trial=0 (the step
    adds tau*e_trial).  The fixed-node dump is a COLUMN sum: it goes to
    the column's diagonal."""
    h = ham
    if importance_sampling:
        g = torch.as_tensor(psi_g, dtype=F64, device=h.device)
        p = h * (g[:, None] / g[None, :])
        p *= -tau
    else:
        p = -tau * h
    p.fill_diagonal_(0.0)
    diag0 = 1.0 - tau * torch.diagonal(h)     # + tau*e_trial at runtime

    zero = torch.zeros((), dtype=F64, device=h.device)
    if run_type in ("fixed_node1", "fixed_node4", "release_node"):
        viol = p < 0                          # sign-violating flows
        diag0 = diag0 + torch.where(viol, p, zero).sum(dim=0)
        p = torch.where(viol, zero, p)
    elif run_type == "fixed_node2":
        p = p.abs_()
    elif run_type in ("fixed_node3", "vmc"):
        p = p.clamp_(min=0.0)
    elif run_type in ("partial_node", "sr"):
        eps = partial_node_eps
        viol = p < 0
        diag0 = diag0 + eps * torch.where(viol, p, zero).sum(dim=0)
        p = torch.where(viol, (1.0 - eps) * p, p)
    if run_type == "vmc":
        # column-stochastic: pure sampling, no growth
        col = p.sum(dim=0) + diag0
        p = p / col[None, :]
        diag0 = diag0 / col
    return p, diag0


def _exponentiate(p_off, p_diag0, tau):
    """exp(-tau H_eff) of the effective H behind a linear projector (P = 1
    - tau H_eff at e_trial = 0), split into (off-diagonal, diagonal).
    H_eff is not symmetric, so this is a general eigendecomposition; it
    runs on the host in complex128 (set-up work at small N)."""
    n = p_off.shape[0]
    dev = p_off.device
    h_eff = -(p_off + torch.diag(p_diag0)
              - torch.eye(n, dtype=F64, device=dev)) / tau
    w_, v_ = torch.linalg.eig(h_eff.cpu())
    expm = (v_ @ torch.diag(torch.exp(-tau * w_))
            @ torch.linalg.inv(v_)).real.to(dev)
    d = torch.diagonal(expm).clone()
    return expm - torch.diag(d), d


def build_dense_tables(system, cfg: DenseWalkConfig, psi_t,
                       psi_g) -> DenseTables:
    """The projector and estimator tables on the system's device."""
    ham = system.ham
    dev = ham.device
    psi_t = torch.as_tensor(psi_t, dtype=F64, device=dev)
    psi_g = psi_t if psi_g is None else \
        torch.as_tensor(psi_g, dtype=F64, device=dev)
    imp = cfg.importance_sampling
    if cfg.run_type == "sr" and not imp:
        raise ValueError("Stochastic reconfiguration does not work without "
                         "importance sampling (ref: do_walk.f90:328)")

    p_off, p_diag0 = _projector_parts(ham, cfg.tau, cfg.run_type, psi_g,
                                      imp, cfg.partial_node_eps)
    if cfg.run_type in ("none", "no_fixed_node"):
        p_ex, p_dex = p_off, p_diag0          # the same matrix: share it
    else:
        p_ex, p_dex = _projector_parts(ham, cfg.tau, "none", psi_g, imp, 0.0)
    if cfg.use_exponential_projector and cfg.run_type != "vmc":
        # exp(-tau H_eff) from the linear parts; e_trial enters at runtime
        # as the factor exp(tau e_trial) on the whole column
        shared = p_ex is p_off
        p_off, p_diag0 = _exponentiate(p_off, p_diag0, cfg.tau)
        p_ex, p_dex = (p_off, p_diag0) if shared else \
            _exponentiate(p_ex, p_dex, cfg.tau)

    hpsit = ham @ psi_t
    if imp:
        a_num, a_den = hpsit / psi_g, psi_t / psi_g
    else:
        a_num, a_den = hpsit, psi_t
    e_loc_g = (ham @ psi_g) / psi_g
    return DenseTables(p_off=p_off, p_diag0=p_diag0, p_off_exact=p_ex,
                       p_diag0_exact=p_dex, a_num=a_num, a_den=a_den,
                       e_loc_g=e_loc_g)


def init_dense_state(cfg: DenseWalkConfig, psi_t, psi_g, w_abs_begin: float,
                     e_trial_initial: float, seed: int = 0,
                     start_index: int | None = None,
                     device="cuda") -> DenseWalkState:
    """Initial population ~ psi_t (or |psi_g psi_t| under importance
    sampling, where w carries psi_g*Phi), scaled to w_abs_begin, on
    `device`; the generator state is seeded from `seed`."""
    w0 = torch.as_tensor(psi_t, dtype=F64, device=device).clone()
    if cfg.importance_sampling:
        # importance-sampled runs carry f = psi_g * Phi; initial Phi ~
        # psi_t, and positive-projector run types take |w| (ref:
        # do_walk.f90:1212-1217 walk_wt=abs(walk_wt))
        w0 = (torch.as_tensor(psi_g, dtype=F64, device=device) * w0).abs()
    if start_index is not None:
        w0 = torch.zeros(cfg.ndet, dtype=F64, device=device)
        w0[start_index] = 1.0
    w0 = w0 * (w_abs_begin / max(float(w0.abs().sum()), 1e-300))
    gen = torch.Generator(device=w0.device)
    gen.manual_seed(seed)

    def f64(x):
        return torch.tensor(float(x), dtype=F64, device=device)

    return DenseWalkState(
        w=w0, step=0, e_trial=f64(e_trial_initial),
        e_est=f64(e_trial_initial), reweight_factor_inv=f64(1.0),
        equilibrated=False, e_num_blkabs_cum=f64(0.0),
        e_den_blkabs_cum=f64(0.0), e_num_blk=f64(0.0), e_den_blk=f64(0.0),
        w_abs_gen=w0.abs().sum(), rng_state=gen.get_state())


def _comb_reconfigure(w, u, n_comb: int):
    """Sorella comb resampling (ref: stochastic_reconfiguration,
    do_walk.f90:7258): systematic sampling of n_comb equal-weight walkers
    from |w| at the uniform offset u (a 0-dim tensor or float), preserving
    sum|w| exactly and E[w'] = w."""
    aw = w.abs()
    total = aw.sum()
    cum = torch.cumsum(aw, 0)
    pts = (u + torch.arange(n_comb, dtype=F64, device=w.device)) \
        * (total / n_comb)
    idx = torch.searchsorted(cum, pts).clamp(0, w.shape[0] - 1)
    counts = torch.zeros_like(w).index_add_(
        0, idx, torch.ones(n_comb, dtype=F64, device=w.device))
    return torch.sign(w) * counts * (total / n_comb)


def _released(cfg: DenseWalkConfig, step: int) -> bool:
    """release_node: whether generation `step` (0-based) projects with the
    exact projector; the host knows the step count, so it picks."""
    return cfg.run_type == "release_node" and step >= cfg.release_step


def _dense_step_impl(state: DenseWalkState, tables: DenseTables,
                     cfg: DenseWalkConfig, gen: torch.Generator,
                     released: bool):
    """One generation; every statistic stays on the device.  released:
    _released(cfg, state.step), passed in because a captured step cannot
    read the host's step count."""
    vmc = cfg.run_type == "vmc"
    dev = state.w.device

    if released:
        p_off, p_diag0 = tables.p_off_exact, tables.p_diag0_exact
    else:
        p_off, p_diag0 = tables.p_off, tables.p_diag0

    if cfg.use_exponential_projector and not vmc:
        # P = exp(tau e_trial) exp(-tau H_eff); the population-control
        # shift multiplies the whole column
        w = (torch.mv(p_off, state.w) + p_diag0 * state.w) * \
            torch.exp(cfg.tau * state.e_trial)
    else:
        diag = p_diag0 if vmc else p_diag0 + cfg.tau * state.e_trial
        w = torch.mv(p_off, state.w) + diag * state.w

    # stochastic min_wt rounding keeps the vector sparse in expectation
    # (ref: reduce_my_walker do_walk.f90:7196 semantics)
    if cfg.min_wt > 0:
        u = torch.rand(w.shape, dtype=F64, device=dev, generator=gen)
        aw = w.abs()
        tiny = (aw < cfg.min_wt) & (w != 0)
        survive = u < aw / cfg.min_wt
        w = torch.where(tiny, torch.where(survive, torch.sign(w) * cfg.min_wt,
                                          torch.zeros_like(w)), w)

    if cfg.run_type == "sr":
        n_comb = cfg.sr_nwalk or int(cfg.w_abs_target)
        u_comb = torch.rand((), dtype=F64, device=dev, generator=gen)
        w = _comb_reconfigure(w, u_comb, n_comb)

    if not vmc:
        w = w * state.reweight_factor_inv

    # ---- estimators ------------------------------------------------------
    w_abs_gen = w.abs().sum()
    if vmc:
        e_num_gen = (w.abs() * tables.e_loc_g).sum()
        e_den_gen = w_abs_gen
    else:
        e_num_gen = (tables.a_num * w).sum()
        e_den_gen = (tables.a_den * w).sum()
    e_num_blk = state.e_num_blk + e_num_gen
    e_den_blk = state.e_den_blk + e_den_gen
    den = state.e_den_blkabs_cum + e_den_blk.abs()
    e_est = torch.where(
        den != 0,
        (state.e_num_blkabs_cum + e_num_blk * torch.sign(e_den_blk)) /
        torch.where(den != 0, den, torch.ones_like(den)),
        state.e_est)

    # ---- population control (same formulas as algo/walk.py) --------------
    if vmc:
        reweight = torch.ones_like(state.reweight_factor_inv)
        e_trial_new = state.e_trial
    else:
        if state.equilibrated:
            e_trial_new = state.e_trial
        else:
            d = e_est - state.e_trial
            e_trial_new = state.e_trial + torch.sign(d) * d.abs().clamp(max=1.0)
        pexp = min(1.0, cfg.tau * cfg.pop_ctrl_exponent)
        ratio = (cfg.w_abs_target / w_abs_gen.clamp(min=1e-300)) ** pexp
        if state.equilibrated:
            reweight = (ratio / (1.0 + cfg.tau * (e_trial_new - e_est))
                        ).clamp(0.5, 2.0)
        else:
            reweight = ratio.clamp(0.5, 2.0)
        reweight = reweight.clamp(max=cfg.reweight_factor_inv_max)

    new_state = state._replace(
        w=w, step=state.step + 1, e_trial=e_trial_new, e_est=e_est,
        reweight_factor_inv=reweight, e_num_blk=e_num_blk,
        e_den_blk=e_den_blk, w_abs_gen=w_abs_gen)
    stats = dict(e_num_gen=e_num_gen, e_den_gen=e_den_gen,
                 w_abs_gen=w_abs_gen,
                 e_gen=e_num_gen / torch.where(
                     e_den_gen == 0, torch.full_like(e_den_gen, 1e-300),
                     e_den_gen))
    return new_state, stats


_STAT_KEYS = ("e_num_gen", "e_den_gen", "w_abs_gen", "e_gen")


def dense_walk_block(state: DenseWalkState, tables: DenseTables,
                     cfg: DenseWalkConfig, nstep: int):
    """`nstep` generations with no host sync inside.  Returns (state,
    stats) with stats[k] an [nstep] float64 device tensor.  The random
    stream continues from state.rng_state, and the returned state carries
    the generator's new state.  On the card one captured generation
    replayed `nstep` times (_replay_dense_block), the counterpart of the
    JAX package's jit over lax.scan; on the CPU the eager loop
    (_dense_walk_block_eager)."""
    if state.w.device.type != "cuda":
        return _dense_walk_block_eager(state, tables, cfg, nstep)
    return _replay_dense_block(state, tables, cfg, nstep)


def _dense_walk_block_eager(state: DenseWalkState, tables: DenseTables,
                            cfg: DenseWalkConfig, nstep: int):
    """dense_walk_block as a Python loop of eager generations: the CPU's
    path, and on the card the reference the captured block is held to."""
    gen = torch.Generator(device=state.w.device)
    gen.set_state(state.rng_state)
    rows = []
    for _ in range(nstep):
        state, st = _dense_step_impl(state, tables, cfg, gen,
                                     _released(cfg, state.step))
        rows.append(torch.stack([st[k] for k in _STAT_KEYS]))
    trace = torch.stack(rows)
    state = state._replace(rng_state=gen.get_state())
    return state, {k: trace[:, i] for i, k in enumerate(_STAT_KEYS)}


# The captured generations of the dense walk: one graph per
# (equilibrated, released), the host values the step reads, and one
# generator for them.  A new (tables, cfg, device) drops them before the
# next capture; run_dense_walk drops them when it returns.
_GRAPHS = GraphCache()


def release_graphs() -> None:
    """Free the dense walk's captured generations and their pools (they
    hold its tables)."""
    _GRAPHS.clear()


def _dense_capture(state, tables, cfg, released: bool, n: int):
    """gen -> the captured generation for this `released` (bound here, not
    read from the caller's loop: on the CPU the body runs at every
    replay)."""
    return lambda gen: StepGraph(
        lambda s: _dense_step_impl(s, tables, cfg, gen, released),
        state._replace(rng_state=None), gen, _STAT_KEYS, rows=max(n, 128))


def _replay_dense_block(state, tables, cfg, nstep):
    """dense_walk_block's generations through the captured graphs (on a
    CPU state the runner runs the same body eagerly).  A release_node
    block is split at release_step, each part on its own graph; the host
    advances the step count and hands the generator's state back."""
    rows = []
    while nstep > 0:
        released = _released(cfg, state.step)
        n = nstep if released or cfg.run_type != "release_node" else \
            min(nstep, cfg.release_step - state.step)
        gen, g = _GRAPHS.get(
            (id(tables), cfg, state.w.device), state.w.device,
            _dense_capture(state, tables, cfg, released, n),
            variant=(state.equilibrated, released), rows=n)
        gen.set_state(state.rng_state)
        new, trace, _ = g.block(state._replace(rng_state=None), n)
        state = new._replace(step=state.step + n,
                             equilibrated=state.equilibrated,
                             rng_state=gen.get_state())
        rows.append(trace)
        nstep -= n
    trace = torch.cat(rows)
    return state, {k: trace[:, i] for i, k in enumerate(_STAT_KEYS)}


def end_of_dense_block(state: DenseWalkState) -> DenseWalkState:
    """Roll the block sums into the cumulative |den|-signed sums."""
    return state._replace(
        e_num_blkabs_cum=state.e_num_blkabs_cum +
        state.e_num_blk * torch.sign(state.e_den_blk),
        e_den_blkabs_cum=state.e_den_blkabs_cum + state.e_den_blk.abs(),
        e_num_blk=torch.zeros_like(state.e_num_blk),
        e_den_blk=torch.zeros_like(state.e_den_blk))


class DenseWalkResult(NamedTuple):
    e_mixed: float
    e_err: float
    block_energies: np.ndarray
    w_abs_trace: np.ndarray
    state: DenseWalkState
    n_measured: int = 0                # measured generations
    t_measured: float = 0.0            # their wall seconds (synchronized)
    device_ms_per_gen: float | None = None   # CUDA events (card only)


def run_dense_walk(system, cfg: DenseWalkConfig, psi_t, psi_g=None,
                   nstep: int = 100, nblk: int = 10, nblk_eq: int = 2,
                   w_abs_begin: float = 100.0,
                   e_trial_initial: float | None = None, seed: int = 0,
                   verbose: bool = False) -> DenseWalkResult:
    """Block/step loop of the dense engine on the system's device (ref:
    walk do_walk.f90:2113 block structure; blocking error over
    post-equilibration blocks).  One host sync per block."""
    dev = system.ham.device
    psi_t = torch.as_tensor(psi_t, dtype=F64, device=dev)
    psi_g = psi_t if psi_g is None else \
        torch.as_tensor(psi_g, dtype=F64, device=dev)
    if e_trial_initial is None:
        e_trial_initial = float(torch.dot(psi_t, system.ham @ psi_t)
                                / torch.dot(psi_t, psi_t))
    tables = build_dense_tables(system, cfg, psi_t, psi_g)
    state = init_dense_state(cfg, psi_t, psi_g, w_abs_begin,
                             e_trial_initial, seed, device=dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    blocks, wtr = [], []
    n_measured, t_measured, dev_ms = 0, 0.0, 0.0
    for iblk in range(nblk):
        if iblk >= nblk_eq:
            state = state._replace(equilibrated=True)
        sync()
        if cuda:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            ev0.record()
        t0 = time.time()
        state, stats = dense_walk_block(state, tables, cfg, nstep)
        if cuda:
            ev1.record()
        trace = {k: v.cpu().numpy() for k, v in stats.items()}   # the sync
        dt = time.time() - t0
        num = float(trace["e_num_gen"].sum())
        den = float(trace["e_den_gen"].sum())
        wtr.extend(trace["w_abs_gen"].tolist())
        if iblk >= nblk_eq:
            n_measured += nstep
            t_measured += dt
            if cuda:
                dev_ms += ev0.elapsed_time(ev1)
            if den != 0:
                blocks.append(num / den)
        state = end_of_dense_block(state)
        if verbose:
            print(f"block {iblk:4d}  e_blk="
                  f"{num / den if den else float('nan'):12.6f}  "
                  f"w_abs={float(state.w_abs_gen):10.1f}  "
                  f"e_trial={float(state.e_trial):12.6f}")
    release_graphs()
    blocks = np.asarray(blocks)
    e_mixed = float(np.mean(blocks)) if len(blocks) else float("nan")
    e_err = float(np.std(blocks) / max(np.sqrt(len(blocks) - 1), 1)) \
        if len(blocks) > 1 else float("inf")
    return DenseWalkResult(
        e_mixed, e_err, blocks, np.asarray(wtr), state, n_measured,
        t_measured, dev_ms / n_measured if cuda and n_measured else None)


def deterministic_ground_state(system, tau: float | None = None,
                               n_iter: int = 2000, tol: float = 1e-12):
    """Power iteration with the exact projector on the system's device:
    the min_wt=0, no-population-noise limit of the walk (used by tests and
    by diagonalize_ham cross-checks).  Returns (energy, vector)."""
    ham = system.ham
    if tau is None:
        w = torch.linalg.eigvalsh(ham)
        tau = 1.9 / float(w[-1] - w[0])
    n = ham.shape[0]
    v = torch.full((n,), 1.0 / np.sqrt(n), dtype=F64, device=ham.device)
    e = float(v @ (ham @ v))
    for _ in range(n_iter):
        v2 = v + tau * (e * v - ham @ v)
        v2 = v2 / torch.linalg.norm(v2)
        e2 = float(v2 @ (ham @ v2))
        done = abs(e2 - e) < tol
        v, e = v2, e2
        if done:
            break
    return e, v
