"""Semistochastic initiator FCIQMC walk (port of the main path of
sqmc_tpu/algo/walk.py; ref: do_walk.f90 walk:1462, step body :2171-2930,
merge_original_with_spawned2:5866, reduce_my_walker:7196,
check_initiator:6838; heat-bath proposal chemistry.f90
off_diagonal_move_chem_efficient_heatbath:5086).

One generation (``walk_step``) on fixed-capacity walker arrays sorted by
the (up, dn) key:

  1. exact projection 1 + tau(E_T - H) on the deterministic space D: a
     dense [n_imp, n_imp] float32 matvec (f32 state, n_imp <=
     dense_proj_max) or the block-ELL SpMV (ops/spmv.py, the CUDA kernel
     on the card) otherwise;
  2. spawning: per-walker child counts -> prefix sum -> fixed spawn slots,
     hierarchical heat-bath pair draw, alias in-row target draw, and the
     exact S/diff spawn-weight correction that keeps the propagator
     unbiased whatever rounding the selection tables carry;
  3. annihilation: one stable sort of the walker and spawn keys, then ONE
     fused segmented scan (ops/segscan.py, the CUDA kernel on the card)
     for every group reduction, read at each group's end row;
  4. fresh-determinant fill (diagonal elements and C(T) indices) through a
     compaction buffer;
  5. population control and the mixed estimator (float64 in both state
     precisions).

Inside a generation nothing waits on the device: shapes are capacity-
bounded (count -> cumsum -> fixed slots) and compactions are order-
preserving scatters; ``overflow`` is read once per block by the driver.
Each generation writes N_MARKS device timestamps (ops/mark.py) at the
boundaries of its PIECES (projection, spawn, annihilation, fill,
finalize), at the heat-bath proposal's (or the CT chain's) end inside
the spawn and at the full-sort merge's key sort's end inside the
annihilation;
:func:`block_report` reads them, and the per-generation counters, for
the last block run.
On the card the generation is captured once as a CUDA graph and a block
replays it (``walk_block``; ``_graphed`` names the exceptions), the
counterpart of the JAX package's one compiled program per block.
Randomness comes from one ``torch.Generator``; the port cannot follow the
JAX package's random stream, so only the deterministic limit matches it
value by value.

Projectors and options (all of the JAX walk's on one device): the linear
projector 1 + tau(E_T - H) with "fast_heatbath", "uniform" or
"cauchy_schwarz" double proposals, or the continuous-time exponential
projector (``use_exponential_projector``, modes "hubbardk", "heg",
"generic"); importance sampling with a guiding wavefunction and the
fixed-node family of run types (violating spawns flip, drop or redirect
to the parent det; "sr" adds the Sorella comb); the C(T)-in-D estimator
(``ct_in_d``); the full-sort or the two-level merge; "group_max" or
"sequential" initiators; f32 or f64 state; the plain or the time-reversal
symmetrized basis.  The JAX package's capacity workarounds
(``cap_compact`` / ``cap_single``) are not part of the port and raise
ValueError.

Sharded (``axis_name`` / ``n_dev``, tables and state from
parallel.dist.make_sharded_walk): each rank of a process group walks the
dets it owns, with three collectives a generation, as in the JAX package:
an all-gather of the D weights before the projection, the routing of the
spawns to their owners before the merge (skipped on one rank), and one
all-reduce of the control scalars before population control.  Every host
decision of run_walk reads all-reduced values, so every rank takes the same
branch and the collectives stay matched.  The sharded walk runs what the
JAX package's runs: the signed projector (run_type "none"), every double
proposal, singles, both initiator rules and merges, f32 and f64 state,
dense or block-ELL projection and C(T)-in-D; fixed-node, guided and CT
walks raise ValueError for n_dev > 1.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import dets
from ..dets import flip
from ..ops import (ctchain, hbselect, hbspawn, segscan, seqinit, setalg,
                   slotpar, spawnhist, spmv)
from ..ops.alias import setup_alias_np
from ..ops.mark import Marks
from ..systems.chem import slater
from ..systems.chem.slater import SQRT2, SQRT2INV
from ..systems.heatbath import tri_le, tri_lt
from ..utils import timers
from ..utils.cudagraph import StepGraph
from ..utils.precision import full_fp32_matmul

F64 = torch.float64
F32 = torch.float32
I32 = torch.int32
I64 = torch.int64


# ---------------------------------------------------------------------------
# Configuration and state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WalkConfig:
    """Walk knobs, named and defaulted as in sqmc_tpu.algo.walk.WalkConfig."""
    mwalk: int                  # walker-list capacity (ref MWALK)
    cap_spawn: int              # spawn-slot capacity per step
    norb: int
    nup: int
    ndn: int
    n_words: int
    tau: float
    w_abs_target: float         # target total |weight|
    r_initiator: float = 1.0
    initiator_power: float = 0.0
    initiator_min_distance: int = 0
    min_wt: float = 0.5
    always_spawn_cutoff: float = 0.5
    pop_ctrl_exponent: float = 10.0
    reweight_factor_inv_max: float = 2.0
    semistochastic: bool = True
    has_singles: bool = True
    # C(T)-in-D mixed estimator: two dots against the D-weight vector the
    # projection already holds, evaluated on the step's INPUT state (the
    # gather path's trace shifted by one generation).  Valid only when
    # every C(T) det lies in D; build_walk_tables checks it.
    ct_in_d: bool = False
    # store the dense D-projection matrix in bfloat16 (half the resident
    # table); products of bfloat16-rounded operands accumulate in float32
    proj_bf16: bool = False
    spawn_granularity: float = 1.0
    # double-excitation proposal (ref proposal_method card, do_walk.f90:289):
    # 'fast_heatbath' (exact joint |H|; ref
    # off_diagonal_move_chem_efficient_heatbath:5086), 'uniform' (orbitals
    # uniform; ref off_diagonal_move_chem:4237), 'cauchy_schwarz' (separable
    # sqrt((pr|pr)(qs|qs)) bound; ref off_diagonal_move_chem_cauchySchwarz:2530)
    proposal: str = "fast_heatbath"
    c_t_initiator: bool = False
    # annihilation: one stable sort of [mwalk + cap_spawn] rows (True), or
    # the two-level merge: spawns onto resident dets merge by scatter, only
    # new dets are sorted, and the two sorted lists interleave by rank
    full_sort_merge: bool = True
    cap_new: int = 0            # distinct new dets per step (0 = see cap_new_eff)
    cap_fresh: int = 0          # fresh-det buffer (0 = max(cap_spawn//8, 8192))
    # "group_max": a merged group's initiator is the max over its rows;
    # "sequential": the reference's order-dependent pairwise rule
    # (do_walk.f90:5897-5950), a measurement mode (ops/seqinit.py, K5)
    initiator_rule: str = "group_max"
    dense_proj_max: int = 16384
    # accepted for configurations written for the JAX package: the port's
    # C(T) lookup is a binary search either way
    det_hash: bool = True
    f32_state: bool = False
    # continuous-time exponential projector exp(-tau(H - E_T)) (ref
    # use_exponential_projector card, move_uniform_exponential_projector
    # do_walk.f90:3803): per child a chain of off-diagonal moves at
    # exponentially sampled times, parents take the exact diagonal factor.
    # Needs semistochastic=False.  Chains longer than ct_max_jumps moves
    # are zeroed (P < 1e-9 at tau * rate <= 1).
    use_exponential_projector: bool = False
    ct_max_jumps: int = 12
    # "hubbardk": uniform (e_up, e_dn, r), s by momentum conservation, unit
    # jump factors; "heg": uniform electron pair + r, s by momentum
    # conservation, factor -H_ij / (rate p(j|i)); "generic": uniform singles
    # and doubles over all orbital cells with exact signed elements.
    # "heg" / "generic" rates are ct_rate_mult * sum_j |H_hf,j|.
    ct_mode: str = "hubbardk"
    ct_rate_mult: float = 1.5
    # projector variant (ref run_type dispatch do_walk.f90:38-50): 'none' /
    # 'no_fixed_node' = exact signed projector; on the importance-
    # transformed flow Ht_ij = (psi_g_i / psi_g_j) H_ij, sign-violating
    # spawns redirect to the parent det (fixed_node1/4), flip sign
    # (fixed_node2), are dropped (fixed_node3), redirect with probability
    # partial_node_eps (partial_node; sr adds the Sorella comb), or redirect
    # until step release_step (release_node)
    run_type: str = "none"
    partial_node_eps: float = 0.0
    release_step: int = 0
    sr_nwalk: int = 0           # sr comb size (0 = w_abs_target)
    guiding: str = "none"       # 'none', 'gutzwiller' or 'table'
    # time-reversal symmetrized basis (ref hamiltonian_chem_time_sym,
    # chemistry.f90:1323), sector z = +1 or -1
    time_sym: bool = False
    z: int = 1
    # determinant sharding over a mesh of n_dev ranks (parallel/dist.py):
    # with axis_name set, walkers live on their owner rank, spawns are
    # routed to their owners, the D weights are all-gathered for the
    # projection and the control scalars are all-reduced; mwalk and
    # cap_spawn are per-rank capacities
    axis_name: str | None = None
    n_dev: int = 1
    # --- not part of the port: must keep these values ---
    cap_compact: int = 0
    cap_single: int = 0

    def __post_init__(self):
        for name, want, why in (
                ("cap_compact", 0, "a TPU capacity workaround with no effect "
                                   "on results"),
                ("cap_single", 0, "a TPU capacity workaround with no effect "
                                  "on results")):
            if getattr(self, name) != want:
                raise ValueError(
                    f"WalkConfig.{name}={getattr(self, name)!r} is not part "
                    f"of sqmc_tpu_torch ({why}; only {want!r})")
        if self.n_dev < 1 or (self.n_dev > 1 and self.axis_name is None):
            raise ValueError(f"WalkConfig.n_dev={self.n_dev!r}: a walk over "
                             "several ranks sets axis_name (and comes from "
                             "parallel.dist.make_sharded_walk)")
        if self.n_dev > 1:
            if self.cap_spawn % self.n_dev:
                raise ValueError(f"cap_spawn={self.cap_spawn} must split into "
                                 f"n_dev={self.n_dev} equal spawn buckets")
            for bad, why in (
                    (self.fixed_node, f"run_type {self.run_type!r}: its "
                     "redirects search only the rank's own D"),
                    (self.guiding != "none", "guided (importance-sampled) "
                     "walks"),
                    (self.use_exponential_projector, "the CT chain")):
                if bad:
                    raise ValueError(f"{why} are not part of the sharded "
                                     "walk, as in the JAX package (n_dev > 1)")
        allowed = ("none", "no_fixed_node", "fixed_node1", "fixed_node2",
                   "fixed_node3", "fixed_node4", "partial_node",
                   "release_node", "sr")
        if self.run_type not in allowed:
            raise ValueError(f"unknown run_type {self.run_type!r}; one of "
                             f"{allowed}")
        if self.run_type not in ("none", "no_fixed_node") \
                and self.guiding == "none":
            raise ValueError(f"run_type {self.run_type!r} requires a "
                             "guiding wavefunction (cfg.guiding)")
        if self.guiding not in ("none", "gutzwiller", "table"):
            raise ValueError(f"unknown guiding {self.guiding!r}")
        if self.proposal not in ("fast_heatbath", "uniform",
                                 "cauchy_schwarz"):
            raise ValueError(f"unknown proposal {self.proposal!r}")
        if self.initiator_rule not in ("group_max", "sequential"):
            raise ValueError(f"unknown initiator_rule {self.initiator_rule!r}")
        if self.z not in (1, -1):
            raise ValueError(f"WalkConfig.z={self.z!r}: the time-symmetrized "
                             "sector is +1 or -1")

    @property
    def nelec(self):
        return self.nup + self.ndn

    @property
    def npairs(self):
        return ((self.nup * (self.nup - 1)) // 2
                + (self.ndn * (self.ndn - 1)) // 2 + self.nup * self.ndn)

    @property
    def cap_new_eff(self):
        return self.cap_new or max(self.cap_spawn // 4, 8192)

    @property
    def cap_fresh_eff(self):
        return self.cap_fresh or max(self.cap_spawn // 8, 8192)

    @property
    def fixed_node(self):
        return self.run_type not in ("none", "no_fixed_node")


N_HIST_BINS = spawnhist.N_HIST_BINS
DIAG_UNKNOWN = 1e30             # unevaluated diagonal (exact in f32)
DIAG_UNKNOWN_THRESHOLD = 1e29
TINY = 1e-30
SENT = dets.SENTINEL            # -1: empty slot


class WalkTables(NamedTuple):
    """Device-resident lookup tables, built once per run.

    The same- and opposite-spin heat-bath families are concatenated (opp
    rows offset by the same-spin row count, opp entries by the same-spin
    entry count).  Alias entries carry their own and their partner's
    target value sign(H) * (r*norb + s + 1) in float32, so accept-or-alias
    is two gathers and a select."""
    hb_alias_q: torch.Tensor     # [n_tot] f32 acceptance
    hb_rs_own: torch.Tensor      # [n_tot] f32 signed target code
    hb_rs_partner: torch.Tensor  # [n_tot] f32 signed partner target code
    hb_start: torch.Tensor       # [rows] i64 row start
    hb_count: torch.Tensor       # [rows] i64 row length
    hb_rowsum: torch.Tensor      # [rows] f32 sum |H| over the row
    R2: torch.Tensor             # [2n, 2n] f32 spin-orbital pair rowsums
    u_table: torch.Tensor        # [norb, norb] f64 singles bound U[p,r]
    u_rowsum: torch.Tensor       # [norb] f64
    u_alias_q: torch.Tensor      # [norb*norb] f32
    u_alias_J: torch.Tensor      # [norb*norb] i64
    sng_pack: torch.Tensor       # [norb^2, 2norb+2] f32, or [0, 0]
    table: object                # IntegralTable
    ct_up: torch.Tensor          # C(T) cache, sorted
    ct_dn: torch.Tensor
    ct_key: torch.Tensor         # flipped fused keys (norb <= 32, W == 1) or [0]
    ct_num: torch.Tensor         # f32/f64
    ct_den: torch.Tensor
    imp_up: torch.Tensor         # deterministic space, sorted
    imp_dn: torch.Tensor
    imp_ell_cols: torch.Tensor   # [P] i32, off-diagonal, 128-slot row blocks
    imp_ell_vals: torch.Tensor   # [P] f32/f64
    imp_ell_ptr: torch.Tensor    # [n_imp + 1] i64 row pointers into the slots
    imp_ell_nnz: torch.Tensor    # [n_imp] i32 entries per row
    imp_diag: torch.Tensor       # [n_imp] f64
    imp_dense: torch.Tensor      # [n_imp, n_imp] f32/bf16 off-diagonal, or [0, 0]
    # the same matrix as a row-sorted, row-complete COO with the diagonal
    # (after the guiding / fixed-node transform it is not symmetric)
    imp_rows: torch.Tensor       # [nnz] i64
    imp_cols: torch.Tensor       # [nnz] i64
    imp_vals: torch.Tensor       # [nnz] f32/f64
    # Cauchy-Schwarz bound c[p,r] = sqrt|(pr|pr)| with per-row alias tables
    cs_c: torch.Tensor           # [norb, norb] f64
    cs_rowsum: torch.Tensor      # [norb] f64
    cs_aliasJ: torch.Tensor      # [norb, norb] i64
    cs_aliasq: torch.Tensor      # [norb, norb] f64
    # continuous-time projector: momentum-conservation target
    # s = kmap3[(p*norb+q)*norb+r] (hubbardk: umklapp folded; heg: -1 outside
    # the cutoff) and the total off-diagonal rate ([1] / 0 when unused)
    kmap3: torch.Tensor          # [norb^3] i64, or [1]
    ct_rate: torch.Tensor        # [] f64
    # C(T)-in-D estimator vectors over the D dets ([0] = inactive)
    ct_num_imp: torch.Tensor     # [n_imp] f64
    ct_den_imp: torch.Tensor
    guide: object                # guiding.Guiding (empty when guiding == 'none')
    # sharded walk (parallel.dist.make_sharded_walk): this rank's mesh; the
    # imp_* and ct_*_imp fields then hold only this rank's D rows
    mesh: object = None


class WalkState(NamedTuple):
    up: torch.Tensor            # [M, W] int64 (-1 for empty)
    dn: torch.Tensor
    wt: torch.Tensor            # [M] f32/f64
    init: torch.Tensor          # [M] i32 initiator code 0..3
    imp: torch.Tensor           # [M] i32: 0=D, -2=C(T), -1 transient, >=1 dist
    diag: torch.Tensor          # [M] f32/f64 (DIAG_UNKNOWN = unknown)
    ct: torch.Tensor            # [M] i64 C(T) index (-1 absent, -2 unknown)
    nwalk: torch.Tensor         # [] i32
    e_trial: torch.Tensor       # [] f64 scalars below
    e_est: torch.Tensor
    tau: torch.Tensor
    reweight_factor_inv: torch.Tensor
    reached_target: torch.Tensor   # [] bool
    equilibrated: torch.Tensor     # [] bool
    e_num_blkabs_cum: torch.Tensor
    e_den_blkabs_cum: torch.Tensor
    e_num_blk: torch.Tensor
    e_den_blk: torch.Tensor
    w_abs_gen: torch.Tensor
    overflow: torch.Tensor         # [] bool: capacity exceeded
    step: torch.Tensor             # [] i32
    # the random generator's state at the end of the last block (uint8, on
    # the host): run_walk sets it when it writes checkpoints, so a resumed
    # walk draws what the uninterrupted one would have
    rng_state: torch.Tensor | None = None


def _fused_keys(cfg) -> bool:
    return cfg.n_words == 1 and cfg.norb <= 32


def _fuse(up, dn):
    """One int64 key up<<32 | dn for W == 1, norb <= 32 (unsigned order)."""
    return (up[:, 0] << 32) | dn[:, 0]


def _walk_diag(cfg, table, up, dn, dtype=F64):
    """Diagonal elements of walker dets [n, W]; in the time-symmetrized
    basis plus z <i|H|rev i> for non-self-symmetric representatives (ref
    hamiltonian_chem_time_sym, diagonal branch)."""
    bu, bd = dets.to_bits(up, cfg.norb), dets.to_bits(dn, cfg.norb)
    dg = slater.diag_elements(table, bu, bd, dtype=dtype)
    if cfg.time_sym:
        cross = slater.pair_matrix_elements(table, bu, bd, bd, bu)
        selfs = (up == dn).all(dim=1)
        dg = dg + torch.where(selfs, torch.zeros_like(cross), cfg.z * cross)
    return dg


# ---------------------------------------------------------------------------
# Tables and initial state (host)
# ---------------------------------------------------------------------------

def _row_alias(val, start, count):
    """Per-row alias tables over |val| in a flat ragged array."""
    v = np.abs(np.asarray(val, np.float64))
    J = np.zeros(len(v), np.int64)
    q = np.ones(len(v))
    for s, c in zip(np.asarray(start, np.int64), np.asarray(count, np.int64)):
        if c <= 0:
            continue
        row = v[s:s + c]
        tot = row.sum()
        if tot <= 0:
            continue
        Jr, qr = setup_alias_np(row / tot)
        J[s:s + c] = Jr
        q[s:s + c] = qr
    return J, q


def _row_sums(val, start, count):
    """Row sums of |val| over the flat ragged array, computed as the JAX
    package does (global cumsum minus the row's offset), so the float32
    rowsums round identically."""
    v = np.abs(np.asarray(val, np.float64))
    st = np.asarray(start, np.int64)
    ct = np.asarray(count, np.int64)
    cum = np.cumsum(v)
    cum0 = np.concatenate([[0.0], cum])
    offs = np.repeat(cum0[st], ct)
    if len(offs) < len(v):      # padding entry of an empty table
        offs = np.concatenate([offs, cum0[-2:-1]])
    in_row = cum - offs
    out = np.zeros(len(st))
    nz = ct > 0
    out[nz] = in_row[(st + ct - 1)[nz]]
    return out


def _hf_offdiag_mass(system) -> float:
    """sum_j |H_hf,j| over the HF det's connections: the scale of the CT
    jump rate in the heg / generic modes.  Any rate > 0 is unbiased (the
    per-jump factor divides by rate * p(j|i)); this one keeps the factors
    O(1)."""
    from .connect import generate_connections
    dev = system.device
    up = torch.as_tensor(np.atleast_2d(system.hf_up), device=dev)
    dn = torch.as_tensor(np.atleast_2d(system.hf_dn), device=dev)
    _, _, helem, _ = generate_connections(
        system, up, dn, torch.zeros(1, dtype=F64, device=dev))
    mass = float(helem.abs().sum())
    if mass <= 0.0:
        raise ValueError("HF det has no off-diagonal connections - "
                         "cannot scale the CT jump rate")
    return mass


def _ct_tables(system, cfg):
    """(kmap3, ct_rate) of the continuous-time projector for cfg.ct_mode,
    after checking the mode against the system."""
    norb = system.norb
    sysname = system.name
    if cfg.semistochastic:
        raise ValueError(
            "use_exponential_projector requires semistochastic=False "
            "(ref skips the deterministic projection, do_walk.f90:2255)")
    if cfg.fixed_node:
        raise NotImplementedError(
            "use_exponential_projector supports the plain signed "
            "projector only")
    if cfg.time_sym:
        raise NotImplementedError(
            "use_exponential_projector runs in the plain det basis "
            "(no time-reversal symmetrization)")
    mode = cfg.ct_mode
    if mode == "hubbardk":
        if sysname != "hubbardk":
            raise NotImplementedError(
                "ct_mode='hubbardk' needs a momentum-space Hubbard "
                "system; set ct_mode='heg' or 'generic' for this one "
                "(WalkConfig.ct_mode)")
        if cfg.has_singles:
            raise NotImplementedError(
                "ct_mode='hubbardk' is the doubles-only uniform walk")
        ex = system.extra
        rel = np.asarray(ex["k_rel"], np.int64)
        lx, ly = int(ex["l_x"]), int(ex["l_y"])
        kmin = rel.min(axis=0)
        # canonical half-step grid coordinates; umklapp = mod L (all k
        # components share one parity, so the //2 is exact)
        idx = np.full((lx, ly), -1, np.int64)
        idx[((rel[:, 0] - kmin[0]) // 2) % lx,
            ((rel[:, 1] - kmin[1]) // 2) % ly] = np.arange(norb)
        ks = rel[:, None, None, :] + rel[None, :, None, :] \
            - rel[None, None, :, :]
        kmap3 = idx[((ks[..., 0] - kmin[0]) // 2) % lx,
                    ((ks[..., 1] - kmin[1]) // 2) % ly].reshape(-1)
        assert kmap3.min() >= 0
        return kmap3, cfg.nup * cfg.ndn * (norb - cfg.nup) \
            * abs(float(ex["U"])) / norb
    if mode == "heg":
        if sysname != "heg":
            raise NotImplementedError(
                "ct_mode='heg' needs the HEG system (momentum-"
                "conserving doubles with analytic elements)")
        if cfg.nup < 1 or cfg.ndn < 1 or cfg.nelec < 2:
            raise ValueError("ct_mode='heg' needs >=1 electron of each spin")
        # exact momentum map without periodic folding (no umklapp in the
        # HEG): s with k_s = k_p + k_q - k_r, -1 outside the cutoff sphere
        # (such proposals kill the chain)
        rel = np.asarray(system.extra["k_rel"], np.int64)
        lut = {tuple(v): i for i, v in enumerate(rel.tolist())}
        ks = (rel[:, None, None, :] + rel[None, :, None, :]
              - rel[None, None, :, :]).reshape(-1, rel.shape[1])
        kmap3 = np.fromiter((lut.get(tuple(v), -1) for v in ks.tolist()),
                            np.int64, count=len(ks))
        return kmap3, cfg.ct_rate_mult * _hf_offdiag_mass(system)
    if mode == "generic":
        if sysname in ("hubbardk", "hubbard2", "hubbarddm"):
            raise NotImplementedError(
                "ct_mode='generic' covers det systems with chem-style "
                "integral tables (chem/heg/toy); hubbardk has its own "
                "mode and real-space Hubbard is unsupported")
        if cfg.nup < 1 or cfg.ndn < 1 or cfg.nelec < 2:
            raise ValueError("ct_mode='generic' needs >=1 electron of each "
                             "spin")
        return np.zeros(1, np.int64), \
            cfg.ct_rate_mult * _hf_offdiag_mass(system)
    raise ValueError(f"unknown ct_mode {mode!r}")


def _guide_values(guide, cfg, up, dn):
    """psi_g on a det list as numpy float64, zeros pushed to 1e-300."""
    from .guiding import eval_guiding
    g = eval_guiding(guide, cfg.guiding, up, dn, cfg.norb, cfg.nup,
                     cfg.ndn).cpu().numpy()
    return np.where(np.abs(g) < 1e-300, 1e-300, g)


def build_walk_tables(system, trial, cfg: WalkConfig,
                      guide=None) -> WalkTables:
    """Assemble the walk's device tables from a FermionSystem and a
    TrialWavefunction, on the system's device.

    With a guiding wavefunction (cfg.guiding != 'none') the C(T) estimator
    caches and the D-space projector are importance-transformed
    (Ht_ij = psi_g_i / psi_g_j H_ij), and the projector also gets the exact
    fixed-node treatment of cfg.run_type: violators zeroed (or flipped),
    their column sums dumped on the diagonal (ref do_walk.f90:887-1012).
    The transformed projector is not symmetric."""
    from .guiding import empty_guiding
    full_fp32_matmul()
    if cfg.time_sym != system.time_sym or (cfg.time_sym
                                           and cfg.z != system.z):
        raise ValueError("WalkConfig time_sym / z must match the system's "
                         "(the trial's H is built in the system's basis)")
    dev = system.device
    if cfg.guiding != "none" and guide is None:
        raise ValueError(f"cfg.guiding={cfg.guiding!r} needs a guide")
    if guide is None:
        guide = empty_guiding(dev)
    hb = system.heatbath
    table = system.table
    norb = system.norb
    np_ = lambda t: t.cpu().numpy()  # noqa: E731

    s_val, o_val = np_(hb.same_val), np_(hb.opp_val)
    s_st, o_st = np_(hb.same_start), np_(hb.opp_start)
    s_ct, o_ct = np_(hb.same_count), np_(hb.opp_count)
    s_rowsum = _row_sums(s_val, s_st, s_ct)
    o_rowsum = _row_sums(o_val, o_st, o_ct)
    s_J, s_q = _row_alias(s_val, s_st, s_ct)
    o_J, o_q = _row_alias(o_val, o_st, o_ct)

    # Cauchy-Schwarz separable bound c[p,r] = sqrt|(pr|pr)| (ref
    # off_diagonal_move_chem_cauchySchwarz:2530) with per-row alias tables
    PP, RR = np.meshgrid(np.arange(norb), np.arange(norb), indexing="ij")
    cs_c = np.sqrt(np.abs(table.eri_value_np(
        PP.ravel(), RR.ravel(), PP.ravel(), RR.ravel()))).reshape(norb, norb)
    np.fill_diagonal(cs_c, 0.0)
    cs_rowsum = cs_c.sum(axis=1)
    cs_J = np.zeros((norb, norb), np.int64)
    cs_q = np.ones((norb, norb))
    for p_ in range(norb):
        if cs_rowsum[p_] > 0:
            cs_J[p_], cs_q[p_] = setup_alias_np(cs_c[p_] / cs_rowsum[p_])

    # singles bound U[p,r] = |h_pr| + sum_q (|(pr|qq)| + |(pq|qr)|), zero
    # when symmetry-forbidden or p == r, with per-row alias tables
    if system.has_singles:
        sd = np.abs(np_(table.sing_dir)).sum(axis=1).reshape(norb, norb)
        se = np.abs(np_(table.sing_exch)).sum(axis=1).reshape(norb, norb)
        U = np.abs(np_(table.h)) + sd + se
        sym = np_(system.orb_sym_arr)
        U[sym[:, None] != sym[None, :]] = 0.0
        np.fill_diagonal(U, 0.0)
    else:
        U = np.zeros((norb, norb))
    u_rowsum = U.sum(axis=1)
    u_J = np.zeros((norb, norb), np.int64)
    u_q = np.ones((norb, norb))
    for p_ in range(norb):
        if u_rowsum[p_] > 0:
            u_J[p_], u_q[p_] = setup_alias_np(U[p_] / u_rowsum[p_])
    sng_pack = np.zeros((0, 0), np.float32)
    if cfg.f32_state and system.has_singles and table.sing_dir is not None:
        sng_pack = np.concatenate([
            np_(table.sing_dir), np_(table.sing_exch),
            np_(table.h).reshape(-1, 1), U.reshape(-1, 1)],
            axis=1).astype(np.float32)

    n_same = len(s_val)
    rs_cat = np.concatenate([np_(hb.same_rs), np_(hb.opp_rs)]).astype(np.float64)
    val_cat = np.concatenate([s_val, o_val])
    rssign = (np.where(val_cat < 0, -1.0, 1.0) * (rs_cat + 1.0)).astype(np.float32)
    hb_start = np.concatenate([s_st, o_st + n_same]).astype(np.int64)
    hb_count = np.concatenate([s_ct, o_ct]).astype(np.int64)
    alias_J = np.concatenate([s_J, o_J])
    n_tot = len(rssign)
    row_of = np.arange(n_tot, dtype=np.int64)      # padding entries: self
    for st_, ct_ in zip(hb_start, hb_count):
        row_of[st_:st_ + ct_] = st_
    partner = rssign[np.clip(row_of + alias_J, 0, n_tot - 1)]
    hb_rowsum = np.concatenate([s_rowsum, o_rowsum]).astype(np.float32)

    # dense symmetric views of the f32 rowsums: R2 over spin-orbitals
    aa, bb = np.triu_indices(norb, k=1)
    rs_dense = np.zeros((norb, norb), np.float32)
    rs_dense[aa, bb] = hb_rowsum[tri_lt(aa, bb)]
    rs_dense = rs_dense + rs_dense.T
    ntri_s = norb * (norb - 1) // 2
    aae, bbe = np.triu_indices(norb, k=0)
    ro_dense = np.zeros((norb, norb), np.float32)
    ro_dense[aae, bbe] = hb_rowsum[ntri_s + tri_le(aae, bbe)]
    ro_dense = ro_dense + ro_dense.T - np.diag(np.diag(ro_dense))
    R2 = np.block([[rs_dense, ro_dense], [ro_dense.T, rs_dense]])

    # row-complete COO of H on D: the diagonal and both orientations of
    # the stored upper triangle, stably sorted by row
    n_imp = len(trial.imp_up)
    H = trial.imp_ham
    fdt = np.float32 if cfg.f32_state else np.float64
    h_rows, h_cols = np_(H.rows), np_(H.cols)
    r_all = np.concatenate([h_rows, h_cols, np.arange(n_imp)]).astype(np.int64)
    c_all = np.concatenate([h_cols, h_rows, np.arange(n_imp)]).astype(np.int64)
    v_all = np.concatenate([np_(H.vals), np_(H.vals), np_(H.diag)])
    ord_r = np.argsort(r_all, kind="stable")
    r_all, c_all, v_all = r_all[ord_r], c_all[ord_r], v_all[ord_r]

    ct_num = np_(trial.ct_num).astype(np.float64)
    ct_den = np_(trial.ct_den).astype(np.float64)
    if cfg.guiding != "none":
        # the walker carries f_i = psi_g_i Phi_i, so the estimator's
        # per-det numerator and denominator divide by psi_g (ref
        # energy_pieces under importance sampling)
        g_ct = _guide_values(guide, cfg, trial.ct_up.to(dev),
                             trial.ct_dn.to(dev))
        ct_num = ct_num / g_ct
        ct_den = ct_den / g_ct
        if n_imp > 0:
            g_imp = _guide_values(guide, cfg, trial.imp_up.to(dev),
                                  trial.imp_dn.to(dev))
            off = r_all != c_all
            v_all = v_all * np.where(off, g_imp[r_all] / g_imp[c_all], 1.0)
            if cfg.fixed_node:
                # exact fixed-node effective H on D: sign-violating
                # off-diagonals (Ht > 0) move to their column's diagonal
                viol = off & (v_all > 0)
                eps_fn = (cfg.partial_node_eps
                          if cfg.run_type in ("partial_node", "sr") else 1.0)
                dump = np.zeros(n_imp)
                np.add.at(dump, c_all[viol], eps_fn * v_all[viol])
                if cfg.run_type == "fixed_node2":
                    v_all = np.where(viol, -v_all, v_all)
                else:
                    v_all = np.where(viol, (1.0 - eps_fn) * v_all, v_all)
                    if cfg.run_type != "fixed_node3":
                        v_all = v_all + dump[r_all] * ~off

    # projection matrix: diagonal split out (the step uses the difference
    # form), off-diagonal rows padded to 128-slot blocks (block-ELL,
    # ops/spmv.py), or dense f32 for f32-state runs with n_imp <=
    # dense_proj_max
    dmask = r_all == c_all
    imp_diag = np.zeros(n_imp)
    np.add.at(imp_diag, r_all[dmask], v_all[dmask])
    r_off, c_off, v_off = r_all[~dmask], c_all[~dmask], v_all[~dmask]
    use_dense = cfg.f32_state and 0 < n_imp <= cfg.dense_proj_max
    if use_dense:
        imp_dense = torch.zeros((n_imp, n_imp), dtype=F32, device=dev)
        imp_dense.index_put_(
            (torch.as_tensor(r_off, device=dev), torch.as_tensor(c_off, device=dev)),
            torch.as_tensor(v_off.astype(np.float32), device=dev), accumulate=True)
        if cfg.proj_bf16:
            imp_dense = imp_dense.to(torch.bfloat16)
        ell_cols, ell_vals = np.zeros(0, np.int32), np.zeros(0, fdt)
        ell_ptr = np.zeros(n_imp + 1, np.int64)
        ell_nnz = np.zeros(n_imp, np.int32)
    else:
        imp_dense = torch.zeros((0, 0), dtype=F32, device=dev)
        ell_cols, ell_vals, _, ell_ptr, ell_nnz = spmv.blockell_from_full_coo(
            n_imp, r_off, c_off, v_off, dtype=fdt)

    kmap3, ct_rate = np.zeros(1, np.int64), 0.0
    if cfg.use_exponential_projector:
        kmap3, ct_rate = _ct_tables(system, cfg)

    # C(T)-in-D estimator vectors: C(T)'s num / den scattered onto D
    ct_num_imp = np.zeros(0)
    ct_den_imp = np.zeros(0)
    if (n_imp > 0 and cfg.semistochastic and cfg.ct_in_d
            and len(trial.ct_up) > 0):
        pos_ct = np_(setalg.search_dets(trial.imp_up, trial.imp_dn,
                                        trial.ct_up, trial.ct_dn))
        if not np.all(pos_ct >= 0):
            raise ValueError(
                "ct_in_d=True requires every C(T) det in the deterministic "
                f"space: {int((pos_ct < 0).sum())}/{len(pos_ct)} outside D "
                "(the estimator would silently drop their contributions)")
        ct_num_imp = np.zeros(n_imp)
        ct_den_imp = np.zeros(n_imp)
        ct_num_imp[pos_ct] = ct_num
        ct_den_imp[pos_ct] = ct_den

    t = lambda x, dt: torch.as_tensor(np.asarray(x).astype(dt), device=dev)  # noqa: E731
    ct_key = (flip(_fuse(trial.ct_up, trial.ct_dn)) if _fused_keys(cfg)
              else torch.zeros(0, dtype=I64, device=dev))
    return WalkTables(
        hb_alias_q=t(np.concatenate([s_q, o_q]), np.float32),
        hb_rs_own=t(rssign, np.float32), hb_rs_partner=t(partner, np.float32),
        hb_start=t(hb_start, np.int64), hb_count=t(hb_count, np.int64),
        hb_rowsum=t(hb_rowsum, np.float32), R2=t(R2, np.float32),
        u_table=t(U, np.float64), u_rowsum=t(u_rowsum, np.float64),
        u_alias_q=t(u_q.reshape(-1), np.float32),
        u_alias_J=t(u_J.reshape(-1), np.int64),
        sng_pack=t(sng_pack, np.float32), table=table,
        ct_up=trial.ct_up.to(dev), ct_dn=trial.ct_dn.to(dev), ct_key=ct_key.to(dev),
        ct_num=t(ct_num, fdt), ct_den=t(ct_den, fdt),
        imp_up=trial.imp_up.to(dev), imp_dn=trial.imp_dn.to(dev),
        imp_ell_cols=t(ell_cols, np.int32), imp_ell_vals=t(ell_vals, fdt),
        imp_ell_ptr=t(ell_ptr, np.int64), imp_ell_nnz=t(ell_nnz, np.int32),
        imp_diag=t(imp_diag, np.float64),
        imp_dense=imp_dense,
        imp_rows=t(r_all, np.int64), imp_cols=t(c_all, np.int64),
        imp_vals=t(v_all, fdt),
        cs_c=t(cs_c, np.float64), cs_rowsum=t(cs_rowsum, np.float64),
        cs_aliasJ=t(cs_J, np.int64), cs_aliasq=t(cs_q, np.float64),
        kmap3=t(kmap3, np.int64),
        ct_rate=torch.tensor(float(ct_rate), dtype=F64, device=dev),
        ct_num_imp=t(ct_num_imp, np.float64),
        ct_den_imp=t(ct_den_imp, np.float64),
        guide=guide)


def _scalar(x, dtype, dev):
    return torch.tensor(x, dtype=dtype, device=dev)


def init_walk_state(cfg: WalkConfig, trial, w_abs_begin: float,
                    e_trial_initial: float, tables: WalkTables) -> WalkState:
    """Initial population: Psi_T dets weighted by their coefficients and
    scaled to total |w| = w_abs_begin, plus every D det at weight 0
    (ref: do_walk.f90:1129-1368).  Under importance sampling the weights
    are multiplied by psi_g (tables.guide)."""
    M, W = cfg.mwalk, cfg.n_words
    dev = tables.hb_rowsum.device
    sdt = F32 if cfg.f32_state else F64
    all_up = torch.cat([trial.psit_up, trial.imp_up]).to(dev)
    all_dn = torch.cat([trial.psit_dn, trial.imp_dn]).to(dev)
    coefs = torch.cat([trial.psit_coef.to(dev),
                       torch.zeros(len(trial.imp_up), dtype=F64, device=dev)])
    u, d, (c,), _ = setalg.unique_dets(all_up, all_dn, [coefs])
    if cfg.guiding != "none":
        # the walker carries f = psi_g * Phi, taken positive for fixed-node
        # runs (ref do_walk.f90:1212-1217)
        from .guiding import eval_guiding
        c = eval_guiding(tables.guide, cfg.guiding, u, d, cfg.norb, cfg.nup,
                         cfg.ndn) * c
        if cfg.fixed_node:
            c = c.abs()
    n0 = len(u)
    if n0 > M:
        raise ValueError(f"mwalk={M} is smaller than the {n0} initial dets")
    scale = w_abs_begin / max(float(c.abs().sum()), 1e-300)

    up = torch.full((M, W), SENT, dtype=I64, device=dev)
    dn = torch.full((M, W), SENT, dtype=I64, device=dev)
    up[:n0], dn[:n0] = u, d
    wt = torch.zeros(M, dtype=sdt, device=dev)
    wt[:n0] = (c * scale).to(sdt)
    imp = torch.full((M,), 10 ** 6, dtype=I32, device=dev)
    if cfg.semistochastic:
        in_imp = ~setalg.setdiff_dets(u, d, tables.imp_up, tables.imp_dn)
        imp[:n0] = torch.where(in_imp, 0, 1).to(I32)
    else:
        imp[:n0] = 1
    init = torch.zeros(M, dtype=I32, device=dev)
    init[:n0] = 2                     # starting dets are initiators
    ct = torch.full((M,), -1, dtype=I64, device=dev)
    ct[:n0] = setalg.search_dets(tables.ct_up, tables.ct_dn, u, d)
    diag = torch.full((M,), DIAG_UNKNOWN, dtype=sdt, device=dev)
    diag[:n0] = _walk_diag(cfg, tables.table, u, d).to(sdt)
    return walk_state_from_arrays(cfg, w_abs_begin, e_trial_initial, up, dn,
                                  wt, init, imp, diag, ct, n0)


def walk_state_from_arrays(cfg: WalkConfig, w_abs_begin: float,
                           e_trial_initial: float, up, dn, wt, init, imp,
                           diag, ct, nwalk: int) -> WalkState:
    """A fresh walk's state around walker arrays already laid out (the
    first `nwalk` slots occupied): the control scalars start as
    init_walk_state starts them."""
    dev = wt.device
    tau0 = cfg.tau * (1 + np.log(max(cfg.w_abs_target / max(w_abs_begin, 1.0), 1.0)))
    f = lambda x: _scalar(x, F64, dev)  # noqa: E731
    return WalkState(
        up=up, dn=dn, wt=wt, init=init, imp=imp, diag=diag, ct=ct,
        nwalk=_scalar(nwalk, I32, dev), e_trial=f(e_trial_initial),
        e_est=f(e_trial_initial), tau=f(tau0), reweight_factor_inv=f(1.0),
        reached_target=_scalar(False, torch.bool, dev),
        equilibrated=_scalar(False, torch.bool, dev),
        e_num_blkabs_cum=f(0.0), e_den_blkabs_cum=f(0.0), e_num_blk=f(0.0),
        e_den_blk=f(0.0), w_abs_gen=f(w_abs_begin),
        overflow=_scalar(False, torch.bool, dev), step=_scalar(0, I32, dev))


# ---------------------------------------------------------------------------
# Step pieces
# ---------------------------------------------------------------------------

def _compact_index(mask: torch.Tensor, K: int, fill: int) -> torch.Tensor:
    """Ascending positions of the first K True rows of `mask`, `fill`
    beyond their count: an order-preserving compaction by prefix sum and
    scatter (no host sync).  int64 [K]."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(I64), 0) - 1
    dest = torch.where(mask & (pos < K), pos, K)
    out = torch.full((K + 1,), fill, dtype=I64, device=mask.device)
    out.scatter_(0, dest, torch.arange(n, dtype=I64, device=mask.device))
    return out[:K]


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor):
    """dst[idx] = val, dropping idx == len(dst) (returns a new tensor)."""
    ext = torch.cat([dst, dst[:1]])
    ext[idx] = val
    return ext[:-1]


def _search_ct(tables: WalkTables, cfg, q_up, q_dn) -> torch.Tensor:
    """C(T) index of each query det, -1 if absent."""
    n = len(tables.ct_up)
    if n == 0:
        return torch.full((len(q_up),), -1, dtype=I64, device=q_up.device)
    if tables.ct_key.numel():
        qk = flip(_fuse(q_up, q_dn))
        idx = torch.searchsorted(tables.ct_key, qk).clamp(max=n - 1)
        return torch.where(tables.ct_key[idx] == qk, idx, -1)
    return setalg.search_dets(tables.ct_up, tables.ct_dn, q_up, q_dn)


def _ct_free(tables: WalkTables) -> bool:
    """True when the C(T)-in-D estimator is active: the per-walker C(T)
    index is then never read, and fresh dets skip its search."""
    return tables.ct_num_imp.numel() > 0


def _fill_fresh(cfg, tables, up, dn, diag, ct, need):
    """Diagonal elements and (unless the C(T)-in-D estimator is active)
    C(T) indices for the rows flagged in `need`, through a cap_fresh-sized
    compaction buffer.  Returns (diag, ct, overflow, the float64 count of
    rows flagged)."""
    M = up.shape[0]
    F = cfg.cap_fresh_eff
    n_fresh = need.sum(dtype=F64)
    overflow = n_fresh > F
    fidx = _compact_index(need, F, M)
    fi = fidx.clamp(max=M - 1)
    f_up, f_dn = up[fi], dn[fi]
    f_diag = _walk_diag(cfg, tables.table, f_up, f_dn, dtype=diag.dtype)
    diag = _set_drop(diag, fidx, f_diag.to(diag.dtype))
    if not _ct_free(tables):
        ct = _set_drop(ct, fidx, _search_ct(tables, cfg, f_up, f_dn))
    return diag, ct, overflow, n_fresh


def repair_caches(state: WalkState, tables: WalkTables, cfg) -> WalkState:
    """Fill unknown diagonal / C(T) entries of resident walkers.  States
    from init_walk_state carry both and every merge fills its fresh dets,
    so this only acts on states assembled elsewhere (it reads one flag
    from the device, once per block)."""
    alive = torch.arange(cfg.mwalk, device=state.wt.device) < state.nwalk
    need = alive & (state.diag > DIAG_UNKNOWN_THRESHOLD)
    if not _ct_free(tables):
        need = need | (alive & (state.ct == -2))
    if not bool(need.any()):
        return state
    diag, ct, ovf, _ = _fill_fresh(cfg, tables, state.up, state.dn,
                                   state.diag, state.ct, need)
    return state._replace(diag=diag, ct=ct, overflow=state.overflow | ovf)


def _ct_chain(cfg, tables, up_w, dn_w, slot_valid, gen, tau, e_trial):
    """Continuous-time off-diagonal chains of the exponential projector
    (ref: move_uniform_exponential_projector do_walk.f90:3803, the
    deterministic_diagonal variant; the heg / generic modes go beyond the
    reference, whose rate bound and diagonals are hubbardk-hardwired).

    Per spawn slot, starting at its parent det (up_w, dn_w): jump times
    are drawn from the exponential distribution at total rate
    ``tables.ct_rate`` (the first one wrapped mod tau: the conditioning
    factor 1 - exp(-tau rate) is already in the child weight) and proposal
    moves are chained until the time tau.  A segment of length dt at det i
    contributes exp(dt (E_T - H_ii + rate)) (the +rate cancels the
    sampling density); a jump to det j proposed with probability p(j|i)
    contributes -H_ij / (rate p(j|i)) (thinning: exact in expectation for
    any rate > 0 and any proposal that covers the connected space).
    hubbardk mode: uniform (e_up, e_dn, r) with s by momentum conservation,
    where |H_ij| = U/N everywhere and the factor is -sign(H_ij)
    (ops/ctchain.py: one kernel launch, K7, on the card; its plain version
    on the CPU).  Invalid proposals zero the chain: variance, never bias.
    A chain still running after cfg.ct_max_jumps moves is zeroed.  Every
    mode reads the same cfg.ct_max_jumps x 6 rows of uniforms, drawn
    first; the heg / generic modes run their moves (_ct_jump_move) as
    vectorized torch rows over all slots on every device.

    Returns (up [S, W], dn [S, W], f [S] f64 chain factor, ok [S] bool,
    n_jumps, n_cut): the jumps taken over all chains and the chains
    zeroed for still running after cfg.ct_max_jumps moves, 0-d float64
    device tensors (no host sync)."""
    u = ctchain.draw_uniforms(gen, cfg.ct_max_jumps, up_w.shape[0],
                              up_w.device)
    if cfg.ct_mode == "hubbardk":
        return ctchain.chain(u, up_w, dn_w, slot_valid, tables.table,
                             tables.kmap3, tables.ct_rate, tau, e_trial,
                             cfg.norb, cfg.nup, cfg.ndn)
    return ctchain.chain_plain(
        u, up_w, dn_w, slot_valid, tables.table, tables.ct_rate, tau, e_trial,
        cfg.norb, lambda *a: _ct_jump_move(cfg, tables, *a))


def _ct_jump_move(cfg, tables, cu, cd, bits_cu, bits_cd, u6, sl):
    """One proposed CT jump of the heg / generic modes (see _ct_chain).

    With probability Ps (generic with singles only; Ps = n_s / (n_s + n_d)
    over the uniform cell counts) a single excitation: electron uniform
    over ne, target orbital uniform over norb.  Otherwise a double:
    ordered electron pair (e1 uniform over ne, e2 over the rest), target r
    for e1's spin uniform over norb, s for e2's spin from momentum
    conservation (heg: tables.kmap3, -1 = outside the cutoff) or uniform
    (generic).  p(j|i) counts every ordering that reaches j: same-spin
    doubles 4, mixed doubles 2, singles 1.  Returns the factor
    -H_ij / (rate p(j|i)) with the exact signed element, 0 for invalid or
    forbidden proposals, and the target det."""
    norb, nup, ndn = cfg.norb, cfg.nup, cfg.ndn
    ne = nup + ndn
    rate = tables.ct_rate
    heg_mode = cfg.ct_mode == "heg"
    dev = cu.device
    zero = torch.zeros((), dtype=F64, device=dev)
    occ_u = dets.occ_orbitals(bits_cu, nup)
    occ_d = dets.occ_orbitals(bits_cd, ndn)

    n_pairs_ord = ne * (ne - 1)
    if cfg.has_singles and not heg_mode:
        n_s_cells = ne * norb
        n_d_cells = (n_pairs_ord // 2) * norb * norb
        p_single = n_s_cells / (n_s_cells + n_d_cells)
    else:
        p_single = 0.0

    # electron draws over the fused list: up 0..nup-1, dn nup..ne-1
    e1 = (u6[2] * ne).to(I64).clamp(max=ne - 1)
    e2r = (u6[3] * (ne - 1)).to(I64).clamp(max=ne - 2)
    e2 = e2r + (e2r >= e1).to(I64)
    up1 = e1 < nup
    up2 = e2 < nup
    orb1 = torch.where(up1, occ_u[sl, e1.clamp(0, nup - 1)],
                       occ_d[sl, (e1 - nup).clamp(0, ndn - 1)])
    orb2 = torch.where(up2, occ_u[sl, e2.clamp(0, nup - 1)],
                       occ_d[sl, (e2 - nup).clamp(0, ndn - 1)])
    r = (u6[4] * norb).to(I64).clamp(max=norb - 1)
    if heg_mode:
        s_ = tables.kmap3[(orb1 * norb + orb2) * norb + r]
        s_ok = s_ >= 0
        s_c = s_.clamp(0, norb - 1)
    else:
        s_c = (u6[5] * norb).to(I64).clamp(max=norb - 1)
        s_ok = torch.ones_like(up1)

    same_spin = up1 == up2
    occ_r = torch.where(up1, dets.get_orb(cu, r), dets.get_orb(cd, r))
    occ_s = torch.where(up2, dets.get_orb(cu, s_c), dets.get_orb(cd, s_c))
    dbl_ok = s_ok & ~occ_r & ~occ_s & ~(same_spin & (r == s_c))

    # exact signed double element
    pl, ph = torch.minimum(orb1, orb2), torch.maximum(orb1, orb2)
    rl, rh = torch.minimum(r, s_c), torch.maximum(r, s_c)
    bits_same = torch.where(up1[:, None], bits_cu, bits_cd)
    h_same = slater.double_same_spin(tables.table, bits_same, pl, ph, rl, rh)
    p_up = torch.where(up1, orb1, orb2)
    q_dn = torch.where(up1, orb2, orb1)
    r_up = torch.where(up1, r, s_c)
    s_dn = torch.where(up1, s_c, r)
    h_mix = slater.double_opposite_spin(tables.table, bits_cu, bits_cd,
                                        p_up, r_up, q_dn, s_dn)
    h_dbl = torch.where(same_spin, h_same, h_mix)
    ways = torch.where(same_spin, 4.0, 2.0).to(F64) / n_pairs_ord
    if heg_mode:
        p_dbl = ways / norb
    else:
        p_dbl = (1.0 - p_single) * ways / (norb * norb)
    f_dbl = torch.where(dbl_ok, -h_dbl / (rate * p_dbl), zero)
    du = torch.where(up1[:, None], dets.set_orb(dets.clear_orb(cu, orb1), r), cu)
    du = torch.where(up2[:, None], dets.set_orb(dets.clear_orb(du, orb2), s_c), du)
    dd = torch.where(~up1[:, None], dets.set_orb(dets.clear_orb(cd, orb1), r), cd)
    dd = torch.where(~up2[:, None], dets.set_orb(dets.clear_orb(dd, orb2), s_c), dd)
    if p_single <= 0.0:
        return f_dbl, du, dd

    # single: electron e1 -> r
    take_single = u6[1] < p_single
    bits_other = torch.where(up1[:, None], bits_cd, bits_cu)
    h_sng = slater.single_element(tables.table, bits_same, bits_other, orb1, r)
    p_sng = p_single / (ne * norb)
    f_sng = torch.where(~occ_r, -h_sng / (rate * p_sng), zero)
    su = torch.where(up1[:, None], dets.set_orb(dets.clear_orb(cu, orb1), r), cu)
    sd = torch.where(~up1[:, None], dets.set_orb(dets.clear_orb(cd, orb1), r), cd)
    return (torch.where(take_single, f_sng, f_dbl),
            torch.where(take_single[:, None], su, du),
            torch.where(take_single[:, None], sd, dd))


def pair_weights(cfg, tables, bits_up, bits_dn, wdt):
    """The uniform / cauchy_schwarz proposals' electron pairs of each
    parent det, listed as up-up pairs, dn-dn pairs, then up-dn pairs:
    (p_pair, q_pair, weight), each [CAP, npairs]; p_pair / q_pair are
    orbitals.  A uniform pair takes part (weight 1) when its heat-bath
    row is not empty; a Cauchy-Schwarz pair weighs cs_rowsum[p]
    cs_rowsum[q]."""
    nup, ndn, norb = cfg.nup, cfg.ndn, cfg.norb
    occ_up = dets.occ_orbitals(bits_up, nup)
    occ_dn = dets.occ_orbitals(bits_dn, ndn)
    # the pair index lists are made on the device: a host array as an index
    # is a copy from the host each generation (refused inside a CUDA graph)
    dev = occ_up.device
    iu, ju = torch.triu_indices(nup, nup, 1, device=dev)
    idn, jdn = torch.triu_indices(ndn, ndn, 1, device=dev)
    io = torch.arange(nup, device=dev)[:, None].expand(nup, ndn).reshape(-1)
    jo = torch.arange(ndn, device=dev)[None, :].expand(nup, ndn).reshape(-1)
    p_pair = torch.cat([occ_up[:, iu], occ_dn[:, idn], occ_up[:, io]], dim=1)
    q_pair = torch.cat([occ_up[:, ju], occ_dn[:, jdn], occ_dn[:, jo]], dim=1)
    if cfg.proposal == "uniform":
        so_p = torch.cat([occ_up[:, iu], occ_dn[:, idn] + norb,
                          occ_up[:, io]], dim=1)
        so_q = torch.cat([occ_up[:, ju], occ_dn[:, jdn] + norb,
                          occ_dn[:, jo] + norb], dim=1)
        weight = (tables.R2[so_p, so_q] > 0).to(wdt)
    else:
        weight = (tables.cs_rowsum[p_pair] * tables.cs_rowsum[q_pair]).to(wdt)
    return p_pair, q_pair, weight


def _propose(cfg, tables, up_w, dn_w, tau, wdt, streams, gen, chain=None):
    """One proposed child per spawn slot, the step's one proposal entry
    point.  For the linear projector a double from cfg.proposal or (chem)
    a single, with the spawn-weight factor -tau H / p(proposal);
    `streams` = (ub, up_, ue, ua2, ur), five [CAP] uniform streams.  For
    the exponential projector (cfg.use_exponential_projector) the CT
    chain of each slot (_ct_chain), which draws its own uniforms: `chain`
    holds its inputs "slot_valid" and "e_trial" and gets its counters
    "n_ct_jumps" and "n_ct_cut".  Returns (spawn_up, spawn_dn, factor,
    ok).

    The heat-bath proposal is ops/hbspawn.py's: one kernel launch (K3b)
    on the card, its plain version on the CPU."""
    CAP, norb = up_w.shape[0], cfg.norb
    nup, ndn = cfg.nup, cfg.ndn
    dev = up_w.device
    if cfg.use_exponential_projector:
        *out, chain["n_ct_jumps"], chain["n_ct_cut"] = _ct_chain(
            cfg, tables, up_w, dn_w, chain["slot_valid"], gen, tau,
            chain["e_trial"])
        return tuple(out)
    if cfg.proposal == "fast_heatbath":
        return hbspawn.propose(tables, up_w, dn_w, norb, cfg.has_singles, tau,
                               wdt, streams, nup + ndn)

    ub, up_, ue, ua2, ur = streams
    zero64 = torch.zeros((), dtype=F64, device=dev)
    bits_up_c = dets.to_bits(up_w, norb)
    bits_dn_c = dets.to_bits(dn_w, norb)
    if cfg.has_singles:
        bits2 = torch.cat([bits_up_c, bits_dn_c], dim=1).to(F32)
        o_s, utot, diff_sng = hbselect.singles_rows(
            bits2, tables.u_rowsum, up_)
    p_pair, q_pair, pr_weight = pair_weights(cfg, tables, bits_up_c,
                                             bits_dn_c, wdt)
    n_uu, n_dd = nup * (nup - 1) // 2, ndn * (ndn - 1) // 2
    pair_rows = hbselect.flat_cumsum(pr_weight.to(F32))
    w2_b = pair_rows[:, -1].to(wdt)
    utot_b = utot.to(wdt) if cfg.has_singles else \
        torch.zeros(CAP, dtype=F64, device=dev)
    psing_b = torch.where(utot_b + w2_b > 0, utot_b / (utot_b + w2_b), zero64)

    # ---- doubles ----
    pair_i = hbselect.count_le(pair_rows, (up_ * w2_b).to(F32), cfg.npairs - 1)
    pp = p_pair.gather(1, pair_i[:, None])[:, 0]
    qq = q_pair.gather(1, pair_i[:, None])[:, 0]
    kk = torch.where(pair_i < n_uu, 0,
                     torch.where(pair_i < n_uu + n_dd, 1, 2))
    opp = kk == 2
    if cfg.proposal == "uniform":
        # r, s uniform over orbitals (ref off_diagonal_move_chem:4237)
        r = (ue * norb).to(I64).clamp(max=norb - 1)
        s = (ua2 * norb).to(I64).clamp(max=norb - 1)
        p_rs = torch.where(opp, 1.0 / norb ** 2, 2.0 / norb ** 2).to(F64)
        extra_fail = ~opp & (r == s)
    else:
        # r ~ c_p, s ~ c_q with c_p(r) = sqrt|(pr|pr)|
        u34 = torch.rand((2, CAP), dtype=F64, device=dev, generator=gen)
        slot_r = (ue * norb).to(I64).clamp(max=norb - 1)
        r = torch.where(u34[0] < tables.cs_aliasq[pp, slot_r], slot_r,
                        tables.cs_aliasJ[pp, slot_r])
        slot_s = (ua2 * norb).to(I64).clamp(max=norb - 1)
        s = torch.where(u34[1] < tables.cs_aliasq[qq, slot_s], slot_s,
                        tables.cs_aliasJ[qq, slot_s])
        cpq = (tables.cs_rowsum[pp].clamp(min=TINY)
               * tables.cs_rowsum[qq].clamp(min=TINY))
        p_dir = tables.cs_c[pp, r] * tables.cs_c[qq, s] / cpq
        p_swp = tables.cs_c[pp, s] * tables.cs_c[qq, r] / cpq
        p_rs = torch.where(opp, p_dir, p_dir + p_swp)
        extra_fail = (~opp & (r == s)) | (p_rs <= 0)
    # same-spin target pairs are unordered: r < s (p_rs sums both)
    r, s = (torch.where(opp, r, torch.minimum(r, s)),
            torch.where(opp, s, torch.maximum(r, s)))
    # exact element: same-spin (pr|qs) - (ps|qr), opposite-spin (pr|qs)
    tb = tables.table
    e_dir = tb.eri_value(pp, r, qq, s)
    val_tab = torch.where(opp, e_dir, e_dir - tb.eri_value(pp, s, qq, r))
    dbl_up, dbl_dn, gamma, dbl_ok = hbspawn.excite_double(up_w, dn_w, pp, qq,
                                                          r, s, kk)
    h_signed_dbl = gamma * val_tab
    prw_sel = pr_weight.gather(1, pair_i[:, None])[:, 0]
    p_sel = (prw_sel / w2_b.clamp(min=TINY) * p_rs
             * (1.0 - psing_b).clamp(min=TINY))
    w_dbl = torch.where(extra_fail | (p_sel <= 0), zero64,
                        -tau * h_signed_dbl / p_sel.clamp(min=TINY))
    if not cfg.has_singles:
        return dbl_up, dbl_dn, w_dbl, dbl_ok

    # ---- singles (chem, real-space Hubbard) ----
    take_single = ub < psing_b
    sng_up, sng_dn, w_sng, sng_ok = hbspawn.propose_single(
        tables, norb, up_w, dn_w, o_s, utot_b, diff_sng, psing_b, ue, ua2, tau)
    return (torch.where(take_single[:, None], sng_up, dbl_up),
            torch.where(take_single[:, None], sng_dn, dbl_dn),
            torch.where(take_single, w_sng, w_dbl),
            torch.where(take_single, sng_ok, dbl_ok))


def _no_mark(k: int) -> None:
    pass


def _walk_step_impl(state: WalkState, tables: WalkTables, cfg: WalkConfig,
                    gen: torch.Generator, mark=_no_mark):
    """One MC generation.  Returns (new_state, stats) with stats a dict of
    0-d device tensors plus the [N_HIST_BINS] spawn histogram.  mark(k)
    writes device timestamp k (MARK_STARTS: each of PIECES' starts;
    MARK_PROPOSE: the heat-bath proposal's or the CT chain's end inside
    the spawn piece; MARK_SORT: the full-sort merge's key sort's end
    inside the annihilation; the caller writes the last after the
    finalize)."""
    mark(0)
    M, CAP, norb = cfg.mwalk, cfg.cap_spawn, cfg.norb
    dev = state.wt.device
    wdt = F32 if cfg.f32_state else F64
    tau = state.tau
    e_trial = state.e_trial
    mesh = tables.mesh
    ar_M = torch.arange(M, dtype=I64, device=dev)
    alive = ar_M < state.nwalk
    wt = torch.where(alive, state.wt, torch.zeros((), dtype=wdt, device=dev))

    # ---------------- deterministic projection (exact on D) ---------------
    # D dets are always resident and both lists share the det order, so the
    # k-th imp == 0 slot is the k-th D det: one compaction finds them all
    n_imp = tables.imp_up.shape[0]
    proj = cfg.semistochastic and n_imp > 0
    ct_dots = None
    if proj:
        imp_pos = _compact_index(alive & (state.imp == 0), n_imp, -1)
        w_imp = torch.where(imp_pos >= 0, wt[imp_pos.clamp(min=0)],
                            torch.zeros((), dtype=wdt, device=dev))
        # sharded: the columns index the all-gathered D-weight vector
        w_vec = mesh.all_gather(w_imp) if mesh is not None else w_imp
        if tables.imp_dense.numel():
            A = tables.imp_dense
            if A.dtype == torch.bfloat16:
                # bfloat16-rounded operands, float32 products and sums
                Hw_off = A.to(F32) @ w_vec.to(torch.bfloat16).to(F32)
            else:
                Hw_off = A @ w_vec.to(F32)
        else:
            Hw_off = spmv.spmv(w_vec, tables.imp_ell_cols,
                               tables.imp_ell_vals, tables.imp_ell_ptr,
                               tables.imp_ell_nnz)
        # difference form: both terms are O(E_corr * w), so the f32 state
        # loses nothing to cancellation
        deltaw = tau * ((e_trial - tables.imp_diag) * w_imp.to(F64)
                        - Hw_off.to(F64))
        if _ct_free(tables):
            # C(T)-in-D: this generation's (e_num, e_den) are two dots
            # against the D weights of the step's INPUT state
            ct_dots = (tables.ct_num_imp @ w_imp.to(F64),
                       tables.ct_den_imp @ w_imp.to(F64))
    mark(1)

    # ---------------- spawn slot allocation -------------------------------
    # one draw for the parent-level stream and the per-slot streams
    ct_mode = cfg.use_exponential_projector
    n_streams = 0 if ct_mode else 5 + (cfg.run_type in ("partial_node", "sr"))
    u_all = torch.rand(M + n_streams * CAP, dtype=F64, device=dev, generator=gen)
    u_spawn = u_all[:M]
    g = cfg.spawn_granularity
    cut = cfg.always_spawn_cutoff * g
    if ct_mode:
        # children carry the >= 1-jump weight fraction w (1 - exp(-tau
        # rate)); the parent takes the no-jump path through its exact
        # diagonal factor below (ref: stoch_wt, do_walk.f90:3852)
        sw = (wt.to(F64) * -torch.expm1(-tables.ct_rate * tau)).to(wdt)
    else:
        sw = wt
    absw = sw.abs()
    small = absw < cut
    nchild = torch.where(
        small, (u_spawn < absw / cut).to(wdt),
        torch.round(absw / g).clamp(min=1.0)).to(I64)
    nchild = torch.where(alive, nchild, 0)
    wt_child = torch.where(small, torch.sign(sw) * cut,
                           sw / nchild.clamp(min=1).to(wdt))
    cum_child = torch.cumsum(nchild, 0)
    total_spawn = cum_child[-1]
    b = slotpar.slot_parents(cum_child, CAP)          # slot -> parent walker
    slot_valid = torch.arange(CAP, dtype=I64, device=dev) < total_spawn
    overflow = total_spawn > CAP

    up_w, dn_w = state.up[b], state.dn[b]
    wtc_b = wt_child[b]
    if ct_mode:
        # the chain's inputs; it hands back its counters in the same dict
        chain = {"slot_valid": slot_valid, "e_trial": e_trial}
        spawn_up, spawn_dn, fac, spawn_ok = _propose(
            cfg, tables, up_w, dn_w, tau, wdt, (), gen, chain)
    else:
        streams = [u_all[M + k * CAP:M + (k + 1) * CAP] for k in range(5)]
        spawn_up, spawn_dn, fac, spawn_ok = _propose(
            cfg, tables, up_w, dn_w, tau, wdt, streams, gen)
    if ct_mode or cfg.proposal == "fast_heatbath":
        mark(MARK_PROPOSE)      # the CT chain's or K3b's (plain version's) end
    spawn_ok = spawn_ok & slot_valid
    spawn_wt = fac * wtc_b
    spawn_wt = torch.where(spawn_ok, spawn_wt, torch.zeros((), dtype=spawn_wt.dtype,
                                                           device=dev))

    if cfg.time_sym:
        # map det-basis targets to representatives, as
        # connect._time_sym_postprocess does (ref chemistry.f90:6957-6992):
        # kill targets equal to the parent's reverse (a diagonal move, in
        # the cross term) and, for z < 0, self-symmetric targets; sqrt2
        # norms; swap to the representative orientation with a factor z
        sym_par = (up_w == dn_w).all(dim=1)
        sym_cand = (spawn_up == spawn_dn).all(dim=1)
        kill_ts = ((spawn_up == dn_w).all(dim=1) & (spawn_dn == up_w).all(dim=1)
                   & ~sym_par)
        if cfg.z < 0:
            kill_ts = kill_ts | sym_cand
        one = torch.ones_like(spawn_wt)
        fac = (torch.where(sym_par & ~sym_cand, SQRT2INV * one, one)
               * torch.where(sym_cand & ~sym_par, SQRT2 * one, one))
        swap_ts = setalg.keys_less(spawn_dn, spawn_up, spawn_up, spawn_dn)
        fac = torch.where(swap_ts, cfg.z * fac, fac)
        spawn_up, spawn_dn = (torch.where(swap_ts[:, None], spawn_dn, spawn_up),
                              torch.where(swap_ts[:, None], spawn_up, spawn_dn))
        spawn_ok = spawn_ok & ~kill_ts
        spawn_wt = torch.where(spawn_ok, spawn_wt * fac, torch.zeros_like(spawn_wt))

    if cfg.guiding != "none":
        # importance sampling: spawn weight x psi_g(target) / psi_g(parent)
        # (ref det_ratio_*), both evaluated at slot level
        from .guiding import eval_guiding
        psi_g_t = eval_guiding(tables.guide, cfg.guiding, spawn_up, spawn_dn,
                               norb, cfg.nup, cfg.ndn)
        gp = eval_guiding(tables.guide, cfg.guiding, up_w, dn_w, norb,
                          cfg.nup, cfg.ndn)
        ratio = psi_g_t / torch.where(gp.abs() < TINY, torch.full_like(gp, TINY), gp)
        spawn_wt = torch.where(spawn_ok, spawn_wt * ratio,
                               torch.zeros_like(spawn_wt))

    # child flags (ref: do_walk.f90:3700-3730)
    par_imp = state.imp[b]
    child_imp = torch.where(par_imp == -2, 2, par_imp.clamp(max=125) + 1)
    if cfg.semistochastic:
        child_imp = torch.where(par_imp == 0, -1, child_imp)
    child_init = torch.where(state.init[b] >= 2, 1, 0)

    if cfg.fixed_node:
        # sign-violating flow: a spawn whose sign is opposite its parent's
        # (ref move variants do_walk.f90:3460-4748)
        viol = spawn_ok & (spawn_wt * torch.sign(wtc_b) < 0)
        if cfg.run_type == "fixed_node2":
            spawn_wt = torch.where(viol, -spawn_wt, spawn_wt)
        elif cfg.run_type == "fixed_node3":
            spawn_ok = spawn_ok & ~viol
            spawn_wt = torch.where(viol, torch.zeros_like(spawn_wt), spawn_wt)
        else:
            if cfg.run_type in ("partial_node", "sr"):
                redirect = viol & (u_all[M + 5 * CAP:] < cfg.partial_node_eps)
            elif cfg.run_type == "release_node":
                redirect = viol & (state.step < cfg.release_step)
            else:                               # fixed_node1 / fixed_node4
                redirect = viol
            # redirect to the parent det: an unbiased estimate of the
            # fixed-node diagonal dump sum_viol Ht_ij.  The exact projection
            # on D already carries the D-internal part of the dump
            # (build_walk_tables), so a D parent's violating spawn whose
            # target lies in D is not redirected: it stays a D -> D spawn
            # and the merge drops it like every other.  The rest of a D
            # parent's dump (targets outside D) is kept: imp is forced to
            # the largest distance so that the D -> D rule does not discard
            # it
            if proj:
                tgt_in_d = _search_sorted_dets(cfg, tables.imp_up,
                                               tables.imp_dn, spawn_up,
                                               spawn_dn) >= 0
                redirect = redirect & ~((par_imp == 0) & tgt_in_d)
            spawn_up = torch.where(redirect[:, None], up_w, spawn_up)
            spawn_dn = torch.where(redirect[:, None], dn_w, spawn_dn)
            child_imp = torch.where(redirect, 126, child_imp)

    spawn_up = torch.where(spawn_ok[:, None], spawn_up, SENT)
    spawn_dn = torch.where(spawn_ok[:, None], spawn_dn, SENT)
    spawn_wt = spawn_wt.to(wdt)
    child_imp = torch.where(spawn_ok, child_imp, 10 ** 6).to(I32)
    child_init = torch.where(spawn_ok, child_init, 0).to(I32)

    # ---------------- owner routing over the mesh (P2) ---------------------
    # one rank owns everything: routing is the identity and is skipped
    if mesh is not None and cfg.n_dev > 1:
        from ..parallel.dist import det_owner, route_spawns
        routed, spawn_ok, route_ovf = route_spawns(
            mesh, det_owner(spawn_up, spawn_dn, cfg.n_dev), spawn_ok,
            dict(up=spawn_up, dn=spawn_dn, wt=spawn_wt, imp=child_imp,
                 init=child_init))
        spawn_up = torch.where(spawn_ok[:, None], routed["up"], SENT)
        spawn_dn = torch.where(spawn_ok[:, None], routed["dn"], SENT)
        spawn_wt = torch.where(spawn_ok, routed["wt"],
                               torch.zeros((), dtype=wdt, device=dev))
        child_imp = torch.where(spawn_ok, routed["imp"], 10 ** 6).to(I32)
        child_init = torch.where(spawn_ok, routed["init"], 0).to(I32)
        overflow = overflow | route_ovf
    mark(3)

    # ---------------- diagonal move + projection on parents ----------------
    if ct_mode:
        # exact diagonal propagation (deterministic_diagonal variant, ref
        # do_walk.f90:3851)
        diag_factor = torch.exp(tau * (e_trial - state.diag.to(F64)))
    else:
        diag_factor = (1.0 + tau * (e_trial - state.diag.to(F64))).clamp(min=0.0)
    wt_par = torch.where(alive & (state.imp >= 1), wt.to(F64) * diag_factor,
                         wt.to(F64)).to(wdt)
    if proj:
        wt_par.index_add_(0, imp_pos.clamp(min=0),
                          torch.where(imp_pos >= 0, deltaw,
                                      torch.zeros((), dtype=F64, device=dev)).to(wdt))

    merge = _full_sort_merge if cfg.full_sort_merge else _two_level_merge
    out = merge(state, cfg, tables, gen, alive, wt_par, spawn_up, spawn_dn,
                spawn_wt, spawn_ok, child_imp, child_init, overflow, mark)
    mark(6)
    new_state, stats = _finalize_step(state, tables, cfg, gen, *out,
                                      total_spawn, spawn_wt, spawn_ok, ct_dots)
    zero = torch.zeros((), dtype=F64, device=dev)
    for k in ("n_ct_jumps", "n_ct_cut"):     # 0 outside CT walks
        stats[k] = chain[k] if ct_mode else zero
    return new_state, stats


def _initiator_update(cfg, wt, init, imp):
    """Initiator promote/demote by the per-code threshold (ref
    check_initiator:6838)."""
    thr = cfg.r_initiator * (imp - cfg.initiator_min_distance).clamp(
        min=0).to(F64) ** cfg.initiator_power
    aw = wt.abs().to(F64)
    demote = (init == 2) & (((aw <= thr) & (imp > 0))
                            | ((aw <= cfg.r_initiator) & (imp == -2)))
    promote = (init < 2) & (((aw > thr) & (imp >= 0))
                            | ((aw > cfg.r_initiator) & (imp == -2)))
    init = torch.where(demote, 1, torch.where(promote, init + 1, init)).to(I32)
    if cfg.c_t_initiator:
        init = torch.where(imp == -2, 3, init).to(I32)
    return init


def _min_wt_round(cfg, gen, wt, keep, imp):
    """Stochastic min_wt rounding (ref reduce_my_walker:7196)."""
    u = torch.rand(wt.shape[0], dtype=F64, device=wt.device, generator=gen)
    aw = wt.abs()
    tiny = keep & (imp >= 1) & (aw < cfg.min_wt)
    kill = tiny & (u >= aw / cfg.min_wt)
    wt = torch.where(tiny & ~kill, torch.sign(wt) * cfg.min_wt, wt)
    return wt, keep & ~kill


def _full_sort_merge(state, cfg, tables, gen, alive, wt_par, spawn_up,
                     spawn_dn, spawn_wt, spawn_ok, child_imp, child_init,
                     overflow, mark=_no_mark):
    """Annihilation by one stable key sort of walkers + spawns and one
    fused segmented scan (ref: merge_original_with_spawned2,
    do_walk.f90:5866; merge rules :5898-5960).

    Rows carry (key, weight, packed flags, diag, ct).  The scan reduces per
    group: priority min (D=0 < C(T)=1 < transient D-spawn=2 < distance
    d -> d+1 < invalid, giving membership, merged imp and validity), the
    initiator max, the weight sum, the D->D spawn sum (discarded, ref
    :5947), diag min and ct max; everything is read at the group's end
    row."""
    M, CAP, W = cfg.mwalk, cfg.cap_spawn, cfg.n_words
    dev = wt_par.device
    wdt = wt_par.dtype
    N = M + CAP

    def pack_flags(imp, init, valid):
        code = torch.where(valid, imp.clamp(-2, 129) + 2, 131)
        return (code << 2) | torch.where(valid, init, 0)

    flags = torch.cat([pack_flags(state.imp, state.init, alive),
                       pack_flags(child_imp, child_init, spawn_ok)]).to(I32)
    # key words, most significant first (up words, then dn words)
    if _fused_keys(cfg):
        keys = [torch.cat([torch.where(alive, _fuse(state.up, state.dn), SENT),
                           torch.where(spawn_ok, _fuse(spawn_up, spawn_dn), SENT)])]
    else:
        keys = [torch.cat([torch.where(alive, state.up[:, w], SENT),
                           torch.where(spawn_ok, spawn_up[:, w], SENT)])
                for w in range(W - 1, -1, -1)] + \
               [torch.cat([torch.where(alive, state.dn[:, w], SENT),
                           torch.where(spawn_ok, spawn_dn[:, w], SENT)])
                for w in range(W - 1, -1, -1)]
    all_wt = torch.cat([wt_par, spawn_wt])
    all_diag = torch.cat([state.diag, torch.full((CAP,), DIAG_UNKNOWN, dtype=wdt,
                                                 device=dev)])
    all_ct = torch.cat([torch.where(alive, state.ct, -1),
                        torch.full((CAP,), -2, dtype=I64, device=dev)])

    # one stable sort of the flipped keys (least significant key first)
    order = torch.arange(N, dtype=I64, device=dev)
    for k in reversed(keys):
        order = order[torch.argsort(flip(k)[order], stable=True)]
    s_keys = [k[order] for k in keys]
    s_wt, s_flags = all_wt[order], flags[order]
    s_diag, s_ct = all_diag[order], all_ct[order].to(I32)
    mark(MARK_SORT)     # the key sort and its gathers' end

    neq = torch.ones(N, dtype=torch.bool, device=dev)
    neq_t = s_keys[0][1:] != s_keys[0][:-1]
    for k in s_keys[1:]:
        neq_t = neq_t | (k[1:] != k[:-1])
    neq[1:] = neq_t
    is_end = segscan.seg_ends(neq)

    code = s_flags >> 2
    init_row = s_flags & 3
    u = torch.where(code == 2, 0, torch.where(code == 0, 1,
                                              torch.where(code == 1, 2, code - 1))).to(I32)
    dwt_in = torch.where(code == 1, s_wt, torch.zeros((), dtype=wdt, device=dev))
    g_u, g_init, sc_wt, sc_dwt, g_diag, g_ct = segscan.seg_scan(
        [u, init_row, s_wt, dwt_in, s_diag, s_ct],
        ["min", "max", "sum", "sum", "min", "max"], neq)
    g_wt = torch.where(g_u == 0, sc_wt - sc_dwt, sc_wt)
    if cfg.initiator_rule == "sequential":
        g_init = seqinit.sequential_initiator(neq, s_wt, init_row)
    g_valid = is_end & (g_u <= 127)
    g_imp = torch.where(g_u == 0, 0, torch.where(g_u == 1, -2, g_u - 1)).to(I32)
    g_init = _initiator_update(cfg, g_wt, g_init, g_imp)
    keep = g_valid & ~(((g_wt == 0.0) | (g_init == 0)) & (g_imp >= 1))
    # stochastic min_wt rounding (ref reduce_my_walker:7196)
    u_rnd = torch.rand(N, dtype=F64, device=dev, generator=gen)
    aw = g_wt.abs()
    tiny = keep & (g_imp >= 1) & (aw < cfg.min_wt)
    kill = tiny & (u_rnd >= aw / cfg.min_wt)
    rounded = tiny & ~kill
    keep = keep & ~kill
    mark(5)

    # ---------------- compact to [M] (order-preserving) --------------------
    nwalk_new = keep.sum().to(I32)
    overflow = overflow | (nwalk_new > M)
    src = _compact_index(keep, M, 0)
    valid_out = torch.arange(M, dtype=I64, device=dev) < nwalk_new

    def take(x, default):
        return torch.where(valid_out, x[src], default)

    out_keys = [take(k, SENT) for k in s_keys]
    out_wt_raw = take(g_wt, torch.zeros((), dtype=wdt, device=dev))
    out_rnd = take(rounded, False)
    out_init = take(g_init, 0).to(I32)
    out_imp = take(g_imp, 127).to(I32)
    out_ct = take(g_ct.to(I64), -1)
    out_diag = take(g_diag, torch.full((), DIAG_UNKNOWN, dtype=wdt, device=dev))
    out_wt = torch.where(out_rnd, torch.sign(out_wt_raw) * cfg.min_wt, out_wt_raw)

    if _fused_keys(cfg):
        k = out_keys[0]
        sent = k == SENT
        out_up = torch.where(sent, SENT, (k >> 32) & 0xFFFFFFFF)[:, None]
        out_dn = torch.where(sent, SENT, k & 0xFFFFFFFF)[:, None]
    else:
        out_up = torch.stack([out_keys[W - 1 - w] for w in range(W)], dim=1)
        out_dn = torch.stack([out_keys[2 * W - 1 - w] for w in range(W)], dim=1)

    # fresh groups (all-spawn: diag unknown, ct == -2) get diag and C(T)
    # index here
    fresh = (out_diag > DIAG_UNKNOWN_THRESHOLD) if _ct_free(tables) \
        else (out_ct == -2)
    out_diag, out_ct, fresh_ovf, n_fresh = _fill_fresh(
        cfg, tables, out_up, out_dn, out_diag, out_ct, fresh)
    return (out_up, out_dn, out_wt, out_init, out_imp, out_diag, out_ct,
            nwalk_new, overflow | fresh_ovf, n_fresh)


def _search_sorted_dets(cfg, list_up, list_dn, q_up, q_dn):
    """Index of each query det in a sorted det list (empty slots last),
    -1 if absent."""
    n = list_up.shape[0]
    if _fused_keys(cfg):
        lk, qk = flip(_fuse(list_up, list_dn)), flip(_fuse(q_up, q_dn))
        idx = torch.searchsorted(lk, qk).clamp(max=n - 1)
        return torch.where(lk[idx] == qk, idx, -1)
    return setalg.search_dets(list_up, list_dn, q_up, q_dn)


def _lower_bound_dets(cfg, list_up, list_dn, q_up, q_dn):
    """Number of entries of a sorted det list whose key is < each query."""
    if _fused_keys(cfg):
        return torch.searchsorted(flip(_fuse(list_up, list_dn)),
                                  flip(_fuse(q_up, q_dn)))
    return setalg.lower_bound_dets(list_up, list_dn, q_up, q_dn)


def _scatter_rows(M, fill, dtype, dev, shape_tail, *pairs):
    """A [M, ...] tensor of `fill` with vals written at rows dest for each
    (dest, vals) pair; dest >= M is dropped."""
    out = torch.full((M + 1,) + shape_tail, fill, dtype=dtype, device=dev)
    for dest, vals in pairs:
        out[dest.clamp(max=M)] = vals.to(dtype)
    return out[:M]


def _two_level_merge(state, cfg, tables, gen, alive, wt_par, spawn_up,
                     spawn_dn, spawn_wt, spawn_ok, child_imp, child_init,
                     overflow, mark=_no_mark):
    """Annihilation without the big sort (ref shape:
    merge_original_with_spawned2/3, do_walk.f90:5866,6087):

      level 1: spawns whose det already exists in the sorted walker list
               merge in place by scatter-add / -max / -min;
      level 2: the remaining new-det spawns are compacted into cap_new
               slots, sorted and combined among themselves;
      level 3: surviving walkers and surviving new groups interleave into
               the output by rank (two lower-bound searches), which keeps
               the list sorted without sorting mwalk + cap_spawn rows."""
    M, W, NEW = cfg.mwalk, cfg.n_words, cfg.cap_new_eff
    CAP = spawn_wt.shape[0]
    dev = wt_par.device
    wdt = wt_par.dtype
    zero = torch.zeros((), dtype=wdt, device=dev)
    BIG = 10 ** 6

    # ---- level 1: hits on existing walkers --------------------------------
    hit = _search_sorted_dets(cfg, state.up, state.dn, spawn_up, spawn_dn)
    found = spawn_ok & (hit >= 0)
    hit_c = hit.clamp(0, M - 1)
    # stochastic D->D spawns are discarded (ref merge rule :5947); D dets
    # are always resident, so an absent target cannot be in D
    dropDD = found & (child_imp == -1) & (state.imp[hit_c] == 0)
    mw_wt = wt_par.clone().index_add_(
        0, hit_c, torch.where(found & ~dropDD, spawn_wt, zero))
    in_init = torch.zeros(M, dtype=I32, device=dev).scatter_reduce_(
        0, hit_c, torch.where(found, child_init, 0).to(I32), reduce="amax")
    imp_eff_child = torch.where(child_imp == -1, 1, child_imp).abs().to(I32)
    in_imp = torch.full((M,), BIG, dtype=I32, device=dev).scatter_reduce_(
        0, hit_c, torch.where(found, imp_eff_child, BIG).to(I32), reduce="amin")
    mw_init = torch.where(alive, torch.maximum(state.init, in_init), 0).to(I32)
    mw_imp = torch.where(state.imp >= 1, torch.minimum(state.imp, in_imp),
                         state.imp)
    mw_imp = torch.where(alive, mw_imp, BIG).to(I32)
    mw_init = _initiator_update(cfg, mw_wt, mw_init, mw_imp)
    keep_w = alive & ~(((mw_wt == 0.0) | (mw_init == 0)) & (mw_imp >= 1))
    mw_wt, keep_w = _min_wt_round(cfg, gen, mw_wt, keep_w, mw_imp)

    # ---- level 2: new-det spawns ------------------------------------------
    nf = spawn_ok & (hit < 0)
    overflow = overflow | (nf.sum() > NEW)     # conservative: slots, pre-dedup
    nidx = _compact_index(nf, NEW, CAP)
    live = nidx < CAP
    ni = nidx.clamp(max=CAP - 1)
    nu_up = torch.where(live[:, None], spawn_up[ni], SENT)
    nu_dn = torch.where(live[:, None], spawn_dn[ni], SENT)
    nu_wt = torch.where(live, spawn_wt[ni], zero)
    nu_init = torch.where(live, child_init[ni], 0).to(I32)
    nu_imp = torch.where(live, imp_eff_child[ni], BIG).to(I32)
    order = setalg.lexsort_dets(nu_up, nu_dn)
    s_nup, s_ndn = nu_up[order], nu_dn[order]
    s_nwt, s_ninit, s_nimp = nu_wt[order], nu_init[order], nu_imp[order]

    neq = ~setalg.dets_equal_adjacent(s_nup, s_ndn)
    gid = torch.cumsum(neq.to(I64), 0) - 1
    valid_n = (s_nup != SENT).all(dim=1)
    gn_wt = torch.zeros(NEW, dtype=wdt, device=dev).index_add_(
        0, gid, torch.where(valid_n, s_nwt, zero))
    gn_init = torch.zeros(NEW, dtype=I32, device=dev).scatter_reduce_(
        0, gid, torch.where(valid_n, s_ninit, 0).to(I32), reduce="amax")
    gn_imp = torch.full((NEW,), BIG, dtype=I32, device=dev).scatter_reduce_(
        0, gid, torch.where(valid_n, s_nimp, BIG).to(I32), reduce="amin")
    gn_valid = torch.zeros(NEW, dtype=I32, device=dev).scatter_reduce_(
        0, gid, valid_n.to(I32), reduce="amax") > 0
    gn_init = _initiator_update(cfg, gn_wt, gn_init, gn_imp)
    keep_g = gn_valid & ~((gn_wt == 0.0) | (gn_init == 0))
    gn_wt, keep_g = _min_wt_round(cfg, gen, gn_wt, keep_g, gn_imp)
    # group values stand at each group's FIRST row
    keep_n = neq & keep_g[gid]
    n_wt_pos, n_init_pos, n_imp_pos = gn_wt[gid], gn_init[gid], gn_imp[gid]
    mark(5)

    # ---- level 3: rank merge of the two sorted survivor lists -------------
    kw_i = torch.cumsum(keep_w.to(I64), 0)
    kn_i = torch.cumsum(keep_n.to(I64), 0)
    z1 = torch.zeros(1, dtype=I64, device=dev)
    excl_n = torch.cat([z1, kn_i])
    excl_w = torch.cat([z1, kw_i])
    lo_w = _lower_bound_dets(cfg, s_nup, s_ndn, state.up, state.dn)
    dest_w = torch.where(keep_w, kw_i - 1 + excl_n[lo_w.clamp(0, NEW)], M)
    lo_n = _lower_bound_dets(cfg, state.up, state.dn, s_nup, s_ndn)
    dest_n = torch.where(keep_n, kn_i - 1 + excl_w[lo_n.clamp(0, M)], M)
    nwalk_new = (kw_i[-1] + kn_i[-1]).to(I32)
    overflow = overflow | (nwalk_new > M)

    def both(fill, dtype, w_vals, n_vals, tail=()):
        return _scatter_rows(M, fill, dtype, dev, tail, (dest_w, w_vals),
                             (dest_n, n_vals))

    out_up = both(SENT, I64, state.up, s_nup, (W,))
    out_dn = both(SENT, I64, state.dn, s_ndn, (W,))
    out_wt = both(0, wdt, mw_wt, n_wt_pos)
    out_init = both(0, I32, mw_init, n_init_pos)
    out_imp = both(BIG, I32, mw_imp, n_imp_pos)
    # survivors keep their diag / ct; new groups go through the fresh buffer
    out_diag = both(DIAG_UNKNOWN, wdt, state.diag,
                    torch.full((NEW,), DIAG_UNKNOWN, dtype=wdt, device=dev))
    out_ct = both(-1, I64, torch.where(alive, state.ct, -1),
                  torch.full((NEW,), -2, dtype=I64, device=dev))
    fresh = (out_diag > DIAG_UNKNOWN_THRESHOLD) if _ct_free(tables) \
        else (out_ct == -2)
    out_diag, out_ct, fresh_ovf, n_fresh = _fill_fresh(
        cfg, tables, out_up, out_dn, out_diag, out_ct, fresh)
    return (out_up, out_dn, out_wt, out_init, out_imp, out_diag, out_ct,
            nwalk_new, overflow | fresh_ovf, n_fresh)


def _comb_reconfigure(w, u, n_comb: int):
    """Sorella comb resampling (ref: stochastic_reconfiguration,
    do_walk.f90:7258): systematic sampling of n_comb equal-weight walkers
    from |w| with one uniform offset `u`, which preserves sum |w| exactly
    and E[w'] = w."""
    aw = w.abs().to(F64)
    total = aw.sum()
    cum = torch.cumsum(aw, 0)
    pts = (u + torch.arange(n_comb, dtype=F64, device=w.device)) * (total / n_comb)
    idx = torch.searchsorted(cum, pts).clamp(0, w.shape[0] - 1)
    counts = torch.zeros(w.shape[0], dtype=F64, device=w.device).index_add_(
        0, idx, torch.ones_like(pts))
    return torch.sign(w).to(F64) * counts * (total / n_comb)


def _finalize_step(state, tables, cfg, gen, out_up, out_dn, out_wt, out_init,
                   out_imp, out_diag, out_ct, nwalk_new, overflow, n_fresh,
                   total_spawn, spawn_wt, spawn_ok, ct_dots=None):
    """Sorella comb (run_type sr), reweight, estimators (float64) and
    population control (ref do_walk.f90:2178, :2880-2889)."""
    dev = out_wt.device
    if cfg.run_type == "sr":
        u = torch.rand((), dtype=F64, device=dev, generator=gen)
        out_wt = _comb_reconfigure(out_wt, u, cfg.sr_nwalk or int(cfg.w_abs_target)
                                   ).to(out_wt.dtype)
    out_wt = out_wt * state.reweight_factor_inv.to(out_wt.dtype)

    if ct_dots is not None:
        # C(T)-in-D: the dots were taken at the top of the step
        e_num_gen, e_den_gen = ct_dots
    else:
        n_ct = tables.ct_num.shape[0]
        match = out_ct >= 0
        safe = out_ct.clamp(0, max(n_ct - 1, 0))
        zero = torch.zeros((), dtype=out_wt.dtype, device=dev)
        e_num_gen = torch.where(match, tables.ct_num[safe] * out_wt, zero).sum(dtype=F64)
        e_den_gen = torch.where(match, tables.ct_den[safe] * out_wt, zero).sum(dtype=F64)
    w_abs_gen = out_wt.abs().sum(dtype=F64)
    nwalk_stat = nwalk_new
    # log2-binned |spawned weight| histogram (ref gen_hist,
    # more_tools.f90:5449); bin i covers [2^(i-20), 2^(i-19))
    hist = spawnhist.spawn_histogram(spawn_wt, spawn_ok)
    if tables.mesh is not None:
        # the control scalars are global: one all-reduce of one float64
        # vector (the counts stay exact below 2^53) gives every rank the
        # same sums, so every rank takes the same branches.  The overflow
        # flag carries the state's too: repair_caches sets it on one rank
        tot = tables.mesh.all_reduce(torch.cat([
            torch.stack([e_num_gen, e_den_gen, w_abs_gen]).to(F64),
            torch.stack([nwalk_new.to(F64),
                         (overflow | state.overflow).to(F64),
                         total_spawn.to(F64), n_fresh]), hist.to(F64)]))
        e_num_gen, e_den_gen, w_abs_gen = tot[0], tot[1], tot[2]
        nwalk_stat = tot[3].to(I32)
        overflow = tot[4] > 0
        total_spawn = tot[5].to(I64)
        n_fresh = tot[6]
        hist = tot[7:].to(I64)

    e_num_blk = state.e_num_blk + e_num_gen
    e_den_blk = state.e_den_blk + e_den_gen
    den = state.e_den_blkabs_cum + e_den_blk.abs()
    e_est = torch.where(
        den != 0,
        (state.e_num_blkabs_cum + e_num_blk * torch.sign(e_den_blk)) / den,
        state.e_est)
    e_trial = state.e_trial
    tau = state.tau
    e_trial_new = torch.where(
        state.equilibrated, e_trial,
        e_trial + torch.sign(e_est - e_trial) * (e_est - e_trial).abs().clamp(max=1.0))
    pexp = (tau * cfg.pop_ctrl_exponent).clamp(max=1.0)
    ratio = (cfg.w_abs_target / w_abs_gen.clamp(min=TINY)) ** pexp
    rw_eq = ratio.clamp(0.5, 2.0)
    rw_main = (ratio / (1.0 + tau * (e_trial_new - e_est))).clamp(0.5, 2.0)
    reweight = torch.where(state.equilibrated, rw_main, rw_eq).clamp(
        max=cfg.reweight_factor_inv_max)
    reached = state.reached_target | (w_abs_gen >= cfg.w_abs_target)
    growth = cfg.tau * (1.0 + torch.log(
        (cfg.w_abs_target / w_abs_gen.clamp(min=1.0)).clamp(min=1.0)))
    tau_new = torch.where(reached, torch.full_like(growth, cfg.tau), growth)

    new_state = WalkState(
        up=out_up, dn=out_dn, wt=out_wt, init=out_init, imp=out_imp,
        diag=out_diag, ct=out_ct, nwalk=nwalk_new, e_trial=e_trial_new,
        e_est=e_est, tau=tau_new, reweight_factor_inv=reweight,
        reached_target=reached, equilibrated=state.equilibrated,
        e_num_blkabs_cum=state.e_num_blkabs_cum,
        e_den_blkabs_cum=state.e_den_blkabs_cum,
        e_num_blk=e_num_blk, e_den_blk=e_den_blk, w_abs_gen=w_abs_gen,
        overflow=state.overflow | overflow, step=state.step + 1)
    stats = dict(e_num_gen=e_num_gen, e_den_gen=e_den_gen, w_abs_gen=w_abs_gen,
                 nwalk=nwalk_stat,
                 e_gen=e_num_gen / torch.where(e_den_gen == 0,
                                               torch.full_like(e_den_gen, TINY),
                                               e_den_gen),
                 n_spawn=total_spawn,
                 reweight_factor_inv=state.reweight_factor_inv,
                 # spawn slots that left the spawn piece with a nonzero
                 # weight (the histogram's count), and new dets filled
                 n_spawn_ok=hist.sum(dtype=F64), n_fresh=n_fresh,
                 spawn_hist=hist)
    return new_state, stats


# ---------------------------------------------------------------------------
# Public step / block API
# ---------------------------------------------------------------------------

def _check_mesh(cfg: WalkConfig, tables: WalkTables) -> None:
    mesh = tables.mesh
    if (cfg.axis_name is None) != (mesh is None) or (
            mesh is not None and mesh.size != cfg.n_dev):
        raise ValueError("a sharded walk (WalkConfig.axis_name) runs on the "
                         "tables of parallel.dist.make_sharded_walk, with "
                         "n_dev equal to the mesh's size")


def _graphed(device: torch.device, tables: WalkTables) -> bool:
    """Whether walk_step / walk_block replay a captured generation (a CUDA
    graph, utils/cudagraph.py) or run the eager loop.  The card replays,
    except on a mesh (gloo cannot be captured; NCCL capture over several
    cards is unverified).  The CPU runs the eager loop, the plain version
    that the CPU tests hold against the JAX package."""
    return device.type == "cuda" and tables.mesh is None


# The one captured generation of the process: a new (tables, generator,
# cfg, device, dtype) drops it, with its memory pool, before the next
# capture; run_walk drops it when it returns.
_GRAPH: dict = {}


def release_graphs() -> None:
    """Free the captured generation and its memory pool."""
    _GRAPH.clear()


def _step_graph(state: WalkState, tables: WalkTables, cfg: WalkConfig,
                gen: torch.Generator, nstep: int) -> StepGraph:
    """The captured generation of this walk, captured for it if need be
    (a growth of the capacities changes cfg and so captures again)."""
    key = (id(tables), id(gen), cfg, state.wt.device, state.wt.dtype)
    g = _GRAPH.get(key)
    if g is None or g.rows < nstep:
        _GRAPH.clear()
        # the step holds tables and gen, so their ids stay unique while the
        # graph lives; the host-side generator state is not the step's input
        with timers.span("walk.capture"):
            g = StepGraph(
                lambda s, mark: _walk_step_impl(s, tables, cfg, gen, mark),
                state._replace(rng_state=None), gen, _TRACE_KEYS,
                ("spawn_hist",),
                counters=(segscan, spmv, hbspawn, slotpar, seqinit,
                          spawnhist, ctchain),
                rows=max(nstep, 128), marks=N_MARKS)
        _GRAPH[key] = g
    return g


def walk_step(state: WalkState, tables: WalkTables, cfg: WalkConfig,
              gen: torch.Generator):
    """One MC generation.  Returns (new_state, stats dict), tensors the
    caller owns; on the card one replay of the captured generation."""
    _check_mesh(cfg, tables)
    state = repair_caches(state, tables, cfg)
    if not _graphed(state.wt.device, tables):
        marks = Marks(N_MARKS, 1, state.wt.device)
        t0 = time.perf_counter()
        new, stats = _walk_step_impl(state, tables, cfg, gen, marks)
        marks.last()
        _note_block(marks, 1, time.perf_counter() - t0, stats)
        return new, stats
    g = _step_graph(state, tables, cfg, gen, 1)
    new, stats = g.step(state)
    _note_block(g.marks, 1, g.enqueue_seconds, stats)
    return new, stats


_TRACE_KEYS = ("e_num_gen", "e_den_gen", "w_abs_gen", "nwalk", "n_spawn",
               "reweight_factor_inv", "n_spawn_ok", "n_fresh", "n_ct_jumps",
               "n_ct_cut")

# The generation's pieces, delimited by its N_MARKS device timestamps in
# time order: mark MARK_STARTS[i] starts piece i, MARK_PROPOSE ends the
# heat-bath proposal or the CT chain inside the spawn piece (a walk with
# neither, such as the uniform proposal's, leaves it unwritten),
# MARK_SORT ends the full-sort merge's key sort and its gathers inside
# the annihilation (the two-level merge leaves it unwritten), and the
# last mark ends the finalize, after the step graph's copy-back; and what
# the last block run left to read
PIECES = ("project", "spawn", "annihilate", "fill", "finalize")
MARK_STARTS = (0, 1, 3, 5, 6)
MARK_PROPOSE = 2
MARK_SORT = 4
N_MARKS = len(PIECES) + 3
_LAST_BLOCK: dict = {}


def _note_block(marks: Marks, gens: int, enqueue_s: float, stats) -> None:
    _LAST_BLOCK.update(marks=marks, gens=gens, enqueue_s=enqueue_s,
                       stats=stats)


def block_report() -> dict | None:
    """What the last walk_block (or walk_step) ran, from its device marks
    and its per-generation counters (reading synchronizes; nothing on the
    walk's path calls it), or None before the first block:

      gens              generations in the block
      piece_ns          mean ns a generation of each of PIECES and of
                        "replay_gap": from the last mark of a generation
                        to the first of the next (the device waiting
                        between replays), summed over the block's gaps
                        and divided by its generations, so the six sum to
                        wall_ns_per_gen
      sub_ns            mean ns a generation from a piece's start to a
                        mark inside it: "propose", the spawn piece's start
                        (the slot allocation, K4, the parent gathers) to
                        the end of the heat-bath proposal (K3b) or of the
                        CT chain (absent in a walk with neither, such as
                        the uniform proposal's); "sort", the annihilation's
                        start (the parents' diagonal move and D add, the
                        merge's keys) to the end of the full-sort merge's
                        key sort and its gathers (absent under the
                        two-level merge)
      wall_ns_per_gen   first mark of the block to its last, a generation
      host_enqueue_ms_per_gen   host time spent enqueueing the block's
                        replays (the eager loop: running them), a
                        generation
      n_spawn, n_spawn_ok, n_fresh, n_ct_jumps, n_ct_cut   the counters
                        summed over the block (spawn slots drawn,
                        accepted, new dets filled; the CT chain's jumps
                        and chains cut at ct_max_jumps, 0 outside CT
                        walks)"""
    if not _LAST_BLOCK:
        return None
    n = _LAST_BLOCK["gens"]
    m = _LAST_BLOCK["marks"].read(n).astype(np.int64)
    ends = MARK_STARTS[1:] + (N_MARKS - 1,)
    ns = {p: float((m[:, b] - m[:, a]).sum()) / n
          for p, a, b in zip(PIECES, MARK_STARTS, ends)}
    ns["replay_gap"] = float((m[1:, 0] - m[:-1, -1]).sum()) / n
    sub = {}
    for k, mk, start in (("propose", MARK_PROPOSE, 1),
                         ("sort", MARK_SORT, 3)):
        if (m[:, mk] > 0).all():
            sub[k] = float((m[:, mk] - m[:, start]).sum()) / n
    stats = _LAST_BLOCK["stats"]
    return {"gens": n, "piece_ns": ns, "sub_ns": sub,
            "wall_ns_per_gen": float(m[-1, -1] - m[0, 0]) / n,
            "host_enqueue_ms_per_gen": _LAST_BLOCK["enqueue_s"] * 1e3 / n,
            **{k: float(stats[k].sum()) for k in (
                "n_spawn", "n_spawn_ok", "n_fresh", "n_ct_jumps", "n_ct_cut")}}


def walk_block(state: WalkState, tables: WalkTables, cfg: WalkConfig,
               nstep: int, gen: torch.Generator):
    """`nstep` generations with no host sync inside (repair_caches reads
    one flag before them).  On the card (but see _graphed) one captured
    generation replayed `nstep` times, the counterpart of the JAX
    package's jit over lax.scan; elsewhere _walk_block_eager.  Returns
    (state, stats) with stats[k] an [nstep] device tensor per trace key
    and stats["spawn_hist"] the block's summed histogram.

    Traced (utils/timers), the block is span "walk.block" with counters
    gens (nstep) and lost (nstep when the block overflowed, to be run
    again): reading the overflow flag synchronizes, which only the traced
    block does, so its span ends when the device has run the block.  It
    opens no profiler range: around the replays it would become the
    parent of every replayed kernel in torch.profiler's events, and
    reading them took 6.5 times as long (126 s against 19 s for 300
    generations of the C2-shaped bench walk on an H100); the device marks
    delimit the generations in the trace instead."""
    with timers.span("walk.block", profiler_range=False, gens=nstep) as sp:
        if not _graphed(state.wt.device, tables):
            out = _walk_block_eager(state, tables, cfg, nstep, gen)
        else:
            _check_mesh(cfg, tables)
            out = _replay_block(repair_caches(state, tables, cfg), tables,
                                cfg, nstep, gen)
        if sp is not None:
            sp.counts["lost"] = nstep * int(bool(out[0].overflow))
    return out


def _replay_block(state, tables, cfg, nstep, gen):
    """walk_block's generations through the captured graph (on a CPU
    state the runner runs the same body eagerly)."""
    g = _step_graph(state, tables, cfg, gen, nstep)
    new, trace, sums = g.block(state, nstep)
    stats = {k: trace[:, i] for i, k in enumerate(_TRACE_KEYS)}
    stats["spawn_hist"] = sums["spawn_hist"]
    _note_block(g.marks, nstep, g.enqueue_seconds, stats)
    return new, stats


def _walk_block_eager(state: WalkState, tables: WalkTables, cfg: WalkConfig,
                      nstep: int, gen: torch.Generator):
    """walk_block as a Python loop of eager generations: the CPU's path,
    and on the card the reference the captured walk is held to."""
    _check_mesh(cfg, tables)
    state = repair_caches(state, tables, cfg)
    rows, hist = [], None
    marks = Marks(N_MARKS, nstep, state.wt.device)
    t0 = time.perf_counter()
    for _ in range(nstep):
        state, st = _walk_step_impl(state, tables, cfg, gen, marks)
        rows.append(torch.stack([st[k].to(F64) for k in _TRACE_KEYS]))
        hist = st["spawn_hist"] if hist is None else hist + st["spawn_hist"]
        marks.last()
        marks.slot.add_(1)
    t1 = time.perf_counter()
    trace = torch.stack(rows)
    stats = {k: trace[:, i] for i, k in enumerate(_TRACE_KEYS)}
    stats["spawn_hist"] = hist
    _note_block(marks, nstep, t1 - t0, stats)
    return state, stats


def grow_walk_state(state: WalkState, cfg_new: WalkConfig) -> WalkState:
    """Pad a walker state into larger-capacity arrays (ref MWALK auto-size,
    do_walk.f90:652-674)."""
    M_old, W = state.up.shape
    pad = cfg_new.mwalk - M_old
    if pad <= 0:
        return state._replace(overflow=torch.zeros_like(state.overflow))
    dev = state.up.device

    def ext(x, fill):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)])

    return state._replace(
        up=ext(state.up, SENT), dn=ext(state.dn, SENT), wt=ext(state.wt, 0),
        init=ext(state.init, 0), imp=ext(state.imp, 10 ** 6),
        diag=ext(state.diag, DIAG_UNKNOWN), ct=ext(state.ct, -1),
        overflow=torch.zeros_like(state.overflow))


def end_of_block(state: WalkState) -> WalkState:
    """Roll the block accumulators into the blkabs cumulants."""
    return state._replace(
        e_num_blkabs_cum=state.e_num_blkabs_cum
        + state.e_num_blk * torch.sign(state.e_den_blk),
        e_den_blkabs_cum=state.e_den_blkabs_cum + state.e_den_blk.abs(),
        e_num_blk=torch.zeros_like(state.e_num_blk),
        e_den_blk=torch.zeros_like(state.e_den_blk))


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WalkResult:
    e_mixed: float
    e_err: float
    e_blocks: np.ndarray
    w_abs_trace: np.ndarray
    nwalk_trace: np.ndarray
    steps_per_sec: float
    state: WalkState
    spawn_hist: np.ndarray | None = None
    t_corr: float = float("nan")
    reblock_curve: list | None = None
    n_measured: int = 0                 # measured generations
    t_measured: float = 0.0             # their wall seconds (synchronized)
    capacity_grows: int = 0


def run_walk(system, trial, cfg: WalkConfig, nstep: int, nblk: int,
             nblk_eq: int, w_abs_begin: float, e_trial_initial: float,
             seed: int = 0, verbose: bool = True,
             max_eq_extensions: int = 3, tables: WalkTables | None = None,
             state: WalkState | None = None, guide=None,
             checkpoint_file: str | None = None,
             resume_state: WalkState | None = None,
             walkalize_file: str | None = None) -> WalkResult:
    """Block driver with equilibration and capacity escalation (ref:
    do_walk.f90:2113).  The device work of a block runs without a host
    sync; the driver reads the overflow flag and the block's trace once
    per block.  `tables` / `state` may be passed in (tests); otherwise
    they are built from the system, the trial and `guide` (the guiding
    wavefunction of cfg.guiding).

    checkpoint_file: after every block the walker state (block
    accumulators rolled, generator state attached) is written there
    (utils/checkpoint.save_walker_state).  resume_state: continue from
    such a state instead of the initial population, drawing on from its
    generator state when it has one.  walkalize_file: the per-generation
    trace `step 1/reweight w_abs e_gen nwalk` for external blocking tools
    (ref: do_walk.f90:1675,2930), appended block by block from the trace
    this function already reads once a block.

    Sharded (cfg.axis_name set): every rank calls run_walk with its own
    tables and state from parallel.dist.make_sharded_walk; each rank draws
    from a generator seeded from (seed, rank), the block's overflow flag
    and trace are all-reduced values, and rank 0 alone prints and writes
    the walkalize trace.  A checkpoint holds one process's walkers, so it
    is refused on a mesh."""
    if cfg.axis_name is not None and (tables is None or state is None
                                      and resume_state is None):
        raise ValueError("a sharded walk takes its tables and state from "
                         "parallel.dist.make_sharded_walk")
    if tables is None:
        tables = build_walk_tables(system, trial, cfg, guide=guide)
    mesh = tables.mesh
    if mesh is not None:
        from ..parallel.dist import rank_seed
        if checkpoint_file is not None:
            raise ValueError("checkpoint_file holds one process's walkers; "
                             "it is not written on a mesh")
        seed = rank_seed(seed, mesh.rank)
        if mesh.rank != 0:
            verbose, walkalize_file = False, None
    if resume_state is not None:
        state = resume_state
    if state is None:
        state = init_walk_state(cfg, trial, w_abs_begin, e_trial_initial,
                                tables)
    dev = state.wt.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if state.rng_state is not None:
        gen.set_state(state.rng_state)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # the two-level merge meets tens of thousands of new dets per step
    # while the population grows: equilibration blocks run with cap_new =
    # cap_spawn, measured blocks with the configured (small) buffer
    cfg_growth = cfg if cfg.full_sort_merge else \
        dataclasses.replace(cfg, cap_new=cfg.cap_spawn)

    e_blocks, eq_energies = [], []
    w_trace, n_trace, num_trace, den_trace = [], [], [], []
    spawn_hist = np.zeros(N_HIST_BINS, np.int64)
    t_measured, n_measured = 0.0, 0
    eq_extensions = 0
    n_eq_planned = nblk_eq
    grows = 0
    iblk = 0
    while iblk < n_eq_planned + nblk:
        equil = iblk < n_eq_planned
        start = end_of_block(state) if iblk > 0 else state
        if not equil:
            start = start._replace(
                equilibrated=torch.ones_like(start.equilibrated))
        gen_state = gen.get_state()
        sync()
        t0 = time.time()
        out, stats = walk_block(start, tables, cfg_growth if equil else cfg,
                                nstep, gen)
        if bool(out.overflow):     # the one sync of the block
            if grows >= 4:
                raise RuntimeError(
                    f"walker/spawn capacity exceeded after {grows} growth "
                    f"retries (mwalk={cfg.mwalk}, cap_spawn={cfg.cap_spawn})")
            grows += 1
            cfg = dataclasses.replace(cfg, mwalk=2 * cfg.mwalk,
                                      cap_spawn=2 * cfg.cap_spawn,
                                      cap_fresh=2 * cfg.cap_fresh)
            cfg_growth = cfg if cfg.full_sort_merge else \
                dataclasses.replace(cfg, cap_new=cfg.cap_spawn)
            if verbose:
                print(f"capacity overflow: growing to mwalk={cfg.mwalk} "
                      f"cap_spawn={cfg.cap_spawn}, rerunning block "
                      f"{iblk + 1}", flush=True)
            # rerun the block from its start state (the overflowing pass
            # dropped walkers); end_of_block is idempotent on it
            state = grow_walk_state(start, cfg)
            gen.set_state(gen_state)
            continue
        trace = {k: v.cpu().numpy() for k, v in stats.items()}
        dt = time.time() - t0
        state = out
        blk_num = float(trace["e_num_gen"].sum())
        blk_den = float(trace["e_den_gen"].sum())
        if not equil:
            num_trace.extend(trace["e_num_gen"].tolist())
            den_trace.extend(trace["e_den_gen"].tolist())
            t_measured += dt
            n_measured += nstep
        w_trace.extend(trace["w_abs_gen"].tolist())
        n_trace.extend(trace["nwalk"].astype(np.int64).tolist())
        spawn_hist += trace["spawn_hist"].astype(np.int64)
        if walkalize_file is not None:
            from ..utils.blocking import write_walkalize
            den = trace["e_den_gen"]
            write_walkalize(
                walkalize_file, trace["w_abs_gen"],
                trace["e_num_gen"] / np.where(den == 0, TINY, den),
                trace["nwalk"], trace["reweight_factor_inv"],
                start=len(w_trace) - nstep, append=len(w_trace) > nstep)
        e_blk = blk_num / blk_den if blk_den != 0 else np.nan
        (eq_energies if equil else e_blocks).append(e_blk)
        if verbose:
            print(f"block {iblk + 1}{' (eq)' if equil else ''}: "
                  f"e_blk={e_blk:.6f} e_est={float(state.e_est):.6f} "
                  f"e_trial={float(state.e_trial):.6f} "
                  f"w_abs={float(state.w_abs_gen):.1f} "
                  f"nwalk={int(state.nwalk)} steps/s={nstep / dt:.1f}",
                  flush=True)
        if checkpoint_file is not None:
            from ..utils.checkpoint import save_walker_state
            state = state._replace(rng_state=gen.get_state())
            save_walker_state(checkpoint_file, end_of_block(state))
        # equilibration auto-extension (ref: do_walk.f90:2917+)
        if (equil and iblk == n_eq_planned - 1
                and eq_extensions < max_eq_extensions
                and len(eq_energies) >= 2):
            pop_off = abs(float(state.w_abs_gen) - cfg.w_abs_target) \
                > 0.1 * cfg.w_abs_target
            drift = False
            if len(eq_energies) >= 3:
                prev = np.asarray(eq_energies[:-1], np.float64)
                prev = prev[np.isfinite(prev)]
                if len(prev) >= 2:
                    sig = np.std(prev, ddof=1)
                    if np.isfinite(sig) and sig > 0:
                        drift = abs(eq_energies[-1] - np.mean(prev)) > 3.0 * sig
            if pop_off or drift:
                n_eq_planned += 1
                eq_extensions += 1
                if verbose:
                    print(f"extending equilibration (pop_off={pop_off}, "
                          f"drift={drift})", flush=True)
        iblk += 1
    if verbose and iblk:
        # the last block's device time a generation by piece, with no
        # profiler (the same numbers as block_report)
        rep = block_report()
        ms = " ".join(f"{k}={v * 1e-6:.4f}" for k, v in
                      {**rep["piece_ns"], **rep["sub_ns"]}.items())
        print(f"Generation pieces (last block, {rep['gens']} gens, ms/gen): "
              f"{ms} wall={rep['wall_ns_per_gen'] * 1e-6:.4f} "
              f"host_enqueue={rep['host_enqueue_ms_per_gen']:.4f} "
              f"spawn_accept="
              f"{100.0 * rep['n_spawn_ok'] / max(rep['n_spawn'], 1.0):.2f}% "
              f"fresh/gen={rep['n_fresh'] / rep['gens']:.1f}", flush=True)
    release_graphs()
    state = end_of_block(state)

    e_blocks = np.asarray(e_blocks)
    e_mean = float(np.mean(e_blocks)) if len(e_blocks) else float("nan")
    e_err = (float(np.std(e_blocks, ddof=1) / np.sqrt(len(e_blocks)))
             if len(e_blocks) > 1 else float("nan"))
    t_corr, rb = float("nan"), None
    if len(num_trace) >= 32:
        # covariance-corrected ratio error with autocorrelation and the
        # reblocking plateau; report the most conservative estimate
        from ..utils.blocking import ratio_stats, reblock
        num = np.asarray(num_trace)
        den = np.asarray(den_trace)
        bs = ratio_stats(num, den)
        e_mean, t_corr = bs.e_mean, bs.t_corr
        rb = reblock(num / np.where(den == 0, 1e-300, den))
        err_rb = max((e for s, e in rb if len(num) // s >= 8), default=0.0)
        e_err = float(max([bs.e_err, err_rb]
                          + ([e_err] if np.isfinite(e_err) else [])))
    return WalkResult(e_mixed=e_mean, e_err=e_err, e_blocks=e_blocks,
                      w_abs_trace=np.asarray(w_trace),
                      nwalk_trace=np.asarray(n_trace),
                      steps_per_sec=n_measured / t_measured if t_measured else 0.0,
                      state=state, spawn_hist=spawn_hist, t_corr=t_corr,
                      reblock_curve=rb, n_measured=n_measured,
                      t_measured=t_measured, capacity_grows=grows)
