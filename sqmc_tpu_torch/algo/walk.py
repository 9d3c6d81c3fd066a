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
Randomness comes from one ``torch.Generator``; the port cannot follow the
JAX package's random stream, so only the deterministic limit matches it
value by value.

Ported configuration: run_type "none", proposal "fast_heatbath", singles
on or off, full-sort merge, "group_max" initiators, f32 or f64 state, the
plain or the time-reversal symmetrized basis (``time_sym``, z = +1 or -1:
walkers are representatives, spawns map to them with the sqrt2 norms and
z signs, and the diagonal carries z <i|H|rev i>).  Every other
WalkConfig option raises ValueError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import dets
from ..dets import flip
from ..ops import segscan, setalg, spmv
from ..ops.alias import setup_alias_np
from ..systems.chem import slater
from ..systems.chem.slater import SQRT2, SQRT2INV
from ..systems.heatbath import tri_le, tri_lt
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
    """Walk knobs, named as in sqmc_tpu.algo.walk.WalkConfig.  Options of
    the JAX package that the port does not implement keep their defaults
    here, and setting one raises ValueError."""
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
    spawn_granularity: float = 1.0
    c_t_initiator: bool = False
    cap_fresh: int = 0          # fresh-det buffer (0 = max(cap_spawn//8, 8192))
    dense_proj_max: int = 16384
    f32_state: bool = False
    # time-reversal symmetrized basis (ref hamiltonian_chem_time_sym,
    # chemistry.f90:1323), sector z = +1 or -1
    time_sym: bool = False
    z: int = 1
    # --- not ported: must keep these values ---
    proposal: str = "fast_heatbath"
    full_sort_merge: bool = True
    initiator_rule: str = "group_max"
    run_type: str = "none"
    guiding: str = "none"
    use_exponential_projector: bool = False
    axis_name: str | None = None
    n_dev: int = 1
    ct_in_d: bool = False
    cap_compact: int = 0
    cap_single: int = 0
    cap_new: int = 0
    proj_bf16: bool = False

    def __post_init__(self):
        fixed = dict(proposal="fast_heatbath", full_sort_merge=True,
                     initiator_rule="group_max", run_type="none",
                     guiding="none", use_exponential_projector=False,
                     axis_name=None, n_dev=1, ct_in_d=False, cap_compact=0,
                     cap_single=0, cap_new=0, proj_bf16=False)
        for name, want in fixed.items():
            if getattr(self, name) != want:
                raise ValueError(
                    f"WalkConfig.{name}={getattr(self, name)!r} is not "
                    f"ported to sqmc_tpu_torch (only {want!r})")
        if self.z not in (1, -1):
            raise ValueError(f"WalkConfig.z={self.z!r}: the time-symmetrized "
                             "sector is +1 or -1")

    @property
    def nelec(self):
        return self.nup + self.ndn

    @property
    def cap_fresh_eff(self):
        return self.cap_fresh or max(self.cap_spawn // 8, 8192)


N_HIST_BINS = 40
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
    imp_dense: torch.Tensor      # [n_imp, n_imp] f32 off-diagonal, or [0, 0]


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


def build_walk_tables(system, trial, cfg: WalkConfig) -> WalkTables:
    """Assemble the walk's device tables from a FermionSystem and a
    TrialWavefunction, on the system's device."""
    full_fp32_matmul()
    if cfg.time_sym != system.time_sym or (cfg.time_sym
                                           and cfg.z != system.z):
        raise ValueError("WalkConfig time_sym / z must match the system's "
                         "(the trial's H is built in the system's basis)")
    dev = system.device
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

    # projection matrix: diagonal split out, off-diagonal rows padded to
    # 128-slot blocks (block-ELL, ops/spmv.py), or dense f32 for f32-state
    # runs with n_imp <= dense_proj_max
    n_imp = len(trial.imp_up)
    H = trial.imp_ham
    fdt = np.float32 if cfg.f32_state else np.float64
    imp_diag = np_(H.diag).astype(np.float64)
    use_dense = cfg.f32_state and 0 < n_imp <= cfg.dense_proj_max
    if use_dense:
        rc = (torch.cat([H.rows, H.cols]).to(dev), torch.cat([H.cols, H.rows]).to(dev))
        imp_dense = torch.zeros((n_imp, n_imp), dtype=F32, device=dev)
        imp_dense.index_put_(rc, torch.cat([H.vals, H.vals]).to(dev, F32),
                             accumulate=True)
        ell_cols, ell_vals = np.zeros(0, np.int32), np.zeros(0, fdt)
        ell_ptr = np.zeros(n_imp + 1, np.int64)
        ell_nnz = np.zeros(n_imp, np.int32)
    else:
        imp_dense = torch.zeros((0, 0), dtype=F32, device=dev)
        ell_cols, ell_vals, _, ell_ptr, ell_nnz = spmv.blockell_from_coo(
            n_imp, H.rows, H.cols, H.vals, dtype=fdt)

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
        ct_num=t(np_(trial.ct_num), fdt), ct_den=t(np_(trial.ct_den), fdt),
        imp_up=trial.imp_up.to(dev), imp_dn=trial.imp_dn.to(dev),
        imp_ell_cols=t(ell_cols, np.int32), imp_ell_vals=t(ell_vals, fdt),
        imp_ell_ptr=t(ell_ptr, np.int64), imp_ell_nnz=t(ell_nnz, np.int32),
        imp_diag=t(imp_diag, np.float64),
        imp_dense=imp_dense)


def _scalar(x, dtype, dev):
    return torch.tensor(x, dtype=dtype, device=dev)


def init_walk_state(cfg: WalkConfig, trial, w_abs_begin: float,
                    e_trial_initial: float, tables: WalkTables) -> WalkState:
    """Initial population: Psi_T dets weighted by their coefficients and
    scaled to total |w| = w_abs_begin, plus every D det at weight 0
    (ref: do_walk.f90:1129-1368)."""
    M, W = cfg.mwalk, cfg.n_words
    dev = tables.hb_rowsum.device
    sdt = F32 if cfg.f32_state else F64
    all_up = torch.cat([trial.psit_up, trial.imp_up]).to(dev)
    all_dn = torch.cat([trial.psit_dn, trial.imp_dn]).to(dev)
    coefs = torch.cat([trial.psit_coef.to(dev),
                       torch.zeros(len(trial.imp_up), dtype=F64, device=dev)])
    u, d, (c,), _ = setalg.unique_dets(all_up, all_dn, [coefs])
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
    tau0 = cfg.tau * (1 + np.log(max(cfg.w_abs_target / max(w_abs_begin, 1.0), 1.0)))
    f = lambda x: _scalar(x, F64, dev)  # noqa: E731
    return WalkState(
        up=up, dn=dn, wt=wt, init=init, imp=imp, diag=diag, ct=ct,
        nwalk=_scalar(n0, I32, dev), e_trial=f(e_trial_initial),
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


def _fill_fresh(cfg, tables, up, dn, diag, ct, need):
    """Diagonal elements and C(T) indices for the rows flagged in `need`,
    through a cap_fresh-sized compaction buffer.  Returns (diag, ct,
    overflow)."""
    M = up.shape[0]
    F = cfg.cap_fresh_eff
    overflow = need.sum() > F
    fidx = _compact_index(need, F, M)
    fi = fidx.clamp(max=M - 1)
    f_up, f_dn = up[fi], dn[fi]
    f_diag = _walk_diag(cfg, tables.table, f_up, f_dn, dtype=diag.dtype)
    diag = _set_drop(diag, fidx, f_diag.to(diag.dtype))
    ct = _set_drop(ct, fidx, _search_ct(tables, cfg, f_up, f_dn))
    return diag, ct, overflow


def repair_caches(state: WalkState, tables: WalkTables, cfg) -> WalkState:
    """Fill unknown diagonal / C(T) entries of resident walkers.  States
    from init_walk_state carry both and every merge fills its fresh dets,
    so this only acts on states assembled elsewhere (it reads one flag
    from the device, once per block)."""
    alive = torch.arange(cfg.mwalk, device=state.wt.device) < state.nwalk
    need = alive & ((state.diag > DIAG_UNKNOWN_THRESHOLD) | (state.ct == -2))
    if not bool(need.any()):
        return state
    diag, ct, ovf = _fill_fresh(cfg, tables, state.up, state.dn, state.diag,
                                state.ct, need)
    return state._replace(diag=diag, ct=ct, overflow=state.overflow | ovf)


def _sel_cell(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Realized cumulative cell rows[idx] - rows[idx-1] (0 before the
    first column): the probability the count-based draw used."""
    hi = rows.gather(1, idx[:, None])[:, 0]
    lo = rows.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0]
    return hi - torch.where(idx > 0, lo, torch.zeros_like(lo))


def _count_le(rows: torch.Tensor, targ: torch.Tensor, top: int) -> torch.Tensor:
    """Index drawn from a cumulative row: #entries <= target, capped."""
    return (rows <= targ[:, None]).sum(dim=1).clamp(max=top)


def _sign(n: torch.Tensor) -> torch.Tensor:
    return torch.where(n % 2 == 0, 1.0, -1.0).to(F64)


def _walk_step_impl(state: WalkState, tables: WalkTables, cfg: WalkConfig,
                    gen: torch.Generator):
    """One MC generation.  Returns (new_state, stats) with stats a dict of
    0-d device tensors plus the [N_HIST_BINS] spawn histogram."""
    M, CAP, norb = cfg.mwalk, cfg.cap_spawn, cfg.norb
    dev = state.wt.device
    wdt = F32 if cfg.f32_state else F64
    tau = state.tau
    e_trial = state.e_trial
    ar_M = torch.arange(M, dtype=I64, device=dev)
    alive = ar_M < state.nwalk
    wt = torch.where(alive, state.wt, torch.zeros((), dtype=wdt, device=dev))

    # ---------------- deterministic projection (exact on D) ---------------
    # D dets are always resident and both lists share the det order, so the
    # k-th imp == 0 slot is the k-th D det: one compaction finds them all
    n_imp = tables.imp_up.shape[0]
    proj = cfg.semistochastic and n_imp > 0
    if proj:
        imp_pos = _compact_index(alive & (state.imp == 0), n_imp, -1)
        w_imp = torch.where(imp_pos >= 0, wt[imp_pos.clamp(min=0)],
                            torch.zeros((), dtype=wdt, device=dev))
        if tables.imp_dense.numel():
            Hw_off = tables.imp_dense @ w_imp.to(F32)
        else:
            Hw_off = spmv.spmv(w_imp, tables.imp_ell_cols,
                               tables.imp_ell_vals, tables.imp_ell_ptr,
                               tables.imp_ell_nnz)
        # difference form: both terms are O(E_corr * w), so the f32 state
        # loses nothing to cancellation
        deltaw = tau * ((e_trial - tables.imp_diag) * w_imp.to(F64)
                        - Hw_off.to(F64))

    # ---------------- spawn slot allocation -------------------------------
    # one draw for the parent-level and all five per-slot streams
    u_all = torch.rand(M + 5 * CAP, dtype=F64, device=dev, generator=gen)
    u_spawn = u_all[:M]
    g = cfg.spawn_granularity
    cut = cfg.always_spawn_cutoff * g
    absw = wt.abs()
    small = absw < cut
    nchild = torch.where(
        small, (u_spawn < absw / cut).to(wdt),
        torch.round(absw / g).clamp(min=1.0)).to(I64)
    nchild = torch.where(alive, nchild, 0)
    wt_child = torch.where(small, torch.sign(wt) * cut,
                           wt / nchild.clamp(min=1).to(wdt))
    cum_child = torch.cumsum(nchild, 0)
    total_spawn = cum_child[-1]
    off_child = cum_child - nchild
    # slot -> parent: each walker's index at its first slot, forward-filled
    # by a running max (walkers are ascending; among walkers sharing an
    # offset only the last one has children)
    seed_par = torch.full((CAP,), -1, dtype=I64, device=dev)
    seed_par.scatter_reduce_(0, off_child.clamp(0, CAP - 1), ar_M, reduce="amax")
    b = torch.cummax(seed_par, 0).values.clamp(0, M - 1)
    slot_valid = torch.arange(CAP, dtype=I64, device=dev) < total_spawn
    overflow = total_spawn > CAP

    ub = u_all[M:M + CAP]                       # branch
    up_ = u_all[M + CAP:M + 2 * CAP]            # pair / electron select
    ue = u_all[M + 2 * CAP:M + 3 * CAP]         # entry / orbital select
    ua2 = u_all[M + 3 * CAP:M + 4 * CAP]        # alias accept
    ur = u_all[M + 4 * CAP:M + 5 * CAP]         # in-row alias slot

    up_w, dn_w = state.up[b], state.dn[b]
    wtc_b = wt_child[b]
    bits_up_c = dets.to_bits(up_w, norb)
    bits_dn_c = dets.to_bits(dn_w, norb)
    n2 = 2 * norb
    ntri_s = norb * (norb - 1) // 2
    bits2 = torch.cat([bits_up_c, bits_dn_c], dim=1).to(F32)     # [CAP, 2n]

    if cfg.has_singles:
        u2 = tables.u_rowsum.to(F32).repeat(2)
        sing_rows = torch.cumsum(bits2 * u2[None, :], dim=1)
        utot_b = sing_rows[:, -1].to(wdt)
    else:
        sing_rows = None
        utot_b = torch.zeros(CAP, dtype=F64, device=dev)

    # hierarchical pair selection: spin-orbital a ~ m_a = sum_occ R2[a, q],
    # then b | a ~ R2[a, b] over occupied b; the realized unordered-pair
    # probability is the two-path sum of realized cumulative cells
    R2 = tables.R2
    mu = bits2 @ R2
    mu_rows = torch.cumsum(mu * bits2, dim=1)
    m_tot = mu_rows[:, -1]
    w2_b = (0.5 * m_tot).to(wdt)
    psing_b = torch.where(utot_b + w2_b > 0, utot_b / (utot_b + w2_b),
                          torch.zeros((), dtype=F64, device=dev))
    take_single = (ub < psing_b) if cfg.has_singles else \
        torch.zeros(CAP, dtype=torch.bool, device=dev)

    # ---- doubles ----
    o1 = _count_le(mu_rows, (up_ * m_tot).to(F32), n2 - 1)
    r1_rows = torch.cumsum(R2[o1] * bits2, dim=1)
    s1q = r1_rows[:, -1]
    o2 = _count_le(r1_rows, (ue * s1q).to(F32), n2 - 1)
    r2_rows = torch.cumsum(R2[o2] * bits2, dim=1)
    s2q = r2_rows[:, -1]
    p_pair_q = (_sel_cell(mu_rows, o1) * _sel_cell(r1_rows, o2) / s1q.clamp(min=TINY)
                + _sel_cell(mu_rows, o2) * _sel_cell(r2_rows, o1) / s2q.clamp(min=TINY)
                ) / m_tot.clamp(min=TINY)
    pair_fail = ((o1 == o2) | (m_tot <= 0) | (s1q <= 0) | (s2q <= 0)
                 | (p_pair_q <= 0))
    up1 = o1 < norb
    up2 = o2 < norb
    orb1 = torch.where(up1, o1, o1 - norb)
    orb2 = torch.where(up2, o2, o2 - norb)
    same_up_k = up1 & up2
    kk = torch.where(same_up_k, 0, torch.where(~up1 & ~up2, 1, 2))
    opp = kk == 2
    # opposite-spin: pp = the up orbital, qq = the dn orbital; same-spin:
    # pp < qq
    pp = torch.where(opp, torch.where(up1, orb1, orb2), torch.minimum(orb1, orb2))
    qq = torch.where(opp, torch.where(up1, orb2, orb1), torch.maximum(orb1, orb2))
    a_s = torch.minimum(pp, qq)
    b_s = torch.maximum(pp, qq)
    rc = torch.where(opp, ntri_s + tri_le(a_s, b_s), tri_lt(a_s, b_s))
    st = tables.hb_start[rc]
    cnt = tables.hb_count[rc]
    S_exact = tables.hb_rowsum[rc]
    # O(1) in-row target ~ |H|: uniform slot, then accept-or-alias
    n_cat = tables.hb_alias_q.shape[0]
    slot = torch.minimum((ur * cnt).to(I64), (cnt - 1).clamp(min=0))
    i0 = (st + slot).clamp(0, n_cat - 1)
    rv = torch.where(ua2.to(F32) < tables.hb_alias_q[i0],
                     tables.hb_rs_own[i0], tables.hb_rs_partner[i0])
    rs = rv.abs().to(I64) - 1
    r_tab = rs // norb
    s_tab = rs % norb
    swp = opp & (pp > qq)
    r = torch.where(swp, s_tab, r_tab)
    s = torch.where(swp, r_tab, s_tab)
    r_occ = torch.where(opp | (kk == 0), dets.get_orb(up_w, r), dets.get_orb(dn_w, r))
    s_occ = torch.where(opp, dets.get_orb(dn_w, s),
                        torch.where(kk == 0, dets.get_orb(up_w, s),
                                    dets.get_orb(dn_w, s)))
    dbl_ok = ~(r_occ | s_occ)

    def in_window(x, a_pos, b_pos):
        return ((x >= torch.minimum(a_pos, b_pos))
                & (x < torch.maximum(a_pos, b_pos))).to(I32)

    words_same = torch.where(same_up_k[:, None], up_w, dn_w)
    c1 = (dets.count_below(words_same, pp, r) - in_window(pp, pp, r)
          - in_window(qq, pp, r))
    c2 = (dets.count_below(words_same, qq, s) - in_window(pp, qq, s)
          - in_window(qq, qq, s))
    cu_ = dets.count_below(up_w, pp, r) - in_window(pp, pp, r)
    cd_ = dets.count_below(dn_w, qq, s) - in_window(qq, qq, s)
    gamma = torch.where(opp, _sign(cu_ + cd_), _sign(c1 + c2))
    h_signed_dbl = gamma * rv.to(F64)            # rv carries the sign only
    # p(spawn) = (1 - p_single) p{pair} |H| / S_exact: dividing by exactly
    # the realized probability keeps E[spawn] = -tau H w independent of
    # how the selection cumulatives were rounded (exact S/diff correction)
    w_dbl = torch.where(
        pair_fail, torch.zeros((), dtype=F64, device=dev),
        -tau * torch.sign(h_signed_dbl) * S_exact.to(wdt)
        / ((1.0 - psing_b) * p_pair_q.to(wdt)).clamp(min=TINY))
    dbl_up = torch.where(
        opp[:, None], dets.set_orb(dets.clear_orb(up_w, pp), r),
        torch.where(same_up_k[:, None],
                    dets.set_orb(dets.set_orb(dets.clear_orb(
                        dets.clear_orb(up_w, pp), qq), r), s), up_w))
    dbl_dn = torch.where(
        opp[:, None], dets.set_orb(dets.clear_orb(dn_w, qq), s),
        torch.where(same_up_k[:, None], dn_w,
                    dets.set_orb(dets.set_orb(dets.clear_orb(
                        dets.clear_orb(dn_w, pp), qq), r), s)))

    # ---- singles (chem) ----
    if cfg.has_singles:
        o_s = _count_le(sing_rows, (up_ * utot_b).to(F32), n2 - 1)
        e_up = o_s < norb
        p_s = torch.where(e_up, o_s, o_s - norb)
        slot_r = (ue * norb).to(I64).clamp(max=norb - 1)
        ia = p_s * norb + slot_r
        r_s = torch.where(ua2.to(F32) < tables.u_alias_q[ia], slot_r,
                          tables.u_alias_J[ia])
        r_s_occ = torch.where(e_up, dets.get_orb(up_w, r_s), dets.get_orb(dn_w, r_s))
        bits_same = torch.where(e_up[:, None], bits_up_c, bits_dn_c)
        bits_other = torch.where(e_up[:, None], bits_dn_c, bits_up_c)
        words_same_s = torch.where(e_up[:, None], up_w, dn_w)
        sgn_s = _sign(dets.count_below(words_same_s, p_s, r_s)
                      - (p_s < r_s).to(I32))
        if tables.sng_pack.numel():
            # f32 state: (pr|qq), (pq|qr), h_pr and U[p,r] in one row gather
            srow = tables.sng_pack[p_s * norb + r_s]
            direct_row = srow[:, :norb]
            exch_row = srow[:, norb:2 * norb]
            qs = torch.arange(norb, device=dev)
            mask_pr = (qs[None, :] != p_s[:, None]) & (qs[None, :] != r_s[:, None])
            h_sng = sgn_s * (srow[:, 2 * norb]
                             + ((direct_row - exch_row) * bits_same.to(F32)
                                * mask_pr).sum(-1)
                             + (direct_row * bits_other.to(F32)).sum(-1))
            u_sel = srow[:, 2 * norb + 1]
        else:
            h_sng = sgn_s * slater.single_element_no_sign(
                tables.table, bits_same, bits_other, p_s, r_s)
            u_sel = tables.u_table[p_s, r_s]
        p_sel_sng = psing_b * u_sel / utot_b.clamp(min=TINY)
        w_s = -tau * h_sng / p_sel_sng.clamp(min=TINY)
        # realized p(spin-orbital) = diff / Utot from the cumulative, the
        # alias draw is normalized by the exact row sum: multiply by S/diff
        S_sng = tables.u_rowsum[p_s].to(w_s.dtype)
        diff_sng = _sel_cell(sing_rows, o_s).to(w_s.dtype)
        w_sng = w_s * torch.where(diff_sng > 0, S_sng / diff_sng,
                                  torch.ones((), dtype=w_s.dtype, device=dev))
        sng_up = torch.where(e_up[:, None],
                             dets.set_orb(dets.clear_orb(up_w, p_s), r_s), up_w)
        sng_dn = torch.where(e_up[:, None], dn_w,
                             dets.set_orb(dets.clear_orb(dn_w, p_s), r_s))
        sng_ok = (~r_s_occ) & (u_sel > 0)
        spawn_up = torch.where(take_single[:, None], sng_up, dbl_up)
        spawn_dn = torch.where(take_single[:, None], sng_dn, dbl_dn)
        spawn_ok = torch.where(take_single, sng_ok, dbl_ok) & slot_valid
        spawn_wt = torch.where(take_single, w_sng, w_dbl) * wtc_b
    else:
        spawn_up, spawn_dn = dbl_up, dbl_dn
        spawn_ok = dbl_ok & slot_valid
        spawn_wt = w_dbl * wtc_b
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

    # child flags (ref: do_walk.f90:3700-3730)
    par_imp = state.imp[b]
    child_imp = torch.where(par_imp == -2, 2, par_imp.clamp(max=125) + 1)
    if cfg.semistochastic:
        child_imp = torch.where(par_imp == 0, -1, child_imp)
    child_init = torch.where(state.init[b] >= 2, 1, 0)
    spawn_up = torch.where(spawn_ok[:, None], spawn_up, SENT)
    spawn_dn = torch.where(spawn_ok[:, None], spawn_dn, SENT)
    spawn_wt = spawn_wt.to(wdt)
    child_imp = torch.where(spawn_ok, child_imp, 10 ** 6).to(I32)
    child_init = torch.where(spawn_ok, child_init, 0).to(I32)

    # ---------------- diagonal move + projection on parents ----------------
    diag_factor = (1.0 + tau * (e_trial - state.diag.to(F64))).clamp(min=0.0)
    wt_par = torch.where(alive & (state.imp >= 1), wt.to(F64) * diag_factor,
                         wt.to(F64)).to(wdt)
    if proj:
        wt_par.index_add_(0, imp_pos.clamp(min=0),
                          torch.where(imp_pos >= 0, deltaw,
                                      torch.zeros((), dtype=F64, device=dev)).to(wdt))

    out = _full_sort_merge(state, cfg, tables, gen, alive, wt_par, spawn_up,
                           spawn_dn, spawn_wt, spawn_ok, child_imp, child_init,
                           overflow)
    return _finalize_step(state, tables, cfg, *out, total_spawn, spawn_wt,
                          spawn_ok)


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


def _full_sort_merge(state, cfg, tables, gen, alive, wt_par, spawn_up,
                     spawn_dn, spawn_wt, spawn_ok, child_imp, child_init,
                     overflow):
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

    # fresh groups (all-spawn: ct == -2) get diag and C(T) index here
    out_diag, out_ct, fresh_ovf = _fill_fresh(cfg, tables, out_up, out_dn,
                                              out_diag, out_ct, out_ct == -2)
    return (out_up, out_dn, out_wt, out_init, out_imp, out_diag, out_ct,
            nwalk_new, overflow | fresh_ovf)


def _finalize_step(state, tables, cfg, out_up, out_dn, out_wt, out_init,
                   out_imp, out_diag, out_ct, nwalk_new, overflow,
                   total_spawn, spawn_wt, spawn_ok):
    """Reweight, estimators (float64) and population control (ref
    do_walk.f90:2178, :2880-2889)."""
    dev = out_wt.device
    out_wt = out_wt * state.reweight_factor_inv.to(out_wt.dtype)

    n_ct = tables.ct_num.shape[0]
    match = out_ct >= 0
    safe = out_ct.clamp(0, max(n_ct - 1, 0))
    zero = torch.zeros((), dtype=out_wt.dtype, device=dev)
    e_num_gen = torch.where(match, tables.ct_num[safe] * out_wt, zero).sum(dtype=F64)
    e_den_gen = torch.where(match, tables.ct_den[safe] * out_wt, zero).sum(dtype=F64)
    w_abs_gen = out_wt.abs().sum(dtype=F64)

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
    # log2-binned |spawned weight| histogram (ref gen_hist,
    # more_tools.f90:5449); bin i covers [2^(i-20), 2^(i-19))
    aw = spawn_wt.abs()
    hbin = (torch.floor(torch.log2(aw.clamp(min=TINY))) + 20.0).clamp(
        0, N_HIST_BINS - 1).to(I64)
    hbin = torch.where(spawn_ok & (aw > 0), hbin, N_HIST_BINS)
    hist = torch.zeros(N_HIST_BINS + 1, dtype=I64, device=dev)
    hist.scatter_add_(0, hbin, torch.ones_like(hbin))
    stats = dict(e_num_gen=e_num_gen, e_den_gen=e_den_gen, w_abs_gen=w_abs_gen,
                 nwalk=nwalk_new,
                 e_gen=e_num_gen / torch.where(e_den_gen == 0,
                                               torch.full_like(e_den_gen, TINY),
                                               e_den_gen),
                 n_spawn=total_spawn,
                 reweight_factor_inv=state.reweight_factor_inv,
                 spawn_hist=hist[:N_HIST_BINS])
    return new_state, stats


# ---------------------------------------------------------------------------
# Public step / block API
# ---------------------------------------------------------------------------

def walk_step(state: WalkState, tables: WalkTables, cfg: WalkConfig,
              gen: torch.Generator):
    """One MC generation.  Returns (new_state, stats dict)."""
    state = repair_caches(state, tables, cfg)
    return _walk_step_impl(state, tables, cfg, gen)


_TRACE_KEYS = ("e_num_gen", "e_den_gen", "w_abs_gen", "nwalk", "n_spawn")


def walk_block(state: WalkState, tables: WalkTables, cfg: WalkConfig,
               nstep: int, gen: torch.Generator):
    """`nstep` generations as a Python loop with no host sync inside.
    Returns (state, stats) with stats[k] an [nstep] device tensor per
    trace key and stats["spawn_hist"] the block's summed histogram."""
    state = repair_caches(state, tables, cfg)
    rows, hist = [], None
    for _ in range(nstep):
        state, st = _walk_step_impl(state, tables, cfg, gen)
        rows.append(torch.stack([st[k].to(F64) for k in _TRACE_KEYS]))
        hist = st["spawn_hist"] if hist is None else hist + st["spawn_hist"]
    trace = torch.stack(rows)
    stats = {k: trace[:, i] for i, k in enumerate(_TRACE_KEYS)}
    stats["spawn_hist"] = hist
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
             state: WalkState | None = None) -> WalkResult:
    """Block driver with equilibration and capacity escalation (ref:
    do_walk.f90:2113).  The device work of a block runs without a host
    sync; the driver reads the overflow flag and the block's trace once
    per block.  `tables` / `state` may be passed in (tests); otherwise
    they are built from the system and trial."""
    if tables is None:
        tables = build_walk_tables(system, trial, cfg)
    if state is None:
        state = init_walk_state(cfg, trial, w_abs_begin, e_trial_initial,
                                tables)
    dev = state.wt.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

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
        out, stats = walk_block(start, tables, cfg, nstep, gen)
        if bool(out.overflow):     # the one sync of the block
            if grows >= 4:
                raise RuntimeError(
                    f"walker/spawn capacity exceeded after {grows} growth "
                    f"retries (mwalk={cfg.mwalk}, cap_spawn={cfg.cap_spawn})")
            grows += 1
            cfg = dataclasses.replace(cfg, mwalk=2 * cfg.mwalk,
                                      cap_spawn=2 * cfg.cap_spawn)
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
        e_blk = blk_num / blk_den if blk_den != 0 else np.nan
        (eq_energies if equil else e_blocks).append(e_blk)
        if verbose:
            print(f"block {iblk + 1}{' (eq)' if equil else ''}: "
                  f"e_blk={e_blk:.6f} e_est={float(state.e_est):.6f} "
                  f"e_trial={float(state.e_trial):.6f} "
                  f"w_abs={float(state.w_abs_gen):.1f} "
                  f"nwalk={int(state.nwalk)} steps/s={nstep / dt:.1f}",
                  flush=True)
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
