"""Carry objects of the JAX package (sqmc_tpu) over to this port.

Each function takes the JAX package's object - or any object with the
same attribute names - and reads every array with ``np.asarray``, so it
never imports jax: hand it numpy arrays, or jax arrays from a process
that has jax.  Determinant words move between uint64 and int64 by
``view``, which keeps the bits, the order (through ``dets.flip``) and the
all-ones sentinel (-1).

This lets a test hand the same system, trial and walker state to both
packages, so walk parity does not depend on the port's HCI and the other
way round.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .algo.densewalk import DenseTables, DenseWalkState
from .algo.hci import HCIResult
from .algo.legacy_ci import LegacyCIResult
from .algo.semistoch import TrialWavefunction, load_trial, trial_from_arrays
from .algo.sparseham import SparseHam
from .algo.guiding import Guiding
from .algo.walk import WalkState
from .systems.base import FermionSystem
from .systems.chem.integrals import IntegralTable
from .systems.chem.pointgroup import PointGroup
from .systems.heatbath import heatbath_from_arrays
from .systems.hubbard.cpmc import CpmcState
from .systems.hubbard.vmc import VmcState
from .systems.toy import ToySystem


def words_to_torch(words, device="cuda") -> torch.Tensor:
    """uint64 (or int64) packed words -> int64 tensor with the same bits."""
    return torch.as_tensor(np.array(words).view(np.int64), device=device)


def _opt(x, dtype, device):
    if x is None:
        return None
    return torch.as_tensor(np.array(x, dtype=dtype), device=device)


def table_from_numpy(t, device="cuda") -> IntegralTable:
    """IntegralTable from an object with the sqmc_tpu IntegralTable fields."""
    return IntegralTable(
        norb=int(t.norb), core_energy=float(t.core_energy),
        h=_opt(t.h, np.float64, device),
        orb_sym=np.asarray(t.orb_sym, np.int32),
        direct=_opt(t.direct, np.float64, device),
        exchange=_opt(t.exchange, np.float64, device),
        eri=_opt(t.eri, np.float64, device),
        sing_dir=_opt(t.sing_dir, np.float64, device),
        sing_exch=_opt(t.sing_exch, np.float64, device),
        heg_V=_opt(t.heg_V, np.float64, device),
        heg_rel=_opt(t.heg_rel, np.int64, device),
        heg_mod=_opt(getattr(t, "heg_mod", None), np.int64, device))


def system_from_numpy(s, device="cuda") -> FermionSystem:
    """FermionSystem from an object with the sqmc_tpu FermionSystem fields:
    the integral arrays and the heat-bath tables are copied, not rebuilt;
    time_sym, z and a point group in ``extra`` come along (the group
    becomes the port's own PointGroup)."""
    hb = s.heatbath
    heatbath = None if hb is None else heatbath_from_arrays(
        int(hb.norb), hb.same_rs, hb.same_val, hb.same_start, hb.same_count,
        hb.opp_rs, hb.opp_val, hb.opp_start, hb.opp_count, hb.max_double,
        device=device)
    extra = dict(s.extra)
    pg = extra.get("point_group")
    if pg is not None:
        extra["point_group"] = PointGroup(pg.name, np.asarray(pg.orb_sym))
    return FermionSystem(
        name=s.name, norb=int(s.norb), nup=int(s.nup), ndn=int(s.ndn),
        table=table_from_numpy(s.table, device), heatbath=heatbath,
        orb_sym_arr=torch.as_tensor(np.array(s.orb_sym_arr, np.int32),
                                    device=device),
        has_singles=bool(s.has_singles),
        hf_up=np.asarray(s.hf_up).view(np.int64).copy(),
        hf_dn=np.asarray(s.hf_dn).view(np.int64).copy(),
        extra=extra, time_sym=bool(getattr(s, "time_sym", False)),
        z=int(getattr(s, "z", 1)))


def sparse_ham_from_numpy(H, device="cuda") -> SparseHam:
    """SparseHam from an object with the sqmc_tpu SparseHam fields
    (strictly-upper COO rows/cols/vals and the diagonal)."""
    def t(x, dt):
        return torch.as_tensor(np.array(x, dtype=dt), device=device)

    return SparseHam(n=int(H.n), rows=t(H.rows, np.int64),
                     cols=t(H.cols, np.int64), vals=t(H.vals, np.float64),
                     diag=t(H.diag, np.float64))


def hci_result_from_numpy(res, device="cuda") -> HCIResult:
    """HCIResult from an object with the sqmc_tpu HCIResult fields: the
    dets become int64 words on `device`, the rest stays numpy."""
    return HCIResult(up=words_to_torch(res.up, device),
                     dn=words_to_torch(res.dn, device),
                     wts=np.array(res.wts, np.float64),
                     energies=np.array(res.energies, np.float64),
                     diag=np.array(res.diag, np.float64),
                     n_iters=int(res.n_iters))


def legacy_ci_result_from_numpy(res, device="cuda") -> LegacyCIResult:
    """LegacyCIResult from an object with the sqmc_tpu LegacyCIResult
    fields: the dets become int64 words on `device`, the coefficients stay
    numpy float64."""
    return LegacyCIResult(energy=float(res.energy),
                          up=words_to_torch(res.up, device),
                          dn=words_to_torch(res.dn, device),
                          coef=np.array(res.coef, np.float64),
                          energies_per_iter=[float(e) for e in
                                             res.energies_per_iter])


def trial_from_npz(src, device="cuda") -> TrialWavefunction:
    """TrialWavefunction from a save_trial npz file (either package's), or
    from a mapping / object holding the save_trial keys or the
    TrialWavefunction fields."""
    if isinstance(src, (str, bytes)) or hasattr(src, "__fspath__"):
        return load_trial(src, device=device)
    if not hasattr(src, "keys"):
        ham = src.imp_ham
        src = dict(psit_up=src.psit_up, psit_dn=src.psit_dn,
                   psit_coef=src.psit_coef, e_trial=src.e_trial,
                   ct_up=src.ct_up, ct_dn=src.ct_dn, ct_num=src.ct_num,
                   ct_den=src.ct_den, imp_up=src.imp_up, imp_dn=src.imp_dn,
                   h_rows=ham.rows, h_cols=ham.cols, h_vals=ham.vals,
                   h_diag=ham.diag)
    return trial_from_arrays(src, device=device)


def guiding_from_numpy(g, device="cuda") -> Guiding:
    """Guiding from an object with the sqmc_tpu Guiding fields."""
    def f64(x):
        return torch.as_tensor(np.array(x, dtype=np.float64), device=device)

    return Guiding(phi_up=f64(g.phi_up), phi_dn=f64(g.phi_dn), g=f64(g.g),
                   tab_up=words_to_torch(g.tab_up, device),
                   tab_dn=words_to_torch(g.tab_dn, device),
                   tab_val=f64(g.tab_val))


def walk_state_from_numpy(st, f32_state: bool = False,
                          device="cuda") -> WalkState:
    """WalkState from an object with the sqmc_tpu WalkState fields (the
    PRNG key is dropped: the port draws from a torch.Generator)."""
    sdt = torch.float32 if f32_state else torch.float64

    def arr(x, dtype):
        return torch.as_tensor(np.array(x), device=device).to(dtype)

    def f64(x):
        return torch.tensor(float(np.asarray(x)), dtype=torch.float64,
                            device=device)

    def flag(x):
        return torch.tensor(bool(np.asarray(x)), device=device)

    return WalkState(
        up=words_to_torch(st.up, device), dn=words_to_torch(st.dn, device),
        wt=arr(st.wt, sdt), init=arr(st.init, torch.int32),
        imp=arr(st.imp, torch.int32), diag=arr(st.diag, sdt),
        ct=arr(st.ct, torch.int64),
        nwalk=torch.tensor(int(np.asarray(st.nwalk)), dtype=torch.int32,
                           device=device),
        e_trial=f64(st.e_trial), e_est=f64(st.e_est), tau=f64(st.tau),
        reweight_factor_inv=f64(st.reweight_factor_inv),
        reached_target=flag(st.reached_target),
        equilibrated=flag(st.equilibrated),
        e_num_blkabs_cum=f64(st.e_num_blkabs_cum),
        e_den_blkabs_cum=f64(st.e_den_blkabs_cum),
        e_num_blk=f64(st.e_num_blk), e_den_blk=f64(st.e_den_blk),
        w_abs_gen=f64(st.w_abs_gen), overflow=flag(st.overflow),
        step=torch.tensor(int(np.asarray(st.step)), dtype=torch.int32,
                          device=device))


def sharded_walk_from_numpy(st, tb, rank: int, n_dev: int, tables,
                            f32_state: bool = False):
    """Rank `rank`'s port (WalkState, WalkTables) from the JAX package's
    sharded walk state and tables (or any objects with their field names),
    stacked [n_dev * M, ...] and [n_dev * m_loc, ...] as its
    make_sharded_walk returns them.

    `tables`: the port's tables of the same walk (from its own
    make_sharded_walk, which carries the mesh); the replicated fields and
    the mesh are kept, and this rank's D rows are taken from the JAX
    package's: the D dets, the dense row slice or, rebuilt from its
    row-complete COO (local rows, global columns), K2's block-ELL rows,
    the diagonal and the C(T)-in-D vectors.  The PRNG keys are dropped."""
    from .parallel.dist import _blockell_local
    dev = tables.hb_rowsum.device
    M = np.asarray(st.up).shape[0] // n_dev
    cut = slice(rank * M, (rank + 1) * M)

    def part(x):
        return np.asarray(x)[cut]

    view = types.SimpleNamespace(**{k: getattr(st, k) for k in WalkState._fields
                                    if hasattr(st, k)})
    for k in ("up", "dn", "wt", "init", "imp", "diag", "ct"):
        setattr(view, k, part(getattr(st, k)))
    view.nwalk = np.asarray(st.nwalk)[rank]
    state = walk_state_from_numpy(view, f32_state=f32_state, device=dev)
    m = np.asarray(tb.imp_up).shape[0] // n_dev
    loc = slice(rank * m, (rank + 1) * m)
    fdt = np.float32 if f32_state else np.float64
    ec, ev, _, ptr, nnz, diag = _blockell_local(
        m, np.asarray(tb.imp_rows).reshape(n_dev, -1)[rank],
        np.asarray(tb.imp_cols).reshape(n_dev, -1)[rank],
        np.asarray(tb.imp_vals).reshape(n_dev, -1)[rank], rank * m, dtype=fdt)
    dense = np.asarray(tb.imp_dense, np.float32)
    dense = dense[loc] if dense.shape[0] > 0 else np.zeros((0, 0), np.float32)
    ct_n, ct_d = (np.asarray(x, np.float64) for x in (tb.ct_num_imp,
                                                      tb.ct_den_imp))
    if ct_n.shape[0] > 0:
        ct_n, ct_d = ct_n[loc], ct_d[loc]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    return state, tables._replace(
        imp_up=words_to_torch(np.asarray(tb.imp_up)[loc], dev),
        imp_dn=words_to_torch(np.asarray(tb.imp_dn)[loc], dev),
        imp_ell_cols=t(ec), imp_ell_vals=t(ev), imp_ell_ptr=t(ptr),
        imp_ell_nnz=t(nnz), imp_diag=t(diag),
        imp_dense=t(dense).to(tables.imp_dense.dtype),
        ct_num_imp=t(ct_n), ct_den_imp=t(ct_d))


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float64), device=device)


def _seeded_rng_state(seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen.get_state()


def toy_system_from_numpy(s, device="cuda") -> ToySystem:
    """ToySystem from an object with the sqmc_tpu ToySystem fields; a
    spectrum already computed there comes along."""
    def opt(x):
        return None if x is None else _f64(x, device)

    return ToySystem(ham=_f64(s.ham, device), kind=s.kind,
                     energy_exact=s.energy_exact,
                     eigvec_exact=opt(s.eigvec_exact), eigvals=opt(s.eigvals))


def dense_tables_from_numpy(t, device="cuda") -> DenseTables:
    """DenseTables from an object with the sqmc_tpu DenseTables fields."""
    return DenseTables(*(_f64(getattr(t, k), device)
                         for k in DenseTables._fields))


def dense_state_from_numpy(st, seed: int = 0,
                           device="cuda") -> DenseWalkState:
    """DenseWalkState from an object with the sqmc_tpu DenseWalkState
    fields (the PRNG key is dropped: the port's state carries a torch
    generator state, seeded from `seed`)."""
    def sc(x):
        return torch.tensor(float(np.asarray(x)), dtype=torch.float64,
                            device=device)

    return DenseWalkState(
        w=_f64(st.w, device), step=int(np.asarray(st.step)),
        e_trial=sc(st.e_trial), e_est=sc(st.e_est),
        reweight_factor_inv=sc(st.reweight_factor_inv),
        equilibrated=bool(np.asarray(st.equilibrated)),
        e_num_blkabs_cum=sc(st.e_num_blkabs_cum),
        e_den_blkabs_cum=sc(st.e_den_blkabs_cum),
        e_num_blk=sc(st.e_num_blk), e_den_blk=sc(st.e_den_blk),
        w_abs_gen=sc(st.w_abs_gen),
        rng_state=_seeded_rng_state(seed, device))


def vmc_state_from_numpy(st, seed: int = 0, device="cuda") -> VmcState:
    """VmcState from an object with the sqmc_tpu VmcState fields (its key
    is dropped, as above)."""
    def idx(x):
        return torch.as_tensor(np.array(x, dtype=np.int64), device=device)

    return VmcState(idx(st.r_up), idx(st.r_dn), _f64(st.minv_up, device),
                    _f64(st.minv_dn, device), _seeded_rng_state(seed, device))


def cpmc_state_from_numpy(st, seed: int = 0, device="cuda") -> CpmcState:
    """CpmcState from an object with the sqmc_tpu CpmcState fields (its key
    is dropped, as above)."""
    return CpmcState(
        phi_up=_f64(st.phi_up, device), phi_dn=_f64(st.phi_dn, device),
        logw=_f64(st.logw, device),
        alive=torch.as_tensor(np.array(st.alive, dtype=bool), device=device),
        rng_state=_seeded_rng_state(seed, device))
