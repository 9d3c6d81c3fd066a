"""Trial wavefunction, deterministic space and C(T) (port of
build_trial_wavefunction / _assemble_trial / save_trial / load_trial in
sqmc_tpu/algo/semistoch.py; ref: semistoch.f90 generate_space_iterate:145,
generate_psi_t_connected_e_loc:27).

  * Psi_T   = top n_psi_t dets of an HCI wavefunction by |coef|
  * D space = top n_imp dets of the same wavefunction, with its sparse H
  * C(T)    = all dets connected to Psi_T, with e_loc_num(j) = sum_i H_ji c_i
    and e_loc_den(j) = c_j
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import setalg
from .connect import generate_connections
from .hci import run_hci
from .sparseham import SparseHam, build_sparse_ham


@dataclasses.dataclass
class TrialWavefunction:
    # Psi_T (sorted by det key)
    psit_up: torch.Tensor
    psit_dn: torch.Tensor
    psit_coef: torch.Tensor       # float64
    e_trial: float                # variational energy of Psi_T
    # C(T): connections of Psi_T incl. Psi_T itself (sorted)
    ct_up: torch.Tensor
    ct_dn: torch.Tensor
    ct_num: torch.Tensor          # sum_i H_ji c_i
    ct_den: torch.Tensor          # c_j (0 outside Psi_T)
    # deterministic space (sorted) + its Hamiltonian
    imp_up: torch.Tensor
    imp_dn: torch.Tensor
    imp_ham: SparseHam


def _top_by_coef(up, dn, coef, n_keep):
    order = torch.argsort(-coef.abs(), stable=True)[:n_keep]
    u, d, c = up[order], dn[order], coef[order]
    s = setalg.lexsort_dets(u, d)
    return u[s], d[s], c[s]


def _assemble_trial(system, up, dn, wts, n_psi_t: int, imp_up,
                    imp_dn) -> TrialWavefunction:
    """Pick Psi_T, build its C(T) local-energy cache and the D-space H."""
    nup, ndn, norb = system.nup, system.ndn, system.norb
    pu, pd, pc = _top_by_coef(up, dn, wts, n_psi_t)
    pc = pc / torch.linalg.norm(pc)
    Hp = build_sparse_ham(system.table, pu, pd, nup, ndn, norb)
    pc_np = pc.cpu().numpy()
    e_trial = float(pc_np @ Hp.dense().cpu().numpy() @ pc_np)
    imp_ham = build_sparse_ham(system.table, imp_up, imp_dn, nup, ndn, norb)

    # C(T): every nonzero connection of Psi_T (eps -> 0+), with summed H*c
    eps_tiny = torch.full((len(pu),), 1e-300, dtype=torch.float64,
                          device=pu.device)
    cu, cd, h, ref = generate_connections(
        system, pu, pd, eps_tiny / pc.abs().clamp(min=1e-300))
    all_up = torch.cat([cu, pu])
    all_dn = torch.cat([cd, pd])
    all_num = torch.cat([h * pc[ref], Hp.diag * pc])
    cu_u, cd_u, (num,), _ = setalg.unique_dets(all_up, all_dn, [all_num])
    den = torch.zeros(len(cu_u), dtype=torch.float64, device=pu.device)
    den[setalg.search_dets(cu_u, cd_u, pu, pd)] = pc
    return TrialWavefunction(psit_up=pu, psit_dn=pd, psit_coef=pc,
                             e_trial=e_trial, ct_up=cu_u, ct_dn=cd_u,
                             ct_num=num, ct_den=den, imp_up=imp_up,
                             imp_dn=imp_dn, imp_ham=imp_ham)


def build_trial_wavefunction(system, eps_var: float = 2e-3,
                             n_psi_t: int = 200, n_imp: int = 1000,
                             verbose: bool = False) -> TrialWavefunction:
    """Psi_T + D + C(T) for the walk, from one HCI run."""
    res = run_hci(system, eps_var=eps_var, eps_var_sched=[eps_var] * 10,
                  verbose=verbose)
    wts = torch.as_tensor(res.wts[:, 0], device=res.up.device)
    iu, idn, _ = _top_by_coef(res.up, res.dn, wts, n_imp)
    return _assemble_trial(system, res.up, res.dn, wts, n_psi_t, iu, idn)


def _u64(words: torch.Tensor) -> np.ndarray:
    return words.cpu().numpy().view(np.uint64)


def save_trial(trial: TrialWavefunction, path: str):
    """Serialize with the JAX package's npz keys and types (words as
    uint64, COO indices int32), so either package reads the file."""
    ham = trial.imp_ham
    np.savez_compressed(
        path, psit_up=_u64(trial.psit_up), psit_dn=_u64(trial.psit_dn),
        psit_coef=trial.psit_coef.cpu().numpy(), e_trial=trial.e_trial,
        ct_up=_u64(trial.ct_up), ct_dn=_u64(trial.ct_dn),
        ct_num=trial.ct_num.cpu().numpy(), ct_den=trial.ct_den.cpu().numpy(),
        imp_up=_u64(trial.imp_up), imp_dn=_u64(trial.imp_dn),
        h_rows=ham.rows.cpu().numpy().astype(np.int32),
        h_cols=ham.cols.cpu().numpy().astype(np.int32),
        h_vals=ham.vals.cpu().numpy(), h_diag=ham.diag.cpu().numpy())


def trial_from_arrays(z, device="cuda") -> TrialWavefunction:
    """TrialWavefunction from a mapping holding the save_trial keys."""
    def words(k):
        return torch.as_tensor(np.asarray(z[k]).view(np.int64).copy(),
                               device=device)

    def f64(k):
        return torch.as_tensor(np.asarray(z[k], np.float64), device=device)

    def i64(k):
        return torch.as_tensor(np.asarray(z[k], np.int64), device=device)

    ham = SparseHam(n=len(z["imp_up"]), rows=i64("h_rows"), cols=i64("h_cols"),
                    vals=f64("h_vals"), diag=f64("h_diag"))
    return TrialWavefunction(
        psit_up=words("psit_up"), psit_dn=words("psit_dn"),
        psit_coef=f64("psit_coef"), e_trial=float(z["e_trial"]),
        ct_up=words("ct_up"), ct_dn=words("ct_dn"), ct_num=f64("ct_num"),
        ct_den=f64("ct_den"), imp_up=words("imp_up"), imp_dn=words("imp_dn"),
        imp_ham=ham)


def load_trial(path: str, device="cuda") -> TrialWavefunction:
    with np.load(path) as z:
        return trial_from_arrays(z, device=device)
