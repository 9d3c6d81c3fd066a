"""Trial wavefunction, deterministic space and C(T) (port of
sqmc_tpu/algo/semistoch.py; ref: semistoch.f90 generate_space_iterate:145,
generate_psi_t_connected_e_loc:27).

  * Psi_T   = top n_psi_t dets of an HCI wavefunction by |coef|, or of the
    reference's iterated construction from the deck's trial_wf cards
    (:func:`build_trial_from_cards`, :func:`build_trial_iterate`)
  * D space = top n_imp dets of the same wavefunction, with its sparse H
  * C(T)    = all dets connected to Psi_T, with e_loc_num(j) = sum_i H_ji c_i
    and e_loc_den(j) = c_j

Every H is built in the system's basis (time-symmetrized when it is).
:func:`load_trial_from_reference` builds the same object from the
reference's restart files (utils/refio.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dets import host_u64 as _u64
from ..ops import setalg
from ..utils import timers
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


def _ham(system, up, dn, **kw) -> SparseHam:
    """Sparse H over a det list in the system's basis."""
    return build_sparse_ham(system.table, up, dn, system.nup, system.ndn,
                            system.norb, time_sym=system.time_sym,
                            z=system.z, **kw)


def _assemble_trial(system, up, dn, wts, n_psi_t: int, imp_up,
                    imp_dn) -> TrialWavefunction:
    """Pick Psi_T, build its C(T) local-energy cache and the D-space H."""
    pu, pd, pc = _top_by_coef(up, dn, wts, n_psi_t)
    pc = pc / torch.linalg.norm(pc)
    Hp = _ham(system, pu, pd)
    pc_np = pc.cpu().numpy()
    e_trial = float(pc_np @ Hp.dense().cpu().numpy() @ pc_np)
    imp_ham = _ham(system, imp_up, imp_dn)

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
    """Psi_T + D + C(T) for the walk, from one HCI run (traced: span
    "trial.build", which ends with device work possibly still queued)."""
    with timers.span("trial.build"):
        res = run_hci(system, eps_var=eps_var, eps_var_sched=[eps_var] * 10,
                      verbose=verbose)
        wts = torch.as_tensor(res.wts[:, 0], device=res.up.device)
        iu, idn, _ = _top_by_coef(res.up, res.dn, wts, n_imp)
        return _assemble_trial(system, res.up, res.dn, wts, n_psi_t, iu,
                               idn)


def generate_space_iterate(system, n_iters: int, n_initiators, n_truncate,
                           norb_active=None, verbose: bool = False):
    """Iterated deterministic-space / trial-wavefunction construction
    (ref: semistoch.f90 generate_space_iterate:145).  Starting from the
    HF det, each iteration
      1. expands by every connection of the top-|c| n_initiators[it]
         dets, restricted to the lowest norb_active[it] orbitals,
      2. keeps the top max(10 n_truncate[it], 100) new candidates by the
         first-order coefficient |sum_i H_ai c_i| / (H_aa - E),
      3. diagonalizes the expanded space,
      4. truncates to the n_truncate[it] largest |c|;
    the truncated space is rediagonalized at the end.  Per-iteration
    lists are indexed by iteration (the last entry repeats).  Returns
    (up, dn, coefs, energy) with coefs a float64 tensor."""
    from .davidson import davidson
    from .. import dets as dets_mod
    from .sparseham import diag_elements_batched

    def per_it(x, it):
        if x is None or np.isscalar(x):
            return x
        return x[min(it, len(x) - 1)]

    dev = system.device
    up = torch.as_tensor(system.hf_up[None, :], device=dev)
    dn = torch.as_tensor(system.hf_dn[None, :], device=dev)
    wts = torch.ones(1, dtype=torch.float64, device=dev)
    H = _ham(system, up, dn)
    energy = float(H.diag[0])

    def evec(vecs):
        return torch.as_tensor(vecs[:, 0], dtype=torch.float64, device=dev)

    for it in range(n_iters):
        n_init = int(per_it(n_initiators, it))
        n_trunc = int(per_it(n_truncate, it))
        norb_a = per_it(norb_active, it)
        iu, idn, ic = _top_by_coef(up, dn, wts, n_init)
        coeffs = torch.where(ic.abs() == 0.0, 1e-300, ic.abs())
        cu, cd, h, ref = generate_connections(system, iu, idn, 1e-300 / coeffs)
        if norb_a is not None and int(norb_a) < system.norb:
            mask = torch.as_tensor(dets_mod.det_from_orbs(
                range(int(norb_a), system.norb), system.norb), device=dev)
            ok = (((cu & mask) == 0) & ((cd & mask) == 0)).all(dim=1)
            cu, cd, h, ref = cu[ok], cd[ok], h[ok], ref[ok]
        cu_u, cd_u, (num_u,), _ = setalg.unique_dets(cu, cd, [h * ic[ref]])
        new = setalg.setdiff_dets(cu_u, cd_u, up, dn)
        cu_u, cd_u, num_u = cu_u[new], cd_u[new], num_u[new]
        if len(cu_u):
            # the screen uses the plain det diagonal, as the JAX package does
            dg = diag_elements_batched(system.table, cu_u, cd_u, system.norb)
            pt_c = num_u.abs() / (dg - energy).clamp(min=1e-10)
            keep_n = min(len(cu_u), max(10 * n_trunc, 100))
            top = torch.argsort(-pt_c, stable=True)[:keep_n]
            cu_u, cd_u = cu_u[top], cd_u[top]
        up2, dn2 = torch.cat([up, cu_u]), torch.cat([dn, cd_u])
        order = setalg.lexsort_dets(up2, dn2)
        up2, dn2 = up2[order], dn2[order]
        evals, evecs = davidson(_ham(system, up2, dn2), 1)
        energy = float(evals[0])
        up, dn, wts = _top_by_coef(up2, dn2, evec(evecs), n_trunc)
        if verbose:
            print(f"space_iterate {it + 1}: expanded={len(up2)} "
                  f"kept={len(up)} E={energy:.8f}", flush=True)

    evals, evecs = davidson(_ham(system, up, dn), 1)
    return up, dn, evec(evecs), float(evals[0])


def build_trial_iterate(system, n_iters: int, n_initiators, n_truncate,
                        norb_active=None, n_psi_t: int = 200,
                        verbose: bool = False) -> TrialWavefunction:
    """TrialWavefunction from the iterated construction (the
    diff_from_psi_t cards; ref do_walk.f90:954-960): the final space is D
    and Psi_T is its top-|c| slice."""
    up, dn, coefs, _ = generate_space_iterate(
        system, n_iters, n_initiators, n_truncate, norb_active,
        verbose=verbose)
    return _assemble_trial(system, up, dn, coefs, n_psi_t, up, dn)


def build_trial_from_cards(system, trial_wf_iters: int, norb_trial_wf,
                           n_initiators_trial_wf, n_truncate_trial_wf,
                           size_deterministic: int,
                           verbose: bool = False) -> TrialWavefunction:
    """Psi_T and D for a walk-mode card deck, as the reference builds them
    (Psi_T by generate_space_iterate with the trial_wf cards,
    hamiltonian_mod.f90:113-115; D = the top size_deterministic dets of
    the same final expansion, semistoch.f90:263,403-420).  The last
    iteration keeps at least size_deterministic dets; trial_wf_iters == 0
    leaves Psi_T = HF.  Traced: span "trial.build", as
    build_trial_wavefunction's."""
    with timers.span("trial.build"):
        return _trial_from_cards(system, trial_wf_iters, norb_trial_wf,
                                 n_initiators_trial_wf, n_truncate_trial_wf,
                                 size_deterministic, verbose)


def _trial_from_cards(system, trial_wf_iters, norb_trial_wf,
                      n_initiators_trial_wf, n_truncate_trial_wf,
                      size_deterministic, verbose) -> TrialWavefunction:
    size_det = max(int(size_deterministic), 1)
    n_psi_t = int(n_truncate_trial_wf[-1]) if trial_wf_iters > 0 else 1
    n_trunc = [int(x) for x in n_truncate_trial_wf]
    if n_trunc:
        n_trunc[-1] = max(n_trunc[-1], size_det)
    up, dn, coefs, _ = generate_space_iterate(
        system, max(trial_wf_iters, 0), list(n_initiators_trial_wf) or [1],
        n_trunc or [1], norb_active=list(norb_trial_wf) or None,
        verbose=verbose)
    iu, idn, _ = _top_by_coef(up, dn, coefs, size_det)
    return _assemble_trial(system, up, dn, coefs, n_psi_t, iu, idn)


def load_trial_from_reference(system, psit_con_file: str,
                              dtm_file: str | None = None,
                              n_imp: int = 1) -> TrialWavefunction:
    """TrialWavefunction on the system's device from reference-written
    restart artifacts (interop, SURVEY 5.4): psit_connections supplies
    Psi_T and the C(T) local-energy cache (ref do_walk.f90:687-878),
    dtm_projector supplies the deterministic space + its Hamiltonian (ref
    :887-1012).  Without a dtm file, the top-|c| n_imp Psi_T dets form the
    space and H is built here."""
    from ..utils.refio import read_dtm_projector, read_psit_connections

    dev = system.device

    def on(x):
        return torch.as_tensor(x, device=dev)

    d = read_psit_connections(psit_con_file, system.nup, system.ndn,
                              system.norb)
    cu, cd = on(d["ct_up"]), on(d["ct_dn"])
    order = setalg.lexsort_dets(cu, cd)
    cu, cd = cu[order], cd[order]
    num, den = on(d["ct_num"])[order], on(d["ct_den"])[order]
    pu, pd_ = on(d["psit_up"]), on(d["psit_dn"])
    po = setalg.lexsort_dets(pu, pd_)
    pu, pd_, pc = pu[po], pd_[po], on(d["psit_coef"])[po]

    if dtm_file is not None:
        iu, idn, imp_ham = read_dtm_projector(dtm_file, system.nup,
                                              system.ndn, system.norb,
                                              device=dev)
        iu, idn = on(iu), on(idn)
        io = setalg.lexsort_dets(iu, idn)
        # re-sort the COO to the sorted det order (restore rows < cols)
        inv = torch.empty_like(io)
        inv[io] = torch.arange(len(io), device=dev)
        r2, c2 = inv[imp_ham.rows], inv[imp_ham.cols]
        rows, cols = torch.minimum(r2, c2), torch.maximum(r2, c2)
        so = torch.argsort(rows * imp_ham.n + cols, stable=True)
        imp_ham = SparseHam(n=imp_ham.n, rows=rows[so], cols=cols[so],
                            vals=imp_ham.vals[so], diag=imp_ham.diag[io])
        iu, idn = iu[io], idn[io]
    else:
        iu, idn, _ = _top_by_coef(pu, pd_, pc, n_imp)
        imp_ham = _ham(system, iu, idn)

    e_trial = d["e_trial"]
    if not np.isfinite(e_trial):
        e_trial = float(num[0] / den[0]) if float(den[0]) else 0.0
    return TrialWavefunction(psit_up=pu, psit_dn=pd_,
                             psit_coef=pc / torch.linalg.norm(pc),
                             e_trial=float(e_trial), ct_up=cu, ct_dn=cd,
                             ct_num=num, ct_den=den, imp_up=iu, imp_dn=idn,
                             imp_ham=imp_ham)


def ensure_psit_in_imp(system, trial: TrialWavefunction,
                       verbose: bool = False) -> TrialWavefunction:
    """Force Psi_T into the deterministic space D (the semantics of the
    reference's hf_to_psit card, do_walk.f90:2281-2296: walkers on Psi_T
    dets propagate to their connections exactly, which the D-space
    projection does once Psi_T is a subset of D).  Returns the trial
    itself when nothing is missing."""
    pos = setalg.search_dets(trial.imp_up, trial.imp_dn, trial.psit_up,
                             trial.psit_dn)
    missing = pos < 0
    if not bool(missing.any()):
        return trial
    iu, idn, _, _ = setalg.unique_dets(
        torch.cat([trial.imp_up, trial.psit_up[missing]]),
        torch.cat([trial.imp_dn, trial.psit_dn[missing]]))
    if verbose:
        print(f"hf_to_psit: forcing Psi_T into the deterministic space "
              f"({int(missing.sum())} Psi_T dets added, n_imp "
              f"{len(trial.imp_up)} -> {len(iu)}); the exact D-space "
              "projection subsumes the reference's Psi_T-column move "
              "(do_walk.f90:2281-2296)")
    return dataclasses.replace(trial, imp_up=iu, imp_dn=idn,
                               imp_ham=_ham(system, iu, idn))


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
