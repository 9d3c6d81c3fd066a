"""HCI variational determinant selection (port of the serial path of
sqmc_tpu/algo/hci.py; ref: hci.f90:66-560).

iterate { connections with |H_ij c_j| > eps_var -> union -> sparse H
(incremental) -> Davidson -> convergence }, with the reference's eps_var
schedule, min_H_already_done window (ref: hci.f90:1014,
chemistry.f90:7043) and exit criteria 1 (det-count growth < 1e-5) and 2
(energy change < 1e-5).  The det list stays sorted by the (up, dn) key.
``device_davidson`` runs Davidson on the float32 block-ELL SpMV
(ops/spmv.py, the hand CUDA kernel on the card) with a float64 Rayleigh
refinement; :func:`run_eps_series` and :func:`extrapolate_energy` give
the eps_var series and its extrapolation.

``wf_cache_dir`` / ``dump_wf_var`` read and write the variational
wavefunction cache (utils/checkpoint.py; a reference-written unformatted
cache is read through utils/refio.py).  ``active_space`` is the
reference's &active_space (frozen core and frozen virtuals filter the
candidates); ``diagonalizer="arpack"`` diagonalizes with scipy's ARPACK
on the float64 block-ELL SpMV (algo/davidson.py).

The JAX package's device driver ``run_hci_device`` (sqmc_tpu/algo/
devhci.py) folds into this function: its bucketed fixed shapes
(``_bucket``, ``_fit``) and its u64 bit tables are workarounds for XLA
recompiles and the TPU's missing 64-bit shifts, and the work it keeps on
the device (candidates, merge, sparse H, the float32 SpMV Davidson) is
already on the system's device here; ``device_davidson=True`` selects
the same dets as ``run_hci_device`` (tests/test_torch_shci.py).

``mesh`` (a parallel.dist.Mesh; every rank calls run_hci): each rank
generates the connections of its contiguous slice of the references; the
candidate union is deduplicated at each candidate's owner and gathered
(parallel.dist.owner_unique_dets); with more than one rank and
H.n >= 200 Davidson runs on parallel.dist.make_sharded_matvec.  Every
rank ends with the same dets and energies.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import dets as dets_mod
from ..ops import setalg
from ..ops.spmv import BlockEllSpmv
from ..utils import timers
from ..utils.precision import full_fp32_matmul
from ..utils.timers import phase
from .connect import generate_connections
from .davidson import arpack_diagonalize, davidson, matvec
from .sparseham import SparseHam, build_sparse_ham


@dataclasses.dataclass
class HCIResult:
    up: torch.Tensor        # [n, W] int64, sorted
    dn: torch.Tensor
    wts: np.ndarray         # [n, n_states] float64
    energies: np.ndarray    # [n_states]
    diag: np.ndarray        # [n] diagonal elements
    n_iters: int


def _active_space_mask(cu, cd, active_space, nup: int, ndn: int, norb: int):
    """Candidate filter of the variational active space: frozen core
    always occupied, frozen virtuals never (ref: hci.f90:149-191), word by
    word.  cu / cd: int64 words [m, W]; returns bool [m]."""
    n_var_e_up, n_var_e_dn, n_var_orbs = active_space
    n_core_up = nup - n_var_e_up
    n_core_dn = ndn - n_var_e_dn
    core_up = dets_mod.det_from_orbs(range(n_core_up), norb)
    core_dn = dets_mod.det_from_orbs(range(n_core_dn), norb)
    virt_up = dets_mod.det_from_orbs(
        range(min(n_core_up + n_var_orbs, norb), norb), norb)
    virt_dn = dets_mod.det_from_orbs(
        range(min(n_core_dn + n_var_orbs, norb), norb), norb)
    ok = torch.ones(len(cu), dtype=torch.bool, device=cu.device)
    for w in range(cu.shape[1]):
        cu_w, cd_w = cu[:, w], cd[:, w]
        ok &= (cu_w & int(core_up[w])) == int(core_up[w])
        ok &= (cd_w & int(core_dn[w])) == int(core_dn[w])
        ok &= (cu_w & int(virt_up[w])) == 0
        ok &= (cd_w & int(virt_dn[w])) == 0
    return ok


def _rayleigh_f64(H: SparseHam, x) -> float:
    """float64 Rayleigh quotient over the symmetric COO; refines float32
    device-Davidson eigenvalues (error O(||r||^2) for symmetric H)."""
    x = torch.as_tensor(np.asarray(x, np.float64), device=H.vals.device)
    x = x / torch.linalg.norm(x)
    return float(x @ matvec(H, x))


def extrapolate_energy(e_var, e_pt):
    """Linear extrapolation of E_tot = E_var + dE2 against dE2 -> 0 over
    an eps_var series (ref: energies_for_extrapolation, hci.f90:1824).
    Returns (e_extrapolated, slope)."""
    e_var = np.asarray(e_var, np.float64)
    e_pt = np.asarray(e_pt, np.float64)
    A = np.stack([np.ones_like(e_pt), e_pt], axis=1)
    coef, *_ = np.linalg.lstsq(A, e_var + e_pt, rcond=None)
    return float(coef[0]), float(coef[1])


def run_eps_series(system, eps_list, eps_pt: float, verbose: bool = False,
                   **hci_kwargs):
    """(E_var, dE2) over a descending eps_var series and the linear
    extrapolation to dE2 -> 0 (ref: energies_for_extrapolation,
    hci.f90:1824).  Returns dict(eps, e_var, e_pt, e_tot, e_extrapolated,
    slope)."""
    from .pt import do_pt

    eps_list = sorted(set(float(e) for e in eps_list), reverse=True)
    e_var, e_pt = [], []
    for i, eps in enumerate(eps_list):
        res = run_hci(system, eps_var=eps, eps_var_sched=eps_list[:i + 1],
                      verbose=verbose, **hci_kwargs)
        out = do_pt(system, res.up, res.dn, res.wts[:, 0], res.diag,
                    float(res.energies[0]), eps_var=eps, eps_pt=eps_pt,
                    verbose=verbose)
        e_var.append(float(res.energies[0]))
        e_pt.append(out["pt"])
        if verbose:
            print(f"eps_var={eps:.2e}  E_var={e_var[-1]:.9f} "
                  f"dE2={e_pt[-1]:.9f}", flush=True)
    e0, slope = extrapolate_energy(e_var, e_pt)
    return dict(eps=eps_list, e_var=np.asarray(e_var), e_pt=np.asarray(e_pt),
                e_tot=np.asarray(e_var) + np.asarray(e_pt),
                e_extrapolated=e0, slope=slope)


def run_hci(system, eps_var: float, eps_var_sched=None, n_states: int = 1,
            max_iters: int = 50, verbose: bool = True,
            device_davidson: bool = False, mesh=None,
            wf_cache_dir: str | None = None, active_space=None,
            diagonalizer: str = "davidson",
            dump_wf_var: bool = False) -> HCIResult:
    """Variational HCI on `system` (its tables' device does the work).

    device_davidson: for H.n >= 2000, Davidson runs on the float32
    block-ELL SpMV (tol 3e-6) and each converged eigenvalue is refined by
    a float64 Rayleigh quotient, as in sqmc_tpu's run_hci.
    diagonalizer: "davidson" or "arpack" (scipy eigsh on the float64
    block-ELL SpMV; it takes precedence over device_davidson, as in the
    JAX package).
    active_space: (n_var_e_up, n_var_e_dn, n_var_orbs) of the reference's
    &active_space: the lowest nup - n_var_e_up (ndn - n_var_e_dn) orbitals
    are frozen core and those above core + n_var_orbs frozen virtuals;
    candidates that break either are dropped (ref: hci.f90:384-412).
    wf_cache_dir: a wf_eps_var=<eps> cache found there (an .npz of either
    package, or the reference's unformatted file) with enough states is
    returned in place of the variational stage (n_iters = 0); with
    dump_wf_var the result is written there.
    mesh: parallel.dist.Mesh (see the module docstring); rank 0 alone
    prints.

    Traced (utils/timers): span "hci.run", one "hci.iteration" a pass of
    the loop (iteration 0: the HF start), each with "hci.select" (the
    candidates), "hci.ham" (the sparse H, ended by the copy of its
    diagonal to the host, a synchronize) and "hci.davidson" (ended by the
    host reading the eigenvectors; counters davidson_iters, matvecs and
    the SpMV calls' spmv_calls, spmv_rows, spmv_nnz, spmv_cols); the
    dedupe, setdiff and sort between them are the iteration's own time."""
    with timers.span("hci.run"):
        return _run_hci(system, eps_var, eps_var_sched, n_states, max_iters,
                        verbose, device_davidson, mesh, wf_cache_dir,
                        active_space, diagonalizer, dump_wf_var)


def _run_hci(system, eps_var, eps_var_sched, n_states, max_iters, verbose,
             device_davidson, mesh, wf_cache_dir, active_space, diagonalizer,
             dump_wf_var) -> HCIResult:
    if mesh is not None:
        from ..parallel.dist import check_mesh, make_sharded_matvec, \
            owner_unique_dets
        check_mesh(mesh)
        verbose = verbose and mesh.rank == 0
    if diagonalizer not in ("davidson", "arpack"):
        raise ValueError(f"unknown diagonalizer {diagonalizer!r}")
    full_fp32_matmul()
    nup, ndn, norb = system.nup, system.ndn, system.norb
    dev = system.device
    ts = dict(time_sym=system.time_sym, z=system.z)

    cache_name = None
    if wf_cache_dir is not None:
        from ..utils.checkpoint import load_wf_var, wf_var_filename
        cache_name = wf_var_filename(min(eps_var_sched or [eps_var]),
                                     wf_cache_dir)
        cached = load_wf_var(cache_name)
        if cached is None and os.path.exists(cache_name):
            # a reference-written unformatted cache: read it, sort it and
            # compute the diagonal here
            from ..utils.refio import read_wf_eps_var
            u_r, d_r, w_r, e_r = read_wf_eps_var(cache_name, norb)
            u_r = torch.as_tensor(u_r, device=dev)
            d_r = torch.as_tensor(d_r, device=dev)
            order = setalg.lexsort_dets(u_r, d_r)
            H_r = build_sparse_ham(system.table, u_r[order], d_r[order], nup,
                                   ndn, norb, **ts)
            cached = dict(up=u_r[order], dn=d_r[order],
                          wts=w_r[order.cpu().numpy()], energies=e_r,
                          diag=H_r.diag.cpu().numpy())
        if cached is not None and cached["wts"].shape[1] >= n_states:
            if verbose:
                print(f"Reading variational wavefn from {cache_name}",
                      flush=True)
            return HCIResult(
                up=torch.as_tensor(cached["up"], device=dev),
                dn=torch.as_tensor(cached["dn"], device=dev),
                wts=np.asarray(cached["wts"][:, :n_states], np.float64),
                energies=np.asarray(cached["energies"][:n_states]),
                diag=np.asarray(cached["diag"], np.float64), n_iters=0)

    with timers.span("hci.iteration"):
        up = torch.as_tensor(system.hf_up[None, :], device=dev)
        dn = torch.as_tensor(system.hf_dn[None, :], device=dev)
        wts = np.zeros((1, n_states))
        wts[0, 0] = 1.0
        min_H_done = np.full(1, 1e99)
        with timers.span("hci.ham"):
            H = build_sparse_ham(system.table, up, dn, nup, ndn, norb, **ts)
            energies = np.full(n_states, float(H.diag[0]))
    if verbose:
        print(f"Iteration   0 eps1={eps_var:8.1e} ndets={1:9d} energy="
              + " ".join(f"{e:16.9f}" for e in energies), flush=True)
    if eps_var_sched is None:
        eps_var_sched = [eps_var]
    final_eps = eps_var

    n_iter_done = 0
    for it in range(1, max_iters + 1):
        with timers.span("hci.iteration"):
            eps = (eps_var_sched[it - 1] if it <= len(eps_var_sched)
                   else final_eps)
            n_old = len(up)
            coeffs = (np.max(np.abs(wts), axis=1) if it > 1
                      else wts[:, 0].copy())
            coeffs = np.where(coeffs == 0.0, 1e-300, np.abs(coeffs))

            gen_mask = coeffs * min_H_done > eps
            eps_per_ref = eps / coeffs
            with phase("get_next_det_list", enabled=verbose,
                       name="hci.select"):
                if gen_mask.any():
                    gm = torch.as_tensor(gen_mask, device=dev)
                    cu, cd, _, _ = generate_connections(
                        system, up[gm], dn[gm],
                        torch.as_tensor(eps_per_ref[gen_mask], device=dev),
                        torch.as_tensor(min_H_done[gen_mask], device=dev),
                        mesh=mesh)
                else:
                    cu = up[:0]
                    cd = dn[:0]
            min_H_done = np.minimum(min_H_done, eps_per_ref)

            if mesh is not None:
                # the union of the ranks' candidates, unique, on every rank
                cu, cd = owner_unique_dets(mesh, cu, cd)
            elif len(cu):
                cu, cd, _, _ = setalg.unique_dets(cu, cd)
            if len(cu):
                new_mask = setalg.setdiff_dets(cu, cd, up, dn)
                cu, cd = cu[new_mask], cd[new_mask]
            if len(cu) and active_space is not None:
                keep = _active_space_mask(cu, cd, active_space, nup, ndn,
                                          norb)
                cu, cd = cu[keep], cd[keep]
            n_total = n_old + len(cu)

            if n_total == n_old:
                if verbose:
                    print("Cycling hci iteration because no new dets",
                          flush=True)
                if it >= len(eps_var_sched) or eps == eps_var_sched[-1]:
                    break
                continue
            if n_total <= int(1.00001 * n_old) and eps == eps_var_sched[-1]:
                if verbose:
                    print("Exiting variational part because of number of new "
                          "dets criterion", flush=True)
                break

            up2 = torch.cat([up, cu])
            dn2 = torch.cat([dn, cd])
            order = setalg.lexsort_dets(up2, dn2)
            up2, dn2 = up2[order], dn2[order]
            prev_pos = torch.nonzero(order < n_old).reshape(-1)
            prev_map = torch.empty(n_old, dtype=torch.int64, device=dev)
            prev_map[order[prev_pos]] = prev_pos
            pm = prev_map.cpu().numpy()
            wts2 = np.zeros((n_total, n_states))
            wts2[pm] = wts
            mhd2 = np.full(n_total, 1e99)
            mhd2[pm] = min_H_done

            with phase("generate_sparse_ham", enabled=verbose,
                       name="hci.ham"):
                H = build_sparse_ham(system.table, up2, dn2, nup, ndn, norb,
                                     prev=H, prev_map=prev_map, **ts)
                diag_np = H.diag.cpu().numpy()
            X0 = wts2.copy()
            for s in range(n_states):
                if np.linalg.norm(X0[:, s]) < 1e-12:
                    X0[np.argsort(diag_np)[s], s] = 1.0
            with phase("davidson", enabled=verbose, name="hci.davidson"):
                if diagonalizer == "arpack":
                    evals, evecs = arpack_diagonalize(H, n_states, initial=X0)
                elif (device_davidson and H.n >= 2000
                      and (mesh is None or mesh.size == 1)):
                    # the whole matrix on one card: the float32 block-ELL SpMV
                    evals, evecs = davidson(H, n_states, initial=X0, tol=3e-6,
                                            matvec_fn=BlockEllSpmv(H))
                    evals = np.array([_rayleigh_f64(H, evecs[:, s])
                                      for s in range(n_states)])
                elif mesh is not None and H.n >= 200:
                    evals, evecs = davidson(
                        H, n_states, initial=X0, tol=1e-10,
                        matvec_fn=make_sharded_matvec(H, mesh))
                else:
                    evals, evecs = davidson(H, n_states, initial=X0, tol=1e-10)

            up, dn, wts, min_H_done = up2, dn2, evecs, mhd2
            old_energies = energies
            energies = evals
            n_iter_done = it
            if verbose:
                print(f"Iteration{it:4d} eps1={eps:8.1e} ndets={n_total:9d} "
                      "energy=" + " ".join(f"{e:16.9f}" for e in energies),
                      flush=True)
            if (np.max(np.abs(energies - old_energies)) < 1e-5
                    and eps == eps_var_sched[-1]):
                if verbose:
                    print("Exiting variational part because of energy "
                          "criterion", flush=True)
                break

    if verbose:
        print(f"Final Iteration{n_iter_done:4d} {len(up):9d} dets, energy="
              + " ".join(f"{e:16.9f}" for e in energies), flush=True)
        print("Variational energy=" + f"{energies[0]:26.9f}".rjust(15),
              flush=True)
    diag = H.diag.cpu().numpy()
    if dump_wf_var and cache_name is not None:
        from ..utils.checkpoint import save_wf_var
        # every rank holds the same wavefunction: one writer
        if mesh is None or mesh.rank == 0:
            save_wf_var(cache_name, up, dn, wts, energies, diag)
        if mesh is not None:
            mesh.barrier()
        if verbose:
            print(f"Writing variational wavefn to {cache_name}", flush=True)
    return HCIResult(up=up, dn=dn, wts=wts, energies=np.asarray(energies),
                     diag=diag, n_iters=n_iter_done)
