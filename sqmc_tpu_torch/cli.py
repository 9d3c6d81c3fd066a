"""Command-line entry point: ``python -m sqmc_tpu_torch -i input [-f FCIDUMP]
[--cpu] [--profile DIR]`` (port of sqmc_tpu/cli.py).

Runs reference card-format inputs unchanged (ref: sqmc_main.f90) and
prints the grep-able result lines of the JAX package's CLI, digit format
included ("Variational energy=", "Second-order PT energy lowering=",
"Total energy=", "Total energy (includ. Madelung)=", "e_mixed=... +-...").
The work runs on the card; ``--cpu`` runs it on the CPU instead.

Determinant systems: hamiltonian_type ``chem`` (FCIDUMP, &hf_det, point
groups, hf_symmetry, time-reversal symmetry), ``heg``, ``hubbardk``
(momentum space) and ``hubbard2`` (real space), with run_type ``hci`` (HCI
+ PT per state; ``dump_wf_var`` and the ``wf_eps_var=...`` cache in the
working directory), ``vmc`` on ``hubbard2`` (Gutzwiller VMC) or a walk:
the plain projector (``none`` and every name outside the fixed-node
family), ``fixed_node1``-``4``, ``partial_node``, ``release_node`` and
``sr`` with a Gutzwiller guiding function (also under
``importance_sampling``), the three proposal methods and the exponential
projector.  Psi_T and D come from the deck's trial_wf or diff_from_psi_t
cards, hf_to_psit, tau from tau_multiplier, MWALK and spawn capacity sized
from the population.  The dense toy types ``fictitious``, ``read`` and
``hubbard`` run through the dense-vector walk engine (:func:`run_toy`)
with every run type of algo/densewalk.py.  The legacy CI run types
``selected_ci`` and ``trunc_lanc`` (algo/legacy_ci.py) and, after an HCI,
&natorb (the natural-orbital FCIDUMP.natorb, with or without the PT
correction to the 1-RDM), &greens_function and &active_space run as in
the JAX package.  ``hubbarddm`` has no card path in either package (its
API is systems/hubbard/dmbasis.py).  The last line is the kernels'
launch counts (``Kernel launches: seg_scan=... spmv=... hb_select=...
hb_spawn=... slot_parents=... seq_init=...``); a walk prints, before it, its last
block's device time a generation by piece (``Generation pieces ...``,
algo/walk.py block_report).  ``--profile DIR`` writes a torch.profiler
Chrome trace in which the program's spans (utils/timers: walk.block,
hci.iteration, pt.run, ...) and the walk's device marks (``sqmc_mark<k>``
kernels) name the rows.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .config import parse_input
from .utils.timers import my_second

_TOY_TYPES = ("fictitious", "read", "hubbard")

_FIXED_NODE = ("fixed_node1", "fixed_node2", "fixed_node3", "fixed_node4",
               "partial_node", "release_node", "sr")


def check_ported(cfg):
    """Raise ValueError for every card this port does not run."""
    ht = cfg.hamiltonian_type
    if ht in _TOY_TYPES:
        return            # the dense engine takes every run type it knows
    if ht == "hubbarddm":
        raise ValueError(
            "hamiltonian_type 'hubbarddm' has no card-input path (the "
            "sqmc_tpu CLI has none either); build the density-matrix basis "
            "with sqmc_tpu_torch.systems.hubbard.dmbasis."
            "make_hubbarddm_dense and drive it with run_dense_walk")
    if ht not in ("chem", "heg", "hubbardk", "hubbard2"):
        raise ValueError(f"unknown hamiltonian_type {ht!r}")


def _seed4(seed: int):
    """Split an integer seed into rannyu's 4x12-bit state."""
    return ((seed >> 36) & 0xFFF, (seed >> 24) & 0xFFF,
            (seed >> 12) & 0xFFF, seed & 0xFFF)


def run_toy(cfg, verbose: bool = True, device="cuda"):
    """Toy dense-matrix path: `fictitious`, `read`, and dense `hubbard`
    (ref: hamiltonian_mod.f90:81-92,273-344,393-410) driven through the
    dense-vector walk engine on `device` with the requested run_type."""
    from .algo.densewalk import DenseWalkConfig, run_dense_walk
    from .systems.toy import (make_fictitious_system, make_read_system,
                              toy_psi_t)

    if cfg.hamiltonian_type == "fictitious":
        print(f"bosonic, spectrum_coef, spectrum_power, ham_diag_fluc, "
              f"ham_offdiag_fluc ={cfg.bosonic:2d}{cfg.spectrum_coef:8.3f}"
              f"{cfg.spectrum_power:8.3f}{cfg.ham_diag_fluc:8.3f}"
              f"{cfg.ham_offdiag_fluc:8.3f}")
        my_second("BEG", "fictitious matrix")
        system = make_fictitious_system(
            cfg.ndet_toy, cfg.bosonic, cfg.spectrum_coef, cfg.spectrum_power,
            cfg.ham_diag_fluc, cfg.ham_offdiag_fluc,
            seed=_seed4(cfg.seeds[0]), device=device)
        my_second("END", "fictitious matrix")
    elif cfg.hamiltonian_type == "read":
        system = make_read_system("hamiltonian", device=device)
    else:  # dense hubbard toy
        from .systems.hubbard.system import make_hubbard_dense_system
        system = make_hubbard_dense_system(cfg.l_x, cfg.l_y, cfg.t_hub,
                                           cfg.u_hub, cfg.nup,
                                           cfg.nelec - cfg.nup, pbc=cfg.pbc,
                                           device=device)
    ndet = system.ndet
    print(f"ndet={ndet:15d}")

    e_trial = cfg.e_trial_initial
    if cfg.diagonalize_ham:
        my_second("BEG", "diagonalize")
        # the spectrum line has ndet entries: printed for small systems only
        w, _ = system.diagonalize(verbose=verbose and ndet <= 1000)
        my_second("END", "diagonalize")
        print(f"Setting e_trial (from diagonalizing Hamiltonian) ="
              f"{float(w[0]):10.5f}")
        print(f"energy_exact={float(w[0]):10.5f}")
        e_trial = float(w[0])

    if cfg.ndet_psi_t > 0:
        psi_t, psi_g = toy_psi_t(ndet, cfg.iwdet_psi_t, cfg.cdet_psi_t)
    else:
        psi_t = np.zeros(ndet)
        psi_t[0] = 1.0
        psi_g = np.full(ndet, 1.0 / np.sqrt(ndet))

    tau = cfg.tau
    if tau == 0.0:
        _, _, tau = system.tau_optimal(cfg.tau_multiplier)
        print(f"tau_multiplier, tau={cfg.tau_multiplier:10.6f}{tau:10.6f}")

    run_type = "none" if cfg.run_type in ("no_fixed_node",) else cfg.run_type
    wcfg = DenseWalkConfig(
        ndet=ndet, tau=tau, w_abs_target=cfg.w_abs_target,
        run_type=run_type, importance_sampling=cfg.importance_sampling,
        partial_node_eps=cfg.partial_node_eps,
        release_step=cfg.nstep * cfg.nblk_eq // 2 or 1,
        min_wt=cfg.min_wt, pop_ctrl_exponent=cfg.population_control_exponent,
        reweight_factor_inv_max=cfg.reweight_factor_inv_max)
    my_second("BEG", "walk")
    out = run_dense_walk(system, wcfg, psi_t, psi_g, nstep=cfg.nstep,
                         nblk=cfg.nblk, nblk_eq=cfg.nblk_eq,
                         w_abs_begin=cfg.w_abs_begin,
                         e_trial_initial=e_trial if e_trial else None,
                         seed=cfg.seeds[0], verbose=verbose)
    my_second("END", "walk")
    if verbose and out.t_measured:
        ms = "" if out.device_ms_per_gen is None else \
            f" device_ms_per_gen={out.device_ms_per_gen:.4f}"
        print(f"dense walk: measured_gens={out.n_measured} "
              f"gen_per_s={out.n_measured / out.t_measured:.3f}{ms} "
              f"w_abs={float(out.state.w_abs_gen):.1f}")
    print(f"e_mixed={out.e_mixed:26.9f} +-{out.e_err:.9f}")
    if system.energy_exact is not None:
        print(f"error vs exact={out.e_mixed - system.energy_exact:14.9f}")
    return out


def make_system(cfg, fcidump: str | None, device):
    """The deck's FermionSystem on `device`."""
    if cfg.hamiltonian_type == "chem":
        from .systems.base import make_chem_system
        return make_chem_system(
            fcidump or "FCIDUMP", nup=cfg.nup or None,
            ndn=(cfg.nelec - cfg.nup) if cfg.nelec else None,
            time_sym=cfg.time_sym, z=cfg.z, point_group=cfg.point_group,
            hf_symmetry=cfg.hf_symmetry, hf_up_occ_in=cfg.hf_up_occ,
            hf_dn_occ_in=cfg.hf_dn_occ, device=device)
    if cfg.hamiltonian_type == "hubbardk":
        from .systems.hubbard.system import make_hubbard_k_system
        return make_hubbard_k_system(cfg.l_x, cfg.l_y, cfg.t_hub, cfg.u_hub,
                                     cfg.nup, cfg.nelec - cfg.nup,
                                     device=device)
    if cfg.hamiltonian_type == "hubbard2":
        from .systems.hubbard.system import make_hubbard_real_system
        return make_hubbard_real_system(cfg.l_x, cfg.l_y, cfg.t_hub,
                                        cfg.u_hub, cfg.nup,
                                        cfg.nelec - cfg.nup, pbc=cfg.pbc,
                                        device=device)
    from .systems.heg.system import make_heg_system
    system = make_heg_system(cfg.n_dim, cfg.r_s, cfg.nelec, cfg.nup,
                             cfg.cutoff_radius, device=device)
    print(f"For this cell, HF kinetic, exchange, total energies = "
          f"{system.extra['energy_hf']:.8f}")
    if system.extra["madelung_implemented"]:
        print(f"Madelung energy ={system.extra['energy_madelung']:10.6f}")
    else:
        print("Madelung energy not implemented for 2D "
              "(ref heg.f90:2845); totals exclude it")
    return system


def deduce_tau(cfg, system):
    """tau = tau_multiplier / (diag_hi - diag_lo) (ref:
    chemistry.f90:447-454): the lowest diagonal from the starting det, the
    highest from the det occupying the top orbitals.  Returns (tau,
    [diag_lo, diag_hi])."""
    import torch
    from . import dets as dets_mod
    from .systems.chem import slater
    norb = system.norb
    pair_u = np.stack([system.hf_up, dets_mod.det_from_orbs(
        range(norb - system.nup, norb), norb)])
    pair_d = np.stack([system.hf_dn, dets_mod.det_from_orbs(
        range(norb - system.ndn, norb), norb)])
    dev = system.device
    dg = slater.diag_elements(
        system.table,
        dets_mod.to_bits(torch.as_tensor(pair_u, device=dev), norb),
        dets_mod.to_bits(torch.as_tensor(pair_d, device=dev), norb)
    ).cpu().numpy()
    return cfg.tau_multiplier / (dg[1] - dg[0]), dg


def run_det_walk(cfg, system, verbose: bool = True):
    """SQMC walk on a determinant system driven from card input (ref:
    do_walk.f90 walk:1462), in float64 state as the JAX package's CLI
    runs it, including the fixed-node run types with Gutzwiller guiding
    (ref dispatch do_walk.f90:38-50; hubbard.f90 wf_type 'gutz':244-253)."""
    from .algo.semistoch import build_trial_wavefunction
    from .algo.walk import WalkConfig, run_walk

    run_type = cfg.run_type if cfg.run_type in _FIXED_NODE else "none"
    guide = None
    guiding = "none"
    if run_type != "none" or cfg.importance_sampling:
        from .algo.guiding import make_gutzwiller_guiding
        g = cfg.gutz_g if cfg.wf_type.startswith(("gutz", "cgutz")) else 1.0
        guide = make_gutzwiller_guiding(system, g=g)
        guiding = "gutzwiller"
        if verbose and cfg.wf_type:
            print(f"trial_wf_type={cfg.wf_type}")
            print(f"g={g:8.3f}")

    if cfg.diff_from_psi_t and cfg.imp_iters > 0:
        from .algo.semistoch import build_trial_iterate
        trial = build_trial_iterate(
            system, cfg.imp_iters, cfg.n_imp_init, cfg.n_imp_trunc,
            norb_active=cfg.norb_imp or None,
            n_psi_t=max(cfg.n_truncate_det or 200, 1), verbose=verbose)
    elif cfg.trial_wf_iters >= 0:
        from .algo.semistoch import build_trial_from_cards
        if verbose:
            print(f"trial_wf_iters, norb_trial_wf, n_initiators_trial_wf, "
                  f"n_truncate_trial_wf: {cfg.trial_wf_iters} "
                  f"{cfg.norb_trial_wf} {cfg.n_initiators_trial_wf} "
                  f"{cfg.n_truncate_trial_wf}")
        trial = build_trial_from_cards(
            system, cfg.trial_wf_iters, cfg.norb_trial_wf,
            cfg.n_initiators_trial_wf, cfg.n_truncate_trial_wf,
            cfg.size_deterministic or 1, verbose=verbose)
    else:
        eps_fallback = cfg.eps_var if cfg.eps_var < 1 else 2e-3
        if verbose:
            print(f"WARNING: no trial_wf cards in deck; building Psi_T "
                  f"from HCI eps_var={eps_fallback:g} "
                  f"(n_psi_t={max(cfg.n_truncate_det or 200, 1)}, "
                  f"n_imp={cfg.size_deterministic or 1000}) - not a "
                  "reference-card construction")
        trial = build_trial_wavefunction(
            system, eps_var=eps_fallback,
            n_psi_t=max(cfg.n_truncate_det or 200, 1),
            n_imp=cfg.size_deterministic or 1000, verbose=verbose)

    if cfg.hf_to_psit:
        from .algo.semistoch import ensure_psit_in_imp
        trial = ensure_psit_in_imp(system, trial, verbose=verbose)

    tau = cfg.tau
    if tau == 0.0:
        tau, dg = deduce_tau(cfg, system)
        if verbose:
            print(f"diagonal_ham_lowest, diagonal_ham_highest, "
                  f"tau_multiplier, tau={dg[0]:13.6f}{dg[1]:13.6f}"
                  f"{cfg.tau_multiplier:10.6f}{tau:10.6f}")

    proposal = {"uniform": "uniform", "uniform2": "uniform",
                "CauchySchwarz": "cauchy_schwarz"}.get(
                    cfg.proposal_method, "fast_heatbath")
    if verbose and cfg.proposal_method.startswith("heat_bath"):
        print(f"proposal_method {cfg.proposal_method} -> fast_heatbath "
              "(exact joint-|H| heat bath)")

    # MWALK auto-size (ref do_walk.f90:652-674): ~w_abs_target/min_wt
    # occupied dets at equilibrium plus the resident D space
    if cfg.mwalk:
        mwalk = cfg.mwalk
    elif cfg.semistochastic:
        mwalk = int(3.5 * (cfg.w_abs_target / cfg.min_wt
                           + len(trial.imp_up)))
        if verbose:
            print(f"1Setting MWALK=3.5*(w_abs_gen_target/min_wt+n_imp)="
                  f"{mwalk:10d}")
    else:
        mwalk = int(4 * cfg.w_abs_target / cfg.min_wt)
        if verbose:
            print(f"2Setting MWALK=4*(w_abs_gen_target/min_wt)={mwalk:10d}")
    mwalk = max(mwalk, 4096)
    cap_spawn = max(int(3 * cfg.w_abs_target), 4 * 4096)
    wcfg = WalkConfig(
        mwalk=mwalk, cap_spawn=cap_spawn, norb=system.norb, nup=system.nup,
        ndn=system.ndn, n_words=system.n_words, tau=tau or 2e-3,
        w_abs_target=cfg.w_abs_target, r_initiator=cfg.r_initiator,
        initiator_power=cfg.initiator_power, min_wt=cfg.min_wt,
        always_spawn_cutoff=cfg.always_spawn_cutoff,
        pop_ctrl_exponent=cfg.population_control_exponent,
        reweight_factor_inv_max=cfg.reweight_factor_inv_max,
        has_singles=system.has_singles, c_t_initiator=cfg.c_t_initiator,
        run_type=run_type, partial_node_eps=cfg.partial_node_eps,
        release_step=cfg.nstep * cfg.nblk_eq // 2 or 1,
        guiding=guiding, time_sym=system.time_sym, z=system.z,
        proposal=proposal,
        use_exponential_projector=cfg.use_exponential_projector,
        # the reference skips the deterministic projection in exponential
        # mode (do_walk.f90:2255)
        semistochastic=cfg.semistochastic
        and not cfg.use_exponential_projector)
    out = run_walk(system, trial, wcfg, nstep=cfg.nstep, nblk=cfg.nblk,
                   nblk_eq=cfg.nblk_eq, w_abs_begin=cfg.w_abs_begin,
                   e_trial_initial=cfg.e_trial_initial or trial.e_trial,
                   seed=cfg.seeds[0], verbose=verbose, guide=guide)
    if verbose:
        print(f"walk: measured_gens={out.n_measured} "
              f"gen_per_s={out.steps_per_sec:.3f} "
              f"capacity_grows={out.capacity_grows}")
    print(f"e_mixed={out.e_mixed:26.9f} +-{out.e_err:.9f}")
    return out


def run_legacy_ci(cfg, system, verbose: bool = True):
    """run_type selected_ci or trunc_lanc (ref: hamiltonian_mod.f90:158-185):
    iterations from nblk_eq, initiators and truncation from
    n_truncate_det, as in the JAX package's CLI."""
    from .algo.legacy_ci import perform_selected_ci, perform_truncated_lanczos
    n_trunc = cfg.n_truncate_det or 1000
    if cfg.run_type == "selected_ci":
        my_second("BEG", "generate deterministically selected subspace")
        res = perform_selected_ci(system, iters=cfg.nblk_eq or 4,
                                  n_initiators=n_trunc, n_truncate=n_trunc,
                                  verbose=verbose)
        my_second("END", "generate deterministically selected subspace")
        print(f"Selected CI energy={res.energy:26.9f}  ndet={len(res.up)}")
        return res
    my_second("BEG", "truncated lanczos")
    res = perform_truncated_lanczos(system, iters=cfg.nblk_eq or 8,
                                    n_initiators=n_trunc, n_truncate=n_trunc,
                                    verbose=verbose)
    my_second("END", "truncated lanczos")
    print(f"Truncated Lanczos energy={res.energy:26.9f}")
    return res


def write_natorb_fcidump(cfg, system, res):
    """&natorb: FCIDUMP.natorb in the natural orbitals of the variational
    wavefunction's 1-RDM, with use_pt its first-order PT correction at
    eps_pt_big (eps_var when unset) (ref: hci.f90:683-745,
    generate_natorb_integrals:3554).  The wavefunction goes in as HCI
    returns it, time-symmetrized or not, as in the JAX package's CLI."""
    from .algo.rdm import (generate_natorb_fcidump, get_1rdm_with_pt,
                           natural_orbitals, rotate_integrals, write_fcidump)
    my_second("BEG", "natorb")
    nelec = system.nup + system.ndn
    if cfg.natorb_use_pt:
        gamma = get_1rdm_with_pt(
            system, res.up, res.dn, res.wts[:, 0], float(res.energies[0]),
            eps_pt_big=cfg.eps_pt_big if cfg.eps_pt_big > 0 else cfg.eps_var)
        sym = np.asarray(system.table.orb_sym)
        _, U = natural_orbitals(gamma, sym)
        h2, eri2 = rotate_integrals(system.table, U)
        write_fcidump("FCIDUMP.natorb", h2, eri2, system.table.core_energy,
                      sym, nelec=nelec)
    else:
        generate_natorb_fcidump(system, res.up, res.dn, res.wts[:, 0],
                                "FCIDUMP.natorb", nelec=nelec)
    print("Wrote FCIDUMP.natorb")
    my_second("END", "natorb")


def print_greens_function(cfg, system, res):
    """&greens_function: the zeroth-order Green's function's trace on
    n_w frequencies in [w_min, w_max] (ref: hci.f90:3849)."""
    from .algo.greens import greens_function_g0
    my_second("BEG", "greens_function")
    w_grid = np.linspace(cfg.w_min, cfg.w_max, cfg.n_w)
    g_np1, g_nm1 = greens_function_g0(system, res.up, res.dn, res.wts[:, 0],
                                      float(res.energies[0]), w_grid)
    for i, w in enumerate(w_grid):
        tr = np.trace(g_np1[i]).real + np.trace(g_nm1[i]).real
        print(f"G0(w={w:10.5f}): trace={tr:14.8f}")
    my_second("END", "greens_function")


def run_hci_pt(cfg, system, verbose: bool = True):
    """HCI (with the deck's &active_space), the &natorb and
    &greens_function observables, then PT for each state (ref: hci.f90
    perform_hci)."""
    from .algo.hci import run_hci
    from .algo.pt import do_pt

    my_second("BEG", "variational part")
    res = run_hci(system, eps_var=cfg.eps_var,
                  eps_var_sched=cfg.eps_var_sched, n_states=cfg.n_states,
                  verbose=verbose, dump_wf_var=cfg.dump_wf_var,
                  wf_cache_dir=".", active_space=cfg.active_space)
    my_second("END", "variational part")
    print(f"Variational energy={res.energies[0]:26.9f}")
    if cfg.get_natorbs:
        write_natorb_fcidump(cfg, system, res)
    if cfg.get_greens_function:
        print_greens_function(cfg, system, res)

    outs = []
    for state in range(cfg.n_states):
        if cfg.n_states > 1:
            print(f"State {state + 1}: variational energy="
                  f"{res.energies[state]:26.9f}")
        out = do_pt(system, res.up, res.dn, res.wts[:, state], res.diag,
                    float(res.energies[state]),
                    eps_var=min(cfg.eps_var_sched), eps_pt=cfg.eps_pt,
                    eps_pt_big=cfg.eps_pt_big, target_error=cfg.target_error,
                    n_mc=cfg.n_mc,
                    n_max_connections=int(cfg.n_max_connections),
                    verbose=verbose)
        if out["mode"] == "deterministic":
            print(f"Second-order PT energy lowering={out['pt']:26.9f}")
        else:
            print(f"Second-order PT energy lowering={out['pt']:26.9f} "
                  f"+- {out['pt_err']:.9f}")
        print(f"Total energy({state + 1})={out['e_tot']:26.9f}")
        if state == 0:
            print(f"Total energy={out['e_tot']:26.9f}")
        if cfg.hamiltonian_type == "heg" and \
                system.extra["madelung_implemented"]:
            print(f"Total energy (includ. Madelung)="
                  f"{out['e_tot'] + system.extra['energy_madelung']:22.9f}")
        outs.append(out)
    my_second("END", "HCI")
    return res, outs


def run_from_config(cfg, fcidump: str | None = None, verbose: bool = True,
                    device="cuda"):
    """Run a parsed deck on `device`."""
    check_ported(cfg)
    if cfg.hamiltonian_type in _TOY_TYPES:
        return run_toy(cfg, verbose=verbose, device=device)
    if cfg.run_type == "vmc" and cfg.hamiltonian_type == "hubbard2":
        # Gutzwiller VMC with Sherman-Morrison ratios (ref run_type 'vmc'
        # -> compute_vmc_energy_gutz_wf, hubbard.f90:1061)
        import time
        from .systems.hubbard.vmc import run_vmc
        my_second("BEG", "vmc")
        t0 = time.time()
        n_sweeps = 200
        e, err = run_vmc(cfg.l_x, cfg.l_y, cfg.t_hub, cfg.u_hub, cfg.nup,
                         cfg.nelec - cfg.nup, g=cfg.gutz_g, pbc=cfg.pbc,
                         n_sweeps=n_sweeps, seed=cfg.seeds[0] & 0xFFFF,
                         device=device)
        dt = time.time() - t0
        my_second("END", "vmc")
        if verbose:
            print(f"vmc: sweeps={n_sweeps} sweeps_per_s={n_sweeps / dt:.3f}")
        print(f"e_vmc={e:26.9f} +-{err:.9f}")
        print(f"e_mixed={e:26.9f} +-{err:.9f}")
        return e, err
    system = make_system(cfg, fcidump, device)
    if cfg.run_type in ("selected_ci", "trunc_lanc"):
        return run_legacy_ci(cfg, system, verbose=verbose)
    if cfg.run_type != "hci":
        my_second("BEG", "walk")
        out = run_det_walk(cfg, system, verbose=verbose)
        my_second("END", "walk")
        return out
    return run_hci_pt(cfg, system, verbose=verbose)


def main(argv=None):
    import torch
    from .ops import hbselect, hbspawn, segscan, seqinit, slotpar, spmv
    kernels = dict(seg_scan=segscan, spmv=spmv, hb_select=hbselect,
                   hb_spawn=hbspawn, slot_parents=slotpar, seq_init=seqinit)

    p = argparse.ArgumentParser(prog="sqmc_tpu_torch")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-f", "--fcidump", default=None,
                   help="FCIDUMP path (default: ./FCIDUMP)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (trace.json, Chrome "
                        "trace format) into DIR")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sqmc_tpu_torch: no CUDA card; pass --cpu to run "
                         "on the CPU")

    print("*" * 47)
    print("** SQMC-TPU (Semistochastic Quantum Monte Carlo) **")
    print("*" * 47)
    with open(args.input) as f:
        cfg = parse_input(f.read())
    for mod in kernels.values():
        mod.reset_launches()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else [])
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=acts) as prof:
            run_from_config(cfg, fcidump=args.fcidump, device=device)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        run_from_config(cfg, fcidump=args.fcidump, device=device)
    print("Kernel launches: " + " ".join(
        f"{k}={mod.launches}" for k, mod in kernels.items()), flush=True)


if __name__ == "__main__":
    main()
