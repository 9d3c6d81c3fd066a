"""Reference-compatible input parsing (the port's own copy of
sqmc_tpu/config.py: pure numpy, so the card deck reads the same in both
packages).

The reference consumes positional card-style input files plus Fortran
namelists that may appear anywhere (ref: do_walk.f90 read_input:162-1460,
prepare_namelist_copy:141, commons/common_selected_ci.f90:63-100).  This
module reads BOTH canonical layouts so reference inputs run unchanged:

  * the SQMC-style layout (src/e2e_tests/{c2,heg}/i_*): seeds, walk cards,
    run_type, HCI cards, system cards;
  * the HCI-minimal layout (C2_v2z_curve/r*/i_*): seeds, run_type, HCI
    cards, system cards.

Namelists handled: &selected_ci &hf_det &active_space &natorb
&greens_function.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np


@dataclasses.dataclass
class SqmcInput:
    seeds: tuple = (1, 1)
    run_type: str = "hci"
    hamiltonian_type: str = "chem"
    ipr: int = 0
    # walk cards
    nstep: int = 100
    nblk: int = 10
    nblk_eq: int = 2
    w_abs_begin: float = 10.0
    w_abs_target: float = 1000.0
    mwalk: int = 0
    tau_multiplier: float = 0.1
    tau: float = 0.0
    reweight_factor_inv_max: float = 2.0
    population_control_exponent: float = 10.0
    e_trial_initial: float = 0.0
    min_wt: float = 0.5
    proposal_method: str = "fast_heatbath"
    importance_sampling: int = 0
    r_initiator: float = 1.0
    initiator_power: float = 0.0
    semistochastic: bool = True
    hf_to_psit: bool = False
    c_t_initiator: bool = False
    always_spawn_cutoff: float = 0.5
    n_truncate_det: int = 0
    # HCI cards
    eps_var: float = 1e-3
    eps_pt: float = 1e-5
    target_error: float = 1e-4
    n_states: int = 1
    dump_wf_var: bool = False
    # chem cards
    nelec: int = 0
    nup: int = 0
    point_group: str = "c1"
    time_sym: bool = False
    z: int = 1
    norb: int = 0
    orbital_symmetries: np.ndarray | None = None
    spatial_symmetry_wf: int = 1
    diagonalize_ham: int = 0
    # heg cards
    n_dim: int = 3
    r_s: float = 1.0
    cutoff_radius: float = 1.0
    # namelist extras
    eps_var_sched: list | None = None
    n_max_connections: float = 4e7
    n_mc: int = -1
    eps_pt_big: float = -1.0
    hf_symmetry: int | None = None
    # walk run_type extras (ref do_walk.f90:321-401)
    partial_node_eps: float = 0.0
    use_exponential_projector: bool = False
    psi_g_energy: float = 0.0
    psi_g_epsilon: float = 0.0
    size_deterministic: int = 0
    initiator_rescale_power: float = 0.0
    # iterated deterministic-space construction cards (ref
    # generate_space_iterate inputs, do_walk.f90:954-960)
    diff_from_psi_t: bool = False
    imp_iters: int = 0
    norb_imp: list = dataclasses.field(default_factory=list)
    n_imp_init: list = dataclasses.field(default_factory=list)
    n_imp_trunc: list = dataclasses.field(default_factory=list)
    # trial-wavefunction construction cards, read for chem walk-mode decks
    # (ref chemistry.f90:204-219; Psi_T built by generate_space_iterate
    # with these at hamiltonian_mod.f90:113-115)
    n_core_orb: int = 0
    trial_wf_iters: int = -1          # -1 = cards absent from the deck
    norb_trial_wf: list = dataclasses.field(default_factory=list)
    n_initiators_trial_wf: list = dataclasses.field(default_factory=list)
    n_truncate_trial_wf: list = dataclasses.field(default_factory=list)
    # toy backends (ref hamiltonian_mod.f90:81-92,320-344)
    bosonic: int = 1
    spectrum_coef: float = 1.0
    spectrum_power: float = 1.0
    ham_diag_fluc: float = 0.0
    ham_offdiag_fluc: float = 0.1
    ndet_toy: int = 0
    ndet_psi_t: int = 0
    iwdet_psi_t: list | None = None
    cdet_psi_t: list | None = None
    # hubbard cards (ref hubbard.f90 read_hubbard:138)
    l_x: int = 0
    l_y: int = 0
    t_hub: float = 1.0
    u_hub: float = 4.0
    pbc: bool = True
    neel_up_only: bool = False
    # trial/guiding wavefunction cards (ref hubbard.f90:211-253): wf_type
    # 'gutz'/'gutz_rhf'/... reads the Gutzwiller factor g next
    wf_type: str = ""
    gutz_g: float = 1.0
    # namelist-driven observables (&natorb, &greens_function, &active_space)
    get_natorbs: bool = False
    natorb_use_pt: bool = False
    get_greens_function: bool = False
    n_w: int = 20
    w_min: float = -1.0
    w_max: float = 1.0
    active_space: tuple | None = None
    hf_up_occ: list | None = None       # &hf_det up= (1-based orbitals)
    hf_dn_occ: list | None = None


def _parse_bool(tok: str) -> bool:
    t = tok.strip().lower().lstrip(".")
    return t.startswith("t")


def parse_namelists(text: str) -> dict:
    """Extract all &name ... / namelist groups into {name: {key: value}}.
    Values support Fortran repeat syntax (2*2e-3) and lists."""
    out = {}
    for m in re.finditer(r"&(\w+)(.*?)/", text, re.S):
        name = m.group(1).lower()
        body = m.group(2)
        entries = {}
        for am in re.finditer(r"(\w+)\s*=\s*([^=/]+?)(?=(?:\s+\w+\s*=)|$)",
                              body.strip(), re.S):
            key = am.group(1).lower()
            raw = am.group(2).strip().rstrip(",")
            vals = []
            for tok in re.split(r"[,\s]+", raw):
                if not tok:
                    continue
                if "*" in tok and re.match(r"^\d+\*", tok):
                    n, v = tok.split("*", 1)
                    vals.extend([_num_or_str(v)] * int(n))
                else:
                    vals.append(_num_or_str(tok))
            entries[key] = vals[0] if len(vals) == 1 else vals
        out.setdefault(name, {}).update(entries)
    return out


def _num_or_str(tok: str):
    t = tok.strip()
    tl = t.lower().lstrip(".")
    if tl.startswith("t") and tl.rstrip(".") in ("t", "true"):
        return True
    if tl.startswith("f") and tl.rstrip(".") in ("f", "false"):
        return False
    try:
        if re.match(r"^[-+]?\d+$", t):
            return int(t)
        return float(t.replace("d", "e").replace("D", "E"))
    except ValueError:
        return t.strip("'\"")


def _card_lines(text: str):
    """Data lines with trailing comments kept (the reference reads
    list-directed, so only leading tokens matter); namelist and comment
    lines removed."""
    lines = []
    skip = False
    for ln in text.splitlines():
        s = ln.strip()
        if not s or s.startswith("!") or s.startswith("#"):
            continue
        if s.startswith("&"):
            skip = not s.endswith("/")
            continue
        if skip:
            if s.endswith("/"):
                skip = False
            continue
        lines.append(s)
    return lines


def _tokens(line: str, n: int):
    """First n whitespace/comma separated tokens of a card line."""
    toks = re.split(r"[,\s]+", line.strip())
    return toks[:n]


def parse_input(text: str) -> SqmcInput:
    cfg = SqmcInput()
    nl = parse_namelists(text)
    lines = _card_lines(text)

    i = 0

    def take(n=99):
        nonlocal i
        toks = _tokens(lines[i], n)
        i += 1
        return toks

    t = take(2)
    cfg.seeds = (int(t[0]), int(t[1]))

    # layout detection: SQMC-style has numeric cards next; HCI-minimal has
    # the run_type string
    if re.match(r"^[a-zA-Z]", lines[i].split()[0]):
        cfg.run_type = take(1)[0]
    else:
        t = take(4)
        cfg.nstep, cfg.nblk, cfg.nblk_eq = int(t[0]), int(t[1]), int(t[2])
        cfg.ipr = int(t[3]) if len(t) > 3 else 0
        t = take(3)
        cfg.w_abs_begin, cfg.w_abs_target = float(t[0]), float(t[1])
        cfg.mwalk = int(t[2]) if len(t) > 2 else 0
        t = take(2)
        cfg.tau_multiplier = float(t[0])
        cfg.tau = float(t[1]) if len(t) > 1 else 0.0
        t = take(2)
        cfg.reweight_factor_inv_max = float(t[1]) if len(t) > 1 else 2.0
        if cfg.reweight_factor_inv_max <= 0:
            cfg.reweight_factor_inv_max = 2.0
        t = take(3)
        cfg.population_control_exponent = float(t[0])
        cfg.e_trial_initial = float(t[1])
        cfg.min_wt = float(t[2]) if len(t) > 2 else 0.5
        t = take(5)
        cfg.proposal_method = t[0]
        if len(t) > 1:
            cfg.importance_sampling = int(t[1])
        if len(t) > 2:
            cfg.r_initiator = float(t[2])
        if len(t) > 3:
            cfg.initiator_power = float(t[3])
        cfg.run_type = take(1)[0]

    if cfg.run_type == "hci":
        t = take(4)
        cfg.eps_var = float(t[0])
        cfg.eps_pt = float(t[1])
        if len(t) > 2:
            cfg.target_error = float(t[2])
        if len(t) > 3:
            cfg.n_states = int(t[3])
        cfg.dump_wf_var = _parse_bool(take(1)[0])
    else:
        # walk-mode card sequence (ref do_walk.f90:321-401)
        if cfg.run_type in ("partial_node", "sr"):
            cfg.partial_node_eps = float(take(1)[0])
        t = take(2)
        cfg.semistochastic = _parse_bool(t[0])
        if len(t) > 1:
            cfg.use_exponential_projector = _parse_bool(t[1])
        if cfg.semistochastic:
            cfg.diff_from_psi_t = _parse_bool(take(1)[0])
            if cfg.diff_from_psi_t:
                cfg.imp_iters = int(take(1)[0])
                cfg.norb_imp = [int(x) for x in take(cfg.imp_iters)]
                cfg.n_imp_init = [int(x) for x in take(cfg.imp_iters)]
                cfg.n_imp_trunc = [int(x) for x in take(cfg.imp_iters)]
            else:
                cfg.size_deterministic = int(take(1)[0])
            t = take(3)
            cfg.hf_to_psit = _parse_bool(t[0])
            if len(t) > 1:
                cfg.c_t_initiator = _parse_bool(t[1])
            if len(t) > 2:
                cfg.always_spawn_cutoff = float(t[2])
        if cfg.importance_sampling == 1:
            t = take(2)
            cfg.psi_g_energy = float(t[0])
            cfg.psi_g_epsilon = float(t[1])

    # optional SQMC extras before the hamiltonian card
    while not re.match(r"^['\"]?(chem|heg|hubbard\w*|fictitious|read)\b",
                       lines[i].strip(), re.I):
        s = lines[i].lower()
        if "semistoch" in s:
            cfg.semistochastic = _parse_bool(_tokens(lines[i], 1)[0])
        elif "hf_to_psit" in s:
            t = _tokens(lines[i], 3)
            cfg.hf_to_psit = _parse_bool(t[0])
            cfg.c_t_initiator = _parse_bool(t[1])
            cfg.always_spawn_cutoff = float(t[2])
        elif "n_truncate" in s:
            cfg.n_truncate_det = int(_tokens(lines[i], 1)[0])
        i += 1

    t = take(2)
    cfg.hamiltonian_type = t[0].strip("'\"")
    if len(t) > 1:
        cfg.ipr = int(t[1])

    if cfg.hamiltonian_type == "chem":
        t = take(2)
        cfg.nelec, cfg.nup = int(t[0]), int(t[1])
        cfg.point_group = take(1)[0]
        cfg.time_sym = _parse_bool(take(1)[0])
        if cfg.time_sym:
            cfg.z = int(take(1)[0])
        cfg.norb = int(take(1)[0])
        # trial-wf construction cards (ref chemistry.f90:204-219; read for
        # run_type /= hci): n_core_orb, trial_wf_iters, then the three
        # per-iteration arrays (the array records are consumed even at
        # iters=0, matching Fortran's empty list-directed reads).  Decks
        # without these cards (next line is already the comma-separated
        # symmetry list) keep trial_wf_iters = -1.
        def _is_sym_list(line):
            return line.split()[0].count(",") >= max(2, cfg.norb // 4)

        if cfg.run_type != "hci" and i < len(lines) \
                and not _is_sym_list(lines[i]):
            cfg.n_core_orb = int(take(1)[0])
            cfg.trial_wf_iters = int(take(1)[0])
            n = cfg.trial_wf_iters
            arrs = []
            for _ in range(3):
                toks = take()          # record consumed even when n == 0
                arrs.append([int(x) for x in toks[:n]] if n > 0 else [])
            (cfg.norb_trial_wf, cfg.n_initiators_trial_wf,
             cfg.n_truncate_trial_wf) = arrs
        # remaining chem cards up to orbital_symmetries: skip numeric cards
        # until we find the long comma-separated symmetry list
        while i < len(lines):
            first = lines[i].split()[0]
            if first.count(",") >= max(2, cfg.norb // 4):
                break
            i += 1
        syms = [int(x) for x in
                re.split(r"[,\s]+", lines[i].split()[0].strip().rstrip(","))
                if x]
        cfg.orbital_symmetries = np.asarray(syms[:cfg.norb], np.int32)
        i += 1
        if i < len(lines):
            cfg.spatial_symmetry_wf = int(lines[i].split()[0])
            i += 1
        if i < len(lines):
            cfg.diagonalize_ham = int(lines[i].split()[0])
    elif cfg.hamiltonian_type == "heg":
        cfg.n_dim = int(take(1)[0])
        cfg.r_s = float(take(1)[0])
        t = take(2)
        cfg.nelec, cfg.nup = int(t[0]), int(t[1])
        cfg.cutoff_radius = float(take(1)[0])
    elif cfg.hamiltonian_type in ("fictitious", "read"):
        # ref hamiltonian_mod.f90:81-92 (fictitious cards), :337-339
        # (diagonalize_ham), read_psi_trial.f90:24-35 (toy psi_t)
        if cfg.hamiltonian_type == "fictitious":
            t = take(5)
            cfg.bosonic = int(t[0])
            cfg.spectrum_coef = float(t[1])
            cfg.spectrum_power = float(t[2])
            cfg.ham_diag_fluc = float(t[3])
            cfg.ham_offdiag_fluc = float(t[4])
            cfg.ndet_toy = int(take(1)[0])
        if i < len(lines):
            cfg.diagonalize_ham = int(take(1)[0])
        if i < len(lines):
            cfg.ndet_psi_t = int(take(1)[0])
            cfg.iwdet_psi_t = [int(x) for x in take(cfg.ndet_psi_t)]
            cfg.cdet_psi_t = [float(x) for x in take(cfg.ndet_psi_t)]
    elif cfg.hamiltonian_type in ("hubbard", "hubbard2", "hubbardk",
                                  "hubbarddm"):
        # ref hamiltonian_mod.f90:273-283 ('hubbard' dense toy) and
        # hubbard.f90 read_hubbard:138 (l_x,l_y / pbc / t,U / n_alpha,n_beta)
        t = take(2)
        cfg.l_x, cfg.l_y = int(t[0]), int(t[1])
        t = take(2)
        cfg.pbc = _parse_bool(t[0])
        if len(t) > 1:
            cfg.neel_up_only = _parse_bool(t[1])
        t = take(2)
        cfg.t_hub, cfg.u_hub = float(t[0]), float(t[1])
        t = take(2)
        cfg.nup = int(t[0])
        cfg.nelec = int(t[0]) + int(t[1])
        # optional wf_type card (ref hubbard.f90:211: read(5,*) wf_type);
        # 'gutz*' types read the Gutzwiller g and diagonalize_ham next
        # (ref :244-253)
        if i < len(lines) and re.match(r"^['\"]?[A-Za-z]",
                                       lines[i].strip()):
            cfg.wf_type = _tokens(lines[i], 1)[0].strip("'\"")
            i += 1
            if cfg.wf_type.startswith("gutz") or \
                    cfg.wf_type.startswith("cgutz"):
                cfg.gutz_g = float(take(1)[0])
                cfg.diagonalize_ham = int(take(1)[0])
        elif i < len(lines):
            cfg.diagonalize_ham = int(take(1)[0])
            if i < len(lines):
                cfg.ndet_psi_t = int(take(1)[0])
                cfg.iwdet_psi_t = [int(x) for x in take(cfg.ndet_psi_t)]
                cfg.cdet_psi_t = [float(x) for x in take(cfg.ndet_psi_t)]

    # namelist overrides
    sc = nl.get("selected_ci", {})
    if "eps_var_sched" in sc:
        v = sc["eps_var_sched"]
        cfg.eps_var_sched = v if isinstance(v, list) else [v]
    if "n_max_connections" in sc:
        cfg.n_max_connections = float(sc["n_max_connections"])
    if "n_mc" in sc:
        cfg.n_mc = int(sc["n_mc"])
    if "eps_pt_big" in sc:
        cfg.eps_pt_big = float(sc["eps_pt_big"])
    if "n_states" in sc:
        cfg.n_states = int(sc["n_states"])
    hf = nl.get("hf_det", {})
    if "hf_symmetry" in hf:
        cfg.hf_symmetry = int(hf["hf_symmetry"])
    if "up" in hf:
        v = hf["up"]
        cfg.hf_up_occ = [int(x) for x in (v if isinstance(v, list) else [v])]
    if "dn" in hf:
        v = hf["dn"]
        cfg.hf_dn_occ = [int(x) for x in (v if isinstance(v, list) else [v])]
    # &natorb (ref: common_selected_ci.f90:51-54)
    nat = nl.get("natorb", {})
    cfg.get_natorbs = bool(nat.get("get_natorbs", False))
    cfg.natorb_use_pt = bool(nat.get("use_pt", False))
    # &greens_function (ref: common_selected_ci.f90:56-61)
    gf = nl.get("greens_function", {})
    cfg.get_greens_function = bool(gf.get("get_greens_function", False))
    cfg.n_w = int(gf.get("n_w", 20))
    cfg.w_min = float(gf.get("w_min", -1.0))
    cfg.w_max = float(gf.get("w_max", 1.0))
    # &active_space (ref: common_selected_ci.f90:63-67)
    ac = nl.get("active_space", {})
    if int(ac.get("n_var_orbs", 0)) > 0:
        cfg.active_space = (int(ac["n_var_e_up"]), int(ac["n_var_e_dn"]),
                            int(ac["n_var_orbs"]))

    if cfg.eps_var_sched is None:
        cfg.eps_var_sched = [cfg.eps_var] * 10
    else:
        # a namelist sched overwrites the leading entries of the length-10
        # default [eps_var]*10 (Fortran namelist partial-array semantics;
        # o_det_ref "eps_var_sched=" line)
        sched = [float(x) for x in cfg.eps_var_sched]
        cfg.eps_var_sched = (sched + [cfg.eps_var] * 10)[:max(10, len(sched))]
    return cfg
