"""The port's card-input entry point (``python -m sqmc_tpu_torch``) against
the JAX package's (``python -m sqmc_tpu``): the same parse of every
inline deck, the same printed energies (to 1e-9) on a time-symmetrized
chem HCI+PT deck with d2h, hf_symmetry and two states and on an electron
gas deck, walk decks run through the cards on the CPU (time-symmetrized
chem, momentum-space Hubbard HCI, a fixed-node Gutzwiller walk on
real-space Hubbard), the dense toy decks (`fictitious`, `read`, dense
`hubbard`) with tests/test_cli.py's gates, the `vmc` deck, the
`dump_wf_var` deck run twice, and a ValueError naming its ROADMAP item for
every card the port does not run (tests/test_torch_cli_observables.py
runs the legacy CI and observable cards)."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from sqmc_tpu.algo.rdm import write_fcidump
from sqmc_tpu.config import parse_input as j_parse
from sqmc_tpu_torch import cli
from sqmc_tpu_torch.config import parse_input as t_parse
from test_torch_timesym import D2H_SYMS, sym_integrals

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# decks (copies of tests/test_cli.py's, plus the port's own)
# ---------------------------------------------------------------------------

FICTITIOUS = """\
1234567 7654321                    irand_seed
100 8 2 0                          nstep,nblk,nblk_eq,ipr
500 2000 0                         w_abs_gen_begin, w_abs_gen_target, MWALK
0.5 0.                             tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.25                        population_control_expon, e_trial_initial, min_wt
heat_bath2 0 1. 0 1.               proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
none                               run_type
.false. f                          semistochastic, use_exponential_projector
'fictitious' 0                     hamiltonian_type,ipr
1 1. 1. 0.5 1.0                    bosonic, spectrum_coef, spectrum_power, ham_diag_fluc, ham_offdiag_fluc
20                                 ndet
1                                  diagonalize_ham
2                                  ndet_psi_t
1 2                                iwdet_psi_t
0.9 0.3                            cdet_psi_t
"""

HUBBARD_TOY = """\
42 7                               irand_seed
80 6 2 0                           nstep,nblk,nblk_eq,ipr
300 1500 0                         w_abs_gen_begin, w_abs_gen_target, MWALK
0.3 0.                             tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.25                        population_control_expon, e_trial_initial, min_wt
heat_bath2 0 1. 0 1.               proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
none                               run_type
.false. f                          semistochastic, use_exponential_projector
'hubbard' 0                        hamiltonian_type,ipr
2 2                                l_x, l_y
t f                                pbc, neel_up_only
1. 4.                              t, U
1 1                                n_alpha, n_beta
1                                  diagonalize_ham
1                                  ndet_psi_t
1                                  iwdet_psi_t
1.0                                cdet_psi_t
"""

HUBBARDK = """\
9 3                                irand_seed
hci                                run_type
1e-9 1e-9 1e-4 1                   eps_var, eps_pt, target_error, n_states
f                                  dump_wf_var
'hubbardk' 0                       hamiltonian_type,ipr
2 2                                l_x, l_y
t f                                pbc, neel_up_only
1. 4.                              t, U
2 2                                n_alpha, n_beta
"""

HUBBARD2_FN = """\
13 5                               irand_seed
100 4 2 0                          nstep,nblk,nblk_eq,ipr
1500 3000 4096                     w_abs_gen_begin, w_abs_gen_target, MWALK
0.3 0.02                           tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
fast_heatbath 1 0. 0 1.            proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
fixed_node1                        run_type
.false. f                          semistochastic, use_exponential_projector
0. 0.                              psi_g_energy, psi_g_epsilon
'hubbard2' 0                       hamiltonian_type,ipr
1 8                                l_x, l_y
f f                                pbc, neel_up_only
1. 4.                              t, U
2 2                                n_alpha, n_beta
gutz                               wf_type
0.7                                g
0                                  diagonalize_ham
"""

CHEM_WALK = """\
1837465927472523 1257676276476276   irand_seed
100 5 3 0                          nstep,nblk,nblk_eq,ipr
2000 4000 8192                     w_abs_gen_begin, w_abs_gen_target, MWALK
0.1 0.                             tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
fast_heatbath 0 1. 0 1.            proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
none                               run_type
.true. f                           semistochastic, use_exponential_projector
f                                  diff_from_psi_t
200                                size_deterministic
f f 0.5                            hf_to_psit, c_t_initiator, always_spawn_cutoff
'chem'  0                          hamiltonian_type,ipr
8        4                        nelec, nup
d2h                                point_group
f                                  time_sym
26                                 norb
0                                  n_core_spatial_orb
2                                  trial_wf_iterations
26 26                              norb_trial_wf
1 20                               trial_wf_initiators
50 80                              n_sym_uniq_det_trial_wf
1,5,3,2,1,7,6,5,1,2,3,1,6,7,5,4,1,5,3,2,8,5,1,7,6,5, orbital_symmetries(1:norb)
1                                  spatial_symmetry_wf
0                                  diagonalize_ham
"""

OBSERVABLES = FICTITIOUS + """
&natorb get_natorbs=.true. use_pt=.false. /
&greens_function get_greens_function=.true. n_w=5 w_min=-2. w_max=2. /
&active_space n_var_e_up=2 n_var_e_dn=2 n_var_orbs=10 /
"""

# a C2-curve deck's layout (HCI-minimal: time_sym z = +1, d2h, two states,
# the eps_var schedule 2 x 2e-3 -> 1e-3, hf_symmetry) on 6 orbitals
TS_HCI = """\
1 1                                irand_seed
hci                                run_type
1e-3 1e-7 1e-4 2                   eps_var, eps_pt, target_error, n_states
f                                  dump_wf_var
'chem' 0                           hamiltonian_type,ipr
6 3                                nelec, nup
d2h                                point_group
t                                  time_sym
1                                  z
6                                  norb
1,5,3,2,1,7,                       orbital_symmetries(1:norb)
1                                  spatial_symmetry_wf
&selected_ci eps_var_sched=2*2e-3 /
&hf_det hf_symmetry=1 /
"""

HEG_HCI = """\
1 1                                irand_seed
hci                                run_type
1e-4 1e-7 1e-4 1                   eps_var, eps_pt, target_error, n_states
f                                  dump_wf_var
'heg' 0                            hamiltonian_type,ipr
3                                  n_dim
1.0                                r_s
4 2                                nelec, nup
1.6                                cutoff_radius
"""

# a time-symmetrized walk deck in the SQMC layout: trial_wf cards,
# hf_to_psit, tau from tau_multiplier, auto MWALK
TS_WALK = """\
11 7                               irand_seed
20 3 1 0                           nstep,nblk,nblk_eq,ipr
200 500 0                          w_abs_gen_begin, w_abs_gen_target, MWALK
0.1 0.                             tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
heat_bath2 0 1. 0 1.               proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
none                               run_type
.true. f                           semistochastic, use_exponential_projector
f                                  diff_from_psi_t
4                                  size_deterministic
t f 0.5                            hf_to_psit, c_t_initiator, always_spawn_cutoff
'chem'  0                          hamiltonian_type,ipr
6        3                         nelec, nup
d2h                                point_group
t                                  time_sym
1                                  z
6                                  norb
0                                  n_core_spatial_orb
2                                  trial_wf_iterations
6 6                                norb_trial_wf
1 5                                trial_wf_initiators
10 20                              n_sym_uniq_det_trial_wf
1,5,3,2,1,7,                       orbital_symmetries(1:norb)
1                                  spatial_symmetry_wf
0                                  diagonalize_ham
"""

# the fixed_node1 variant of tests/test_cli.py:135-148: importance sampling
# adds the psi_g card after the semistochastic one
FICTITIOUS_FN = FICTITIOUS.replace(
    "heat_bath2 0 1. 0 1.", "heat_bath2 1 0. 0 1.").replace(
    "none                               run_type",
    "fixed_node1                        run_type").replace(
    ".false. f                          semistochastic, use_exponential_projector",
    ".false. f                          semistochastic, use_exponential_projector\n"
    "0. 0.                              psi_g_energy, psi_g_epsilon")

HUBBARD2_VMC = HUBBARD2_FN.replace("1 8 ", "2 2 ").replace(
    "f f                                pbc", "t f                                pbc"
).replace("fixed_node1                        run_type",
          "vmc                                run_type")

DECKS = dict(fictitious=FICTITIOUS, fictitious_fn=FICTITIOUS_FN,
             hubbard_toy=HUBBARD_TOY, hubbard2_vmc=HUBBARD2_VMC,
             hubbardk=HUBBARDK, hubbard2_fn=HUBBARD2_FN,
             chem_walk=CHEM_WALK, observables=OBSERVABLES, ts_hci=TS_HCI,
             heg_hci=HEG_HCI, ts_walk=TS_WALK,
             partial_node=FICTITIOUS.replace(
                 "none                               run_type",
                 "partial_node                       run_type\n0.7  eps"))


@pytest.mark.parametrize("name", sorted(DECKS))
def test_parse_input_matches_jax(name):
    """Every field of the parsed deck equals the JAX package's."""
    j, t = j_parse(DECKS[name]), t_parse(DECKS[name])
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.fixture(scope="module")
def fcidump(tmp_path_factory):
    h, eri, core = sym_integrals(6, D2H_SYMS[:6], 3)
    path = str(tmp_path_factory.mktemp("cli") / "FCIDUMP")
    write_fcidump(path, h, eri, core, D2H_SYMS[:6], nelec=6, ms2=0)
    return path


def _run(pkg, deck_text, tmp_path, *extra):
    deck = tmp_path / f"deck_{pkg}"
    deck.write_text(deck_text)
    out = subprocess.run([sys.executable, "-m", pkg, "-i", str(deck), *extra],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                                  OMP_NUM_THREADS="2"),
                         timeout=900)
    return out


ENERGY_LINES = (r"Variational energy=\s*([-+0-9.]+)",
                r"Second-order PT energy lowering=\s*([-+0-9.]+)",
                r"Total energy\(\d\)=\s*([-+0-9.]+)",
                r"Total energy=\s*([-+0-9.]+)",
                r"State \d: variational energy=\s*([-+0-9.]+)",
                r"Total energy \(includ. Madelung\)=\s*([-+0-9.]+)")


def _energies(text):
    return {p: [float(x) for x in re.findall(p, text)] for p in ENERGY_LINES}


@pytest.mark.parametrize("deck", ["ts_hci", "heg_hci"])
def test_cli_energies_match_jax(deck, fcidump, tmp_path):
    """Both CLIs with --cpu print the same energies to 1e-9 (each printed
    to 9 decimals): HCI, PT for each state, totals, Madelung.  The port's
    HEG run also writes a --profile trace."""
    extra = ("-f", fcidump, "--cpu") if deck == "ts_hci" else ("--cpu",)
    prof = tmp_path / "prof"
    jo = _run("sqmc_tpu", DECKS[deck], tmp_path, *extra)
    to = _run("sqmc_tpu_torch", DECKS[deck], tmp_path, *extra,
              *(("--profile", str(prof)) if deck == "heg_hci" else ()))
    assert jo.returncode == 0, jo.stderr[-2000:]
    assert to.returncode == 0, to.stderr[-2000:]
    je, te = _energies(jo.stdout), _energies(to.stdout)
    assert je[ENERGY_LINES[0]] and je[ENERGY_LINES[1]]
    if deck == "ts_hci":
        assert len(je[ENERGY_LINES[2]]) == 2            # both states
    else:
        assert je[ENERGY_LINES[5]]
    for p in ENERGY_LINES:
        assert len(te[p]) == len(je[p]), p
        np.testing.assert_allclose(te[p], je[p], rtol=0, atol=1.01e-9,
                                   err_msg=p)
    for tag in ("END OF variational part", "END OF HCI"):
        assert tag in to.stdout
    assert "Kernel launches: seg_scan=0 spmv=0" in to.stdout
    if deck == "heg_hci":
        assert (prof / "trace.json").stat().st_size > 0


def test_cli_ts_walk_deck_on_cpu(fcidump, tmp_path):
    """The time-symmetrized walk deck through the cards on the CPU: Psi_T
    from the trial_wf cards, Psi_T forced into D, tau deduced, MWALK
    auto-sized, heat_bath2 mapped to fast_heatbath; e_mixed lands near
    the exact e0 of the sector."""
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.systems.base import make_chem_system
    to = _run("sqmc_tpu_torch", TS_WALK, tmp_path, "-f", fcidump, "--cpu")
    assert to.returncode == 0, to.stderr[-2000:]
    text = to.stdout
    for line in ("trial_wf_iters", "hf_to_psit: forcing Psi_T",
                 "tau_multiplier, tau=", "Setting MWALK=",
                 "heat_bath2 -> fast_heatbath", "END OF walk"):
        assert line in text, line
    assert "WARNING: no trial_wf cards" not in text
    assert "seq_init=0 spawn_hist=0" in text
    m = re.search(r"e_mixed=\s*([-+0-9.]+)\s*\+-\s*([0-9.eE-]+)", text)
    e, err = float(m.group(1)), float(m.group(2))
    s = make_chem_system(fcidump, time_sym=True, z=1, point_group="d2h",
                         device="cpu")
    e0 = run_hci(s, eps_var=1e-9, eps_var_sched=[1e-9] * 20, max_iters=40,
                 verbose=False).energies[0]
    assert np.isfinite(err) and abs(e - e0) < max(6 * err, 2e-3), (e, e0)


def test_cli_needs_a_card_without_cpu(tmp_path):
    """Without --cpu the CLI runs on the card, and without one it exits
    nonzero before any work (it never falls back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    to = _run("sqmc_tpu_torch", HEG_HCI, tmp_path)
    assert to.returncode != 0
    assert "--cpu" in to.stderr and "Variational energy" not in to.stdout


def test_cli_hubbardk_hci_deck_on_cpu(tmp_path):
    """The HUBBARDK_INPUT deck of tests/test_cli.py through the port's
    CLI: tiny-eps HCI gives the FCI energy of the HF-connected sector of
    the 2x2 cluster, -5.6568542 (to 1e-5, the JAX test's bound), and PT
    adds nothing."""
    to = _run("sqmc_tpu_torch", HUBBARDK, tmp_path, "--cpu")
    assert to.returncode == 0, to.stderr[-2000:]
    e = _energies(to.stdout)
    assert e[ENERGY_LINES[0]][0] == pytest.approx(-5.6568542, abs=1e-5)
    assert abs(e[ENERGY_LINES[1]][0]) < 1e-8
    assert "Kernel launches: seg_scan=0 spmv=0" in to.stdout


def test_cli_hubbard2_fixed_node_deck_on_cpu(tmp_path):
    """The HUBBARD2_FN_INPUT deck of tests/test_cli.py through the port's
    CLI: fixed_node1 with importance sampling and Gutzwiller guiding
    (g = 0.7) on the 1x8 open chain.  The guiding function is nodeless in
    the chain's ordered basis, so the fixed-node oracle is the exact
    ground energy of the enumerated 784-det space; e_mixed lands within
    max(6 sigma, 5e-3) of it (the JAX test allows max(8 sigma, 0.05))."""
    import itertools
    import torch
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_real_system
    to = _run("sqmc_tpu_torch", HUBBARD2_FN, tmp_path, "--cpu")
    assert to.returncode == 0, to.stderr[-2000:]
    text = to.stdout
    for line in ("trial_wf_type=gutz", "g=   0.700", "END OF walk"):
        assert line in text, line
    m = re.search(r"e_mixed=\s*([-+0-9.]+)\s*\+-\s*([0-9.eE-]+)", text)
    e, err = float(m.group(1)), float(m.group(2))
    s = make_hubbard_real_system(1, 8, 1.0, 4.0, 2, 2, pbc=False, device="cpu")
    combos = [dets.det_from_orbs(c, 8) for c in itertools.combinations(range(8), 2)]
    up = torch.as_tensor(np.repeat(np.stack(combos), len(combos), axis=0))
    dn = torch.as_tensor(np.tile(np.stack(combos), (len(combos), 1)))
    sp = build_sparse_ham(s.table, up, dn, 2, 2, 8)
    H = np.zeros((len(up),) * 2)
    H[sp.rows.numpy(), sp.cols.numpy()] = sp.vals.numpy()
    H = H + H.T + np.diag(sp.diag.numpy())
    e0 = float(np.linalg.eigvalsh(H)[0])
    assert np.isfinite(err) and abs(e - e0) < max(6 * err, 5e-3), (e, e0, err)


E_MIXED = r"e_mixed=\s*([-+0-9.]+)\s*\+-\s*([0-9.eE-]+)"
E_EXACT = r"Setting e_trial \(from diagonalizing Hamiltonian\) =\s*([-+0-9.]+)"


def _toy_run(deck, tmp_path):
    to = _run("sqmc_tpu_torch", deck, tmp_path, "--cpu")
    assert to.returncode == 0, to.stderr[-2000:]
    text = to.stdout
    e_exact = float(re.search(E_EXACT, text).group(1))
    e, err = map(float, re.search(E_MIXED, text).groups())
    for line in ("ndet=", "energy_exact=", "tau_multiplier, tau=",
                 "error vs exact=", "END OF walk",
                 "Kernel launches: seg_scan=0 spmv=0"):
        assert line in text, line
    return text, e_exact, e, err


def test_cli_fictitious_deck_on_cpu(tmp_path):
    """FICTITIOUS_INPUT of tests/test_cli.py through the port's CLI, with
    that test's gate; the printed lines carry the JAX CLI's digit formats
    (the matrix is bit-identical, so the exact energy is the same line)."""
    text, e_exact, e, err = _toy_run(FICTITIOUS, tmp_path)
    assert abs(e - e_exact) < max(5 * err, 0.05), (e, e_exact, err)
    jo = _run("sqmc_tpu", FICTITIOUS, tmp_path, "--cpu")
    assert jo.returncode == 0, jo.stderr[-2000:]
    for pat in (r"^bosonic, spectrum_coef.*$", r"^ndet=.*$", r"^eigval=.*$",
                r"^Fraction of walkers.*$", r"^Setting e_trial.*$",
                r"^energy_exact=.*$", r"^tau_multiplier, tau=.*$"):
        a = re.search(pat, text, re.M)
        b = re.search(pat, jo.stdout, re.M)
        assert a and b and a.group(0) == b.group(0), pat
    assert re.search(r"^e_mixed= {14}-?\d+\.\d{9} \+-\d+\.\d{9}$", text, re.M)
    assert re.search(r"^error vs exact= *-?\d+\.\d{9}$", text, re.M)


def test_cli_fictitious_fixed_node_deck_on_cpu(tmp_path):
    """fixed_node1 with importance sampling on the fictitious matrix
    (tests/test_cli.py:135-162): the fixed-node energy is an upper bound
    and stays within 0.5 of ED here."""
    _, e_exact, e, _ = _toy_run(FICTITIOUS_FN, tmp_path)
    assert e >= e_exact - 0.02 and abs(e - e_exact) < 0.5


def test_cli_hubbard_dense_toy_deck_on_cpu(tmp_path):
    """HUBBARD_TOY_INPUT of tests/test_cli.py (the dense `hubbard` type)."""
    text, e_exact, e, err = _toy_run(HUBBARD_TOY, tmp_path)
    assert "ndet=             16" in text
    assert abs(e - e_exact) < max(6 * err, 0.1), (e, e_exact, err)


def test_cli_read_deck_on_cpu(tmp_path):
    """hamiltonian_type 'read': the matrix comes from ./hamiltonian."""
    from sqmc_tpu.systems.toy import make_fictitious_system
    ham = make_fictitious_system(12, bosonic=1, ham_diag_fluc=0.5,
                                 ham_offdiag_fluc=1.0).ham
    with open(tmp_path / "hamiltonian", "w") as f:
        f.write("12\n" + "\n".join(" ".join(f"{x:.17g}" for x in row)
                                    for row in ham))
    deck = "\n".join(line for line in FICTITIOUS.replace(
        "'fictitious' 0", "'read' 0").splitlines()
        if "bosonic" not in line and not line.endswith(" ndet")) + "\n"
    cfg = t_parse(deck)
    assert cfg.hamiltonian_type == "read" and cfg.diagonalize_ham == 1
    text, e_exact, e, err = _toy_run(deck, tmp_path)
    assert "ndet=             12" in text
    assert e_exact == pytest.approx(np.linalg.eigvalsh(ham)[0], abs=1e-5)
    assert abs(e - e_exact) < max(5 * err, 0.05), (e, e_exact, err)


def test_cli_vmc_deck_on_cpu(tmp_path):
    """run_type vmc on hubbard2: the Gutzwiller VMC energy lands on the
    brute-force energy of the same wavefunction (mean-field orbitals, the
    deck's g)."""
    from sqmc_tpu_torch.systems.hubbard.meanfield import hartree_fock
    from sqmc_tpu_torch.systems.hubbard.vmc import exact_vmc_energy
    to = _run("sqmc_tpu_torch", HUBBARD2_VMC, tmp_path, "--cpu")
    assert to.returncode == 0, to.stderr[-2000:]
    text = to.stdout
    for line in ("BEG OF vmc", "END OF vmc", "e_vmc=", "sweeps_per_s="):
        assert line in text, line
    e, err = map(float, re.search(E_MIXED, text).groups())
    assert f"e_vmc={e:26.9f} +-{err:.9f}" in text
    pu, pd, _ = hartree_fock(2, 2, 1.0, 4.0, 2, 2, True)
    want = exact_vmc_energy(2, 2, 1.0, 4.0, 2, 2, 0.7, pu, pd)
    assert abs(e - want) < max(5 * err, 0.05), (e, want, err)


def test_cli_dump_wf_var_deck_twice(fcidump, tmp_path):
    """The time-symmetrized HCI deck with dump_wf_var: the first run writes
    wf_eps_var=... into the working directory, the second reads it, skips
    the variational stage and prints the same energies; the JAX CLI reads
    the port's file too."""
    deck = TS_HCI.replace("f                                  dump_wf_var",
                          "t                                  dump_wf_var")
    assert t_parse(deck).dump_wf_var
    first = _run("sqmc_tpu_torch", deck, tmp_path, "-f", fcidump, "--cpu")
    assert first.returncode == 0, first.stderr[-2000:]
    assert "Writing variational wavefn to ./wf_eps_var=1.00E-03" in first.stdout
    assert (tmp_path / "wf_eps_var=1.00E-03.npz").exists()
    second = _run("sqmc_tpu_torch", deck, tmp_path, "-f", fcidump, "--cpu")
    assert second.returncode == 0, second.stderr[-2000:]
    assert "Reading variational wavefn from" in second.stdout
    assert "Iteration   1" not in second.stdout
    third = _run("sqmc_tpu", deck, tmp_path, "-f", fcidump, "--cpu")
    assert third.returncode == 0, third.stderr[-2000:]
    assert "Reading variational wavefn from" in third.stdout
    e1 = _energies(first.stdout)
    for other in (second, third):
        e2 = _energies(other.stdout)
        # run_hci prints its own "Variational energy=" line only when it
        # runs the variational stage: compare what follows it
        for p in ENERGY_LINES:
            n = len(e2[p])
            assert n > 0 or not e1[p], p
            np.testing.assert_allclose(e2[p], e1[p][len(e1[p]) - n:], rtol=0,
                                       atol=1.01e-9, err_msg=p)
        assert len(e2[ENERGY_LINES[0]]) == len(e1[ENERGY_LINES[0]]) - 1
    assert len(e1[ENERGY_LINES[2]]) == 2


def _cfg(deck, **kw):
    return dataclasses.replace(t_parse(DECKS[deck]), **kw)


# name: (deck config, ROADMAP item of the refusal; None = the card is ported
# now, and check_ported must let it through; "" = an unknown type)
UNPORTED = {
    "fictitious": (lambda: _cfg("fictitious"), None),
    "read": (lambda: _cfg("fictitious", hamiltonian_type="read"), None),
    "hubbard": (lambda: _cfg("hubbard_toy"), None),
    "hubbarddm": (lambda: _cfg("hubbardk", hamiltonian_type="hubbarddm"),
                  "no card-input path"),
    "hubbardk": (lambda: _cfg("hubbardk"), None),
    "hubbard2": (lambda: _cfg("hubbard2_fn"), None),
    "selected_ci": (lambda: _cfg("ts_hci", run_type="selected_ci"), None),
    "trunc_lanc": (lambda: _cfg("ts_hci", run_type="trunc_lanc"), None),
    "vmc": (lambda: _cfg("hubbard2_vmc"), None),
    "fixed_node": (lambda: _cfg("ts_walk", run_type="fixed_node1"), None),
    "guiding": (lambda: _cfg("ts_walk", importance_sampling=1), None),
    "uniform": (lambda: _cfg("ts_walk", proposal_method="uniform"), None),
    "cauchy_schwarz": (lambda: _cfg("ts_walk",
                                    proposal_method="CauchySchwarz"), None),
    "exponential": (lambda: _cfg("ts_walk", use_exponential_projector=True),
                    None),
    "natorbs": (lambda: _cfg("ts_hci", get_natorbs=True), None),
    "greens": (lambda: _cfg("ts_hci", get_greens_function=True), None),
    "active_space": (lambda: _cfg("ts_hci", active_space=(2, 2, 4)), None),
    "dump_wf_var": (lambda: _cfg("ts_hci", dump_wf_var=True), None),
    "unknown": (lambda: _cfg("ts_hci", hamiltonian_type="spin"),
                "hamiltonian_type"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_cards_raise(name, fcidump):
    """Every card the port does not run raises ValueError naming its
    ROADMAP item (`hubbarddm` has no card path in either package and says
    so); the cards ported since (Hubbard systems, fixed-node run types,
    guiding, the other proposals, the exponential projector, the dense toy
    types, vmc, dump_wf_var, the legacy CI run types, &natorb,
    &greens_function, &active_space) pass the check."""
    make, item = UNPORTED[name]
    if item is None:
        cli.check_ported(make())
        return
    with pytest.raises(ValueError, match=item):
        cli.run_from_config(make(), fcidump=fcidump, device="cpu")


def test_run_hci_refusals_name_their_items(fcidump):
    """run_hci refuses no option any more (the mesh is ported, A7); a mesh
    argument that is not a parallel.dist.Mesh raises, naming make_mesh."""
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.systems.base import make_chem_system
    s = make_chem_system(fcidump, device="cpu")
    with pytest.raises(ValueError, match="make_mesh"):
        run_hci(s, eps_var=1e-3, verbose=False, mesh=object())


def test_wavefunction_cache_raises(fcidump, tmp_path, monkeypatch):
    """Both CLIs read a wf_eps_var=... cache from the working directory.
    A file of that name that is neither package's .npz nor a
    reference-format record file raises instead of being ignored."""
    from sqmc_tpu_torch.utils.checkpoint import wf_var_filename
    monkeypatch.chdir(tmp_path)
    cfg = _cfg("ts_hci")
    name = wf_var_filename(min(cfg.eps_var_sched))
    assert name == "./wf_eps_var=1.00E-03"
    (tmp_path / name).write_text("x")
    with pytest.raises((EOFError, IOError)):
        cli.run_from_config(cfg, fcidump=fcidump, device="cpu")
