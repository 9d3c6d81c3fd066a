"""The uniform and Cauchy-Schwarz double proposals, the two-level merge and
the sequential initiator rule as stochastic walks against FCI, and the
linear projector on momentum-space Hubbard.

The two packages cannot share a random stream, so these are statistical
checks: |e_mixed - e0| < 6 sigma + the floor of the JAX package's test of
the same oracle (stated at each case)."""

import pytest
import torch

from reference_impl import random_integrals
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.heg.system import make_heg_system
from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system

torch.set_num_threads(1)

HCI_EXACT = dict(eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                 verbose=False)


def _tol(out, floor_sigma, floor):
    return 6 * max(out.e_err, floor_sigma) + floor


# ---------------------------------------------------------------------------
# proposals and merges
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chem4():
    h, eri, core, _ = random_integrals(4, seed=5)
    s = make_system_from_arrays(h, eri, core, 2, 2, device="cpu")
    e0 = float(run_hci(s, **HCI_EXACT).energies[0])
    return s, e0, build_trial_wavefunction(s, eps_var=1e-4, n_psi_t=10, n_imp=1)


@pytest.mark.parametrize("proposal", ["uniform", "cauchy_schwarz"])
def test_chem_proposals_unbiased(chem4, proposal):
    """uniform / Cauchy-Schwarz doubles with the singles channel on dense
    random integrals: 6 max(sigma, 5e-6) + 1e-4
    (tests/test_walk.py::test_walk_chem_proposals_unbiased)."""
    s, e0, trial = chem4
    cfg = WalkConfig(mwalk=1024, cap_spawn=4096, cap_fresh=512, norb=4, nup=2,
                     ndn=2, n_words=1, tau=2e-3, w_abs_target=2000.0,
                     has_singles=True, r_initiator=0.0, proposal=proposal)
    out = run_walk(s, trial, cfg, nstep=100, nblk=5, nblk_eq=2,
                   w_abs_begin=1000.0, e_trial_initial=e0, verbose=False,
                   max_eq_extensions=0, seed=4)
    assert abs(out.e_mixed - e0) < _tol(out, 5e-6, 1e-4), (out.e_mixed, e0)


@pytest.fixture(scope="module")
def heg4():
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    e0 = float(run_hci(s, **HCI_EXACT).energies[0])
    return s, e0, build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=1)


def test_heg_uniform_proposal_unbiased(heg4):
    """uniform doubles on the electron gas: 6 max(sigma, 5e-6) + 5e-5
    (tests/test_walk.py::test_walk_uniform_proposal_unbiased)."""
    s, e0, trial = heg4
    cfg = WalkConfig(mwalk=1024, cap_spawn=4096, cap_fresh=1024, norb=s.norb,
                     nup=2, ndn=2, n_words=1, tau=4e-3, w_abs_target=2000.0,
                     has_singles=False, r_initiator=0.0, proposal="uniform")
    out = run_walk(s, trial, cfg, nstep=100, nblk=5, nblk_eq=2,
                   w_abs_begin=1000.0, e_trial_initial=e0, verbose=False,
                   max_eq_extensions=0, seed=5)
    assert abs(out.e_mixed - e0) < _tol(out, 5e-6, 5e-5), (out.e_mixed, e0)


def test_heg_two_level_merge_unbiased(heg4):
    """The two-level merge (new dets through its sort and rank merge) on
    the stochastic electron-gas walk of
    tests/test_torch_walk_stochastic.py: 6 max(sigma, 5e-6) + 2e-5."""
    s, e0, trial = heg4
    cfg = WalkConfig(mwalk=1024, cap_spawn=4096, cap_fresh=1024, norb=s.norb,
                     nup=2, ndn=2, n_words=1, tau=5e-3, w_abs_target=2000.0,
                     has_singles=False, r_initiator=0.0,
                     full_sort_merge=False, cap_new=2048)
    out = run_walk(s, trial, cfg, nstep=100, nblk=5, nblk_eq=2,
                   w_abs_begin=1000.0, e_trial_initial=e0, verbose=False,
                   seed=3)
    assert abs(out.e_mixed - e0) < _tol(out, 5e-6, 2e-5), (out.e_mixed, e0)


def test_heg_sequential_rule_walk(heg4):
    """The sequential initiator rule through run_walk, with a real
    initiator threshold so the rule decides something: a short walk (the
    rule's passes grow with the largest merge group, so the population is
    kept at 500) stays at its target population and within 6 sigma + 1e-3
    of FCI (initiator bias included)."""
    s, e0, trial = heg4
    cfg = WalkConfig(mwalk=1024, cap_spawn=2048, cap_fresh=1024, norb=s.norb,
                     nup=2, ndn=2, n_words=1, tau=5e-3, w_abs_target=500.0,
                     has_singles=False, r_initiator=1.0,
                     initiator_rule="sequential")
    out = run_walk(s, trial, cfg, nstep=25, nblk=3, nblk_eq=2,
                   w_abs_begin=400.0, e_trial_initial=e0, verbose=False,
                   seed=3)
    assert abs(out.w_abs_trace[-25:].mean() - 500.0) < 100.0
    assert abs(out.e_mixed - e0) < _tol(out, 5e-6, 1e-3), (out.e_mixed, e0)


def test_hubbardk_linear_walk_vs_fci():
    """The linear projector on momentum-space Hubbard (no singles channel,
    equal-magnitude heat-bath rows): the FCI energy of the HF-connected
    sector, 6 max(sigma, 5e-6) + 1e-4."""
    s = make_hubbard_k_system(2, 2, 1.0, 4.0, 2, 2, device="cpu")
    e0 = float(run_hci(s, **HCI_EXACT).energies[0])
    trial = build_trial_wavefunction(s, eps_var=1e-6, n_psi_t=36, n_imp=1)
    cfg = WalkConfig(mwalk=1024, cap_spawn=4096, cap_fresh=1024, norb=s.norb,
                     nup=2, ndn=2, n_words=1, tau=5e-3, w_abs_target=2000.0,
                     has_singles=False, r_initiator=0.0)
    out = run_walk(s, trial, cfg, nstep=100, nblk=5, nblk_eq=2,
                   w_abs_begin=1000.0, e_trial_initial=e0, verbose=False,
                   seed=6)
    assert abs(out.e_mixed - e0) < _tol(out, 5e-6, 1e-4), (out.e_mixed, e0)
