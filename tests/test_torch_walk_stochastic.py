"""The port's stochastic walk against exact energies: no initiator cutoff
(r_initiator = 0) and a one-det deterministic space, so spawning carries
the whole projection and the mixed energy is unbiased.  The port cannot
share the JAX package's random stream, so these are statistical checks
with the bounds of tests/test_walk.py (6 sigma plus a floor)."""

import numpy as np
import pytest
import torch

from reference_impl import random_integrals
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.heg.system import make_heg_system

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    res = run_hci(s, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                  verbose=False)
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=1)
    return s, float(res.energies[0]), trial


def test_heg_stochastic_unbiased(tiny):
    s, e0, trial = tiny
    cfg = WalkConfig(mwalk=1024, cap_spawn=4096, cap_fresh=1024,
                     norb=s.norb, nup=2, ndn=2, n_words=1, tau=5e-3,
                     w_abs_target=2000.0, has_singles=False, r_initiator=0.0)
    out = run_walk(s, trial, cfg, nstep=100, nblk=6, nblk_eq=3,
                   w_abs_begin=1000.0, e_trial_initial=e0, verbose=False,
                   seed=3)
    assert abs(out.e_mixed - e0) < 6 * max(out.e_err, 5e-6) + 2e-5
    assert out.spawn_hist.sum() > 0


@pytest.mark.parametrize("f32_state", [False, True])
def test_chem_singles_unbiased(f32_state):
    """Heat-bath doubles plus the singles channel on dense random
    integrals (norb 5): f64 state takes the exact single element from the
    integral table, f32 state the packed float32 row."""
    norb, nup, ndn = 5, 2, 2
    h, eri, core, _ = random_integrals(norb, seed=5)
    s = make_system_from_arrays(h, eri, core, nup, ndn, device="cpu")
    e0 = float(run_hci(s, eps_var=1e-9, eps_var_sched=[1e-9] * 30,
                       max_iters=60, verbose=False).energies[0])
    trial = build_trial_wavefunction(s, eps_var=1e-4, n_psi_t=10, n_imp=1)
    cfg = WalkConfig(mwalk=512, cap_spawn=4096, cap_fresh=512, norb=norb,
                     nup=nup, ndn=ndn, n_words=1, tau=2e-3,
                     w_abs_target=2000.0, has_singles=True, r_initiator=0.0,
                     f32_state=f32_state)
    out = run_walk(s, trial, cfg, nstep=100, nblk=6, nblk_eq=3,
                   w_abs_begin=1000.0, e_trial_initial=e0, verbose=False,
                   max_eq_extensions=0, seed=4)
    assert abs(out.e_mixed - e0) < 6 * max(out.e_err, 5e-6) + 1e-4


def test_capacity_escalation(tiny):
    """Undersized capacities grow, the overflowing block reruns, and the
    walk completes unbiased (ref MWALK auto-size, do_walk.f90:652-674)."""
    s, e0, trial = tiny
    cfg = WalkConfig(mwalk=64, cap_spawn=256, cap_fresh=512, norb=s.norb,
                     nup=2, ndn=2, n_words=1, tau=5e-3, w_abs_target=2000.0,
                     has_singles=False, r_initiator=0.0)
    out = run_walk(s, trial, cfg, nstep=50, nblk=3, nblk_eq=2,
                   w_abs_begin=1000.0, e_trial_initial=e0, verbose=False,
                   max_eq_extensions=0, seed=5)
    assert out.capacity_grows >= 1
    assert out.state.up.shape[0] == 64 * 2 ** out.capacity_grows
    assert float(np.mean(out.w_abs_trace[-50:])) > 1000.0
    assert abs(out.e_mixed - e0) < 8 * max(out.e_err, 5e-6) + 5e-5
