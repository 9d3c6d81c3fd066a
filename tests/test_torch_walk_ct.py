"""The port's continuous-time (exponential) projector as a stochastic walk
against FCI, in its three modes, at a tau far beyond the linear
projector's range (CT propagation has no time-step error).

The two packages cannot share a random stream, so these are statistical
checks: |e_mixed - e0| < 6 max(sigma, 5e-6) + the floor that
tests/test_ct_walk.py allows for the same oracle (1e-4 hubbardk, 2e-4
heg / generic), at a population of 1,000 in 40-step blocks."""

import numpy as np
import pytest
import torch

from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.chem.integrals import n_eri
from sqmc_tpu_torch.systems.heg.system import make_heg_system
from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system

torch.set_num_threads(1)

HCI_EXACT = dict(eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                 verbose=False)


def _tol(out, floor_sigma, floor):
    return 6 * max(out.e_err, floor_sigma) + floor


# ---------------------------------------------------------------------------
# continuous-time projector
# ---------------------------------------------------------------------------

def _ct_case(name):
    if name == "hubbardk":
        s = make_hubbard_k_system(2, 2, 1.0, 4.0, 2, 2, device="cpu")
        return s, dict(tau=0.05, n_psi_t=36, eps=1e-6), 1e-4
    if name == "heg":
        s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
        return s, dict(tau=0.02, n_psi_t=30, eps=1e-4), 2e-4
    # the JAX test's system: a diagonal-dominant random h, small eri
    rng = np.random.default_rng(3)
    h = rng.normal(size=(5, 5)) * 0.3
    h = 0.5 * (h + h.T) + np.diag(np.arange(5) * 1.0)
    eri = rng.normal(size=n_eri(5)) * 0.1
    s = make_system_from_arrays(h, eri, 0.0, 2, 2, name="toy", device="cpu")
    return s, dict(tau=0.05, n_psi_t=30, eps=1e-6), 2e-4


@pytest.mark.parametrize("mode", ["hubbardk", "heg", "generic"])
def test_ct_projector_unbiased_at_large_tau(mode):
    """CT propagation has no time-step error: at tau = 0.05 (0.02 for the
    electron gas), ten times the linear walks' tau, the mixed energy is
    the FCI energy of the HF-connected sector.  Floors as in
    tests/test_ct_walk.py: 6 max(sigma, 5e-6) + 1e-4 (hubbardk) or 2e-4."""
    s, p, floor = _ct_case(mode)
    e0 = float(run_hci(s, **HCI_EXACT).energies[0])
    trial = build_trial_wavefunction(s, eps_var=p["eps"], n_psi_t=p["n_psi_t"],
                                     n_imp=1)
    cfg = WalkConfig(mwalk=1024, cap_spawn=2048, cap_fresh=512, norb=s.norb,
                     nup=2, ndn=2, n_words=1, tau=p["tau"], w_abs_target=1000.0,
                     has_singles=s.has_singles, r_initiator=0.0,
                     semistochastic=False, use_exponential_projector=True,
                     ct_mode=mode)
    out = run_walk(s, trial, cfg, nstep=40, nblk=5, nblk_eq=2,
                   w_abs_begin=750.0, e_trial_initial=e0, verbose=False,
                   max_eq_extensions=0, seed=1)
    assert out.capacity_grows == 0
    assert abs(out.e_mixed - e0) < _tol(out, 5e-6, floor), (out.e_mixed, e0)


def test_ct_chain_cap_zeroes_long_chains():
    """With ct_max_jumps = 1 every chain that wants a second move is
    zeroed, so the population cannot be sustained at a tau * rate of
    order one: the cap is enforced, not ignored."""
    s = make_hubbard_k_system(2, 2, 1.0, 4.0, 2, 2, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=1e-6, n_psi_t=36, n_imp=1)
    kw = dict(mwalk=2048, cap_spawn=8192, norb=s.norb, nup=2, ndn=2, n_words=1,
              tau=0.25, w_abs_target=1000.0, has_singles=False,
              r_initiator=0.0, semistochastic=False,
              use_exponential_projector=True)
    n_ok = {}
    for k in (1, 12):
        cfg = WalkConfig(ct_max_jumps=k, **kw)
        tab = TW.build_walk_tables(s, trial, cfg)
        st = TW.init_walk_state(cfg, trial, 1000.0, trial.e_trial, tab)
        _, stats = TW.walk_block(st, tab, cfg, 3, torch.Generator().manual_seed(0))
        n_ok[k] = float(stats["spawn_hist"].sum())
    assert n_ok[1] < 0.9 * n_ok[12]
