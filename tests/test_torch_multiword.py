"""Multi-word determinants in the port (norb > 64, two int64 words a
spin), the cases of tests/test_multiword.py for sqmc_tpu_torch: a small
random-integral system padded with dead orbitals past the word boundary
must reproduce the one-word results (HCI, PT, the 1-RDM, the walk's
trajectory without singles, the deterministic limit with singles).
tests/test_torch_multiword_keys.py holds the two-word parity with the
JAX package."""

import numpy as np
import pytest
import torch

from reference_impl import random_integrals
from sqmc_tpu_torch.algo import rdm as TR
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.algo.pt import second_order_pt
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.chem.integrals import n_eri, pair_index, quad_index

torch.set_num_threads(1)

NORB, NUP, NDN = 6, 3, 3
NPAD = 70                     # > 64: two words


def _padded(h, eri, live):
    """The integrals of NORB live orbitals placed at `live` among NPAD;
    the dead orbitals are far up in energy and in irreps of their own."""
    live = np.asarray(live)
    hp = np.zeros((NPAD, NPAD))
    hp[np.ix_(live, live)] = h
    dead = np.setdiff1d(np.arange(NPAD), live)
    hp[dead, dead] = 100.0 + dead
    erip = np.zeros(n_eri(NPAD))
    g = np.indices((NORB,) * 4).reshape(4, -1)
    erip[quad_index(pair_index(live[g[0]], live[g[1]]),
                    pair_index(live[g[2]], live[g[3]]))] = \
        eri[quad_index(pair_index(g[0], g[1]), pair_index(g[2], g[3]))]
    sym = np.ones(NPAD, np.int32)
    sym[dead] = 2 + np.arange(len(dead))      # unreachable irreps
    return hp, erip, sym


@pytest.fixture(scope="module")
def pair():
    h, eri, core, _ = random_integrals(NORB, seed=13)
    small = make_system_from_arrays(h, eri, core, NUP, NDN, device="cpu")
    hp, erip, sym = _padded(h, eri, range(NORB))
    big = make_system_from_arrays(hp, erip, core, NUP, NDN, orb_sym=sym,
                                  device="cpu")
    assert big.n_words == 2 and small.n_words == 1
    return small, big


def _hci(s, eps, n=10, **kw):
    return run_hci(s, eps_var=eps, eps_var_sched=[eps] * n, verbose=False,
                   **kw)


def test_torch_w2_hci_equals_w1(pair):
    small, big = pair
    r1, r2 = _hci(small, 1e-6), _hci(big, 1e-6)
    assert len(r1.up) == len(r2.up) > 100
    assert r2.energies[0] == pytest.approx(r1.energies[0], abs=1e-9)


def test_torch_w2_pt_equals_w1(pair):
    small, big = pair
    r1, r2 = _hci(small, 5e-2, 4), _hci(big, 5e-2, 4)
    pt1, n1 = second_order_pt(small, r1.up, r1.dn, r1.wts[:, 0],
                              r1.energies[0], 1e-9, verbose=False)
    pt2, n2 = second_order_pt(big, r2.up, r2.dn, r2.wts[:, 0],
                              r2.energies[0], 1e-9, verbose=False)
    assert pt2 == pytest.approx(pt1, abs=1e-9)
    assert n1 == n2


def test_torch_w2_rdm_equals_w1(pair):
    small, big = pair
    r1, r2 = _hci(small, 1e-6), _hci(big, 1e-6)
    g1 = TR.get_1rdm(small, r1.up, r1.dn, r1.wts[:, 0])
    g2 = TR.get_1rdm(big, r2.up, r2.dn, r2.wts[:, 0])
    np.testing.assert_allclose(g2[:NORB, :NORB], g1, rtol=0, atol=1e-8)
    assert np.abs(g2[NORB:, :]).max() < 1e-12


def test_torch_w2_walk_trajectory_equals_w1(pair):
    """Doubles-only proposals draw from row contents, identical after the
    padding, so the two-word walk follows the one-word walk's trajectory:
    block energies to 1e-8 (the singles' target alias maps the stream
    over norb slots and cannot be padding-invariant; the next test covers
    singles at W = 2)."""
    outs = []
    for s in pair:
        res = _hci(s, 1e-9, 12, max_iters=25)
        trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=20,
                                         n_imp=1)
        cfg = WalkConfig(mwalk=2048, cap_spawn=8192, norb=s.norb, nup=NUP,
                         ndn=NDN, n_words=s.n_words, tau=5e-3,
                         w_abs_target=1000.0, has_singles=False,
                         r_initiator=0.0)
        outs.append(run_walk(s, trial, cfg, nstep=20, nblk=3, nblk_eq=1,
                             w_abs_begin=500.0,
                             e_trial_initial=float(res.energies[0]),
                             verbose=False, seed=11, max_eq_extensions=0))
    np.testing.assert_allclose(outs[0].e_blocks, outs[1].e_blocks, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(outs[0].w_abs_trace, outs[1].w_abs_trace,
                               rtol=1e-10, atol=1e-6)


def test_torch_w2_deterministic_limit(pair):
    """W = 2 walk with singles and D = the whole space: exact power
    iteration reaches the FCI energy to 1e-9."""
    _, big = pair
    res = _hci(big, 1e-9, 12, max_iters=25)
    trial = build_trial_wavefunction(big, eps_var=1e-9, n_psi_t=len(res.up),
                                     n_imp=len(res.up))
    cfg = WalkConfig(mwalk=1024, cap_spawn=4096, norb=big.norb, nup=NUP,
                     ndn=NDN, n_words=2, tau=5e-3, w_abs_target=500.0,
                     has_singles=True)
    out = run_walk(big, trial, cfg, nstep=20, nblk=2, nblk_eq=1,
                   w_abs_begin=500.0, e_trial_initial=float(res.energies[0]),
                   verbose=False)
    assert abs(out.e_mixed - float(res.energies[0])) < 1e-9
