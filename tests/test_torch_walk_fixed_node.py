"""Importance sampling and the fixed-node family of run types as
stochastic walks against the dense fixed-node effective Hamiltonian on
an enumerated det space (the oracle of tests/test_fixed_node.py), with
Gutzwiller guiding (g = 0.7) on real-space Hubbard:

  * the 1x8 open chain (784 dets), the JAX tests' system.  Its guiding
    function is nodeless in the ordered basis, so no spawn violates the
    sign rule there and every run type must give the exact e0;
  * the 2x3 open lattice (225 dets), guided by the orbitals of the
    hopping matrix plus a small random site potential (the symmetric
    lattice's own orbitals put nodes exactly on some dets, and a det
    next to a node has a diagonal dump that the linear projector cannot
    hold at this tau).  There
    transformed elements do violate: fixed_node1 / partial_node redirect
    spawns to their parents and must land on the fixed-node oracle, above
    e0 by more than the tolerance.

The two packages cannot share a random stream, so these are statistical
checks: |e_mixed - oracle| < 6 max(sigma, 1e-4) + 1e-3, the bound of
tests/test_fixed_node.py, at a population of 1,000 in 100-step blocks."""

import itertools

import numpy as np
import pytest
import torch

from sqmc_tpu_torch import dets
from sqmc_tpu_torch.algo.guiding import (eval_guiding, make_gutzwiller_guiding,
                                         make_table_guiding)
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
from sqmc_tpu_torch.ops import setalg
from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_real_system

torch.set_num_threads(1)

HCI_EXACT = dict(eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                 verbose=False)


def _tol(out, floor_sigma, floor):
    return 6 * max(out.e_err, floor_sigma) + floor


# ---------------------------------------------------------------------------
# importance sampling and the fixed-node family
# ---------------------------------------------------------------------------

NUP, NDN, U, GUTZ_G = 2, 2, 4.0, 0.7


def _enumerated(l_x, l_y, site_potential=0.0):
    """An open l_x x l_y lattice with 2 + 2 electrons and Gutzwiller
    guiding (orbitals of h + a random site potential of the given size,
    seed 4): the whole det space enumerated, dense H and psi_g on it, a
    40-det trial and its vector on the space."""
    L = l_x * l_y
    s = make_hubbard_real_system(l_x, l_y, 1.0, U, NUP, NDN, pbc=False,
                                 device="cpu")
    pot = site_potential * np.random.default_rng(4).normal(size=L)
    _, phi = np.linalg.eigh(s.table.h.numpy() + np.diag(pot))
    guide = make_gutzwiller_guiding(s, g=GUTZ_G, phi_up=phi[:, :NUP],
                                    phi_dn=phi[:, :NDN])
    combos = [dets.det_from_orbs(c, L)
              for c in itertools.combinations(range(L), NUP)]
    up = torch.as_tensor(np.repeat(np.stack(combos), len(combos), axis=0))
    dn = torch.as_tensor(np.tile(np.stack(combos), (len(combos), 1)))
    sp = build_sparse_ham(s.table, up, dn, NUP, NDN, L)
    n = len(up)
    H = np.zeros((n, n))
    H[sp.rows.numpy(), sp.cols.numpy()] = sp.vals.numpy()
    H = H + H.T + np.diag(sp.diag.numpy())
    g = eval_guiding(guide, "gutzwiller", up, dn, L, NUP, NDN).numpy()
    assert np.abs(g).min() > 1e-6           # no det sits on a node
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=40, n_imp=1)
    vec = np.zeros(n)
    order = setalg.lexsort_dets(up, dn)
    pos = setalg.search_dets(up[order], dn[order], trial.psit_up, trial.psit_dn)
    vec[order[pos].numpy()] = trial.psit_coef.numpy()
    return s, guide, up, dn, H, g, trial, vec


@pytest.fixture(scope="module")
def chain():
    return _enumerated(1, 8)


@pytest.fixture(scope="module")
def lattice():
    return _enumerated(2, 3, site_potential=0.3)


def _n_violators(H, g):
    ht = H * (g[:, None] / g[None, :])
    return int((~np.eye(len(H), dtype=bool) & (ht > 0)).sum())


def _fn_oracle(H, g, psit_vec, eps=1.0):
    """Mixed energy of the ground state of the exact fixed-node(eps)
    effective Hamiltonian (tests/test_fixed_node.py::_fn_oracle)."""
    ht = H * (g[:, None] / g[None, :])
    off = ~np.eye(len(H), dtype=bool)
    viol = off & (ht > 0)
    hfn = np.where(viol, (1 - eps) * H, H)
    np.fill_diagonal(hfn, np.diag(H) + eps * np.sum(np.where(viol, ht, 0.0),
                                                    axis=0))
    w, v = np.linalg.eig(hfn)
    i0 = np.argmin(w.real)
    phi = v[:, i0].real
    phi *= np.sign(np.dot(phi, psit_vec) + 1e-300)
    return float(w[i0].real), float((psit_vec @ H @ phi) / (psit_vec @ phi))


W_TARGET = 1000.0


def _guided_walk(setup, run_type, target, seed, nblk=4, nblk_eq=2, **opts):
    s, guide, up, dn, H, g, trial, vec = setup
    cfg = WalkConfig(mwalk=1024, cap_spawn=2048, cap_fresh=1024, norb=s.norb,
                     nup=NUP, ndn=NDN, n_words=1, tau=2e-2,
                     w_abs_target=W_TARGET, has_singles=True, r_initiator=0.0,
                     run_type=run_type, guiding="gutzwiller", **opts)
    out = run_walk(s, trial, cfg, nstep=100, nblk=nblk, nblk_eq=nblk_eq,
                   w_abs_begin=700.0, e_trial_initial=target, verbose=False,
                   guide=guide, seed=seed)
    assert out.capacity_grows == 0
    return out


CHAIN_CASES = {
    "importance_sampled": ("none", {}),
    "fixed_node1": ("fixed_node1", {}),
}


@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_guided_walks_are_exact(chain, name):
    """The chain has no sign violator, so the fixed-node oracle IS e0 for
    every eps, and each run type must reproduce it."""
    H, g, vec = chain[4], chain[5], chain[7]
    e0 = float(np.linalg.eigvalsh(H)[0])
    assert _n_violators(H, g) == 0
    assert abs(_fn_oracle(H, g, vec, 1.0)[1] - e0) < 1e-10
    run_type, opts = CHAIN_CASES[name]
    out = _guided_walk(chain, run_type, e0, seed=2, nblk=4, nblk_eq=2, **opts)
    assert abs(out.e_mixed - e0) < _tol(out, 1e-4, 1e-3), (out.e_mixed, e0)


LATTICE_CASES = {
    # name: (run_type, options, eps of the oracle; None = the exact e0)
    "importance_sampled": ("none", {}, None),
    "fixed_node1": ("fixed_node1", {}, 1.0),
    "fixed_node4": ("fixed_node4", {}, 1.0),
    "partial_node": ("partial_node", dict(partial_node_eps=0.6), 0.6),
    "release_node": ("release_node", dict(release_step=150), None),
    "sr": ("sr", dict(partial_node_eps=1.0, sr_nwalk=1000), 1.0),
}


@pytest.mark.parametrize("name", sorted(LATTICE_CASES))
def test_lattice_guided_walk_matches_dense_oracle(lattice, name):
    """On the 2x3 lattice violating spawns exist and are redirected to
    their parents: the walk must land on the fixed-node(eps) oracle,
    which lies resolvably above e0 (fixed-node is variational), while
    plain importance sampling and the released walk give e0."""
    H, g, vec = lattice[4], lattice[5], lattice[7]
    run_type, opts, eps = LATTICE_CASES[name]
    e0 = float(np.linalg.eigvalsh(H)[0])
    assert _n_violators(H, g) > 100
    # the linear projector stays stable: tau x the largest diagonal dump < 1
    ht = H * (g[:, None] / g[None, :])
    assert 2e-2 * np.where(~np.eye(len(H), dtype=bool) & (ht > 0), ht,
                           0.0).sum(axis=0).max() < 0.5
    target = e0 if eps is None else _fn_oracle(H, g, vec, eps)[1]
    out = _guided_walk(lattice, run_type, target, seed=2, **opts)
    assert abs(out.e_mixed - target) < _tol(out, 1e-4, 1e-3), \
        (out.e_mixed, target, out.e_err)
    if eps is not None:
        assert _fn_oracle(H, g, vec, eps)[0] >= e0 - 1e-12
        assert target > e0 + 1e-2        # the node error is resolvable here


def test_sign_flip_and_drop_rules_differ(lattice):
    """fixed_node2 (violators flip) and fixed_node3 (violators dropped)
    keep a stable population and give different energies, both away from
    fixed_node1's (their effective Hamiltonians carry no diagonal dump)."""
    H, g, vec = lattice[4], lattice[5], lattice[7]
    e_fn1 = _fn_oracle(H, g, vec, 1.0)[1]
    e = {}
    for rt in ("fixed_node2", "fixed_node3"):
        out = _guided_walk(lattice, rt, e_fn1, seed=3, nblk=4, nblk_eq=2)
        assert abs(out.w_abs_trace[-100:].mean() - W_TARGET) < 0.2 * W_TARGET
        e[rt] = out.e_mixed
    assert abs(e["fixed_node2"] - e["fixed_node3"]) > 1e-2
    assert min(abs(e[rt] - e_fn1) for rt in e) > 1e-2


def test_table_guiding_follows_gutzwiller_trajectory(lattice):
    """'table' guiding holding the tabulated Gutzwiller values follows the
    same trajectory as the analytic guiding from the same seed: block
    energies equal to 1e-9 relative (tests/test_fixed_node.py)."""
    s, guide, up, dn, H, g, trial, vec = lattice
    L = s.norb
    tab = make_table_guiding(up.numpy(), dn.numpy(), g, device="cpu")
    outs = []
    for kind, gd in (("gutzwiller", guide), ("table", tab)):
        cfg = WalkConfig(mwalk=2048, cap_spawn=8192, norb=L, nup=NUP, ndn=NDN,
                         n_words=1, tau=2e-2, w_abs_target=1000.0,
                         has_singles=True, r_initiator=0.0,
                         run_type="fixed_node1", guiding=kind)
        outs.append(run_walk(s, trial, cfg, nstep=30, nblk=2, nblk_eq=1,
                             w_abs_begin=500.0, e_trial_initial=-3.0,
                             verbose=False, guide=gd, seed=7))
    np.testing.assert_allclose(outs[0].e_blocks, outs[1].e_blocks, rtol=1e-9)


# ---------------------------------------------------------------------------
# violators inside D; the dense engine as an independent witness
# ---------------------------------------------------------------------------

def test_fixed_node_dump_inside_d_is_counted_once(lattice):
    """D = the whole 2x3 space (225 dets, 240 sign violators, all of them
    inside D).  Every spawn is then D -> D and dropped, so the walk is the
    exact fixed-node projection on D and e_mixed must equal the dense
    fixed-node oracle up to the power iteration's convergence.  A D
    parent's violating spawn into D must not be redirected on top of it:
    the exact projector already holds that part of the dump (with the
    redirect kept, this walk sat 6.6e-2 above the oracle, more than the
    fixed-node error of 5.6e-2 itself)."""
    s, guide, up, dn, H, g, _, _ = lattice
    trial = build_trial_wavefunction(s, eps_var=1e-9, n_psi_t=40, n_imp=225)
    assert len(trial.imp_up) == 225 and _n_violators(H, g) == 240
    vec = np.zeros(len(up))
    order = setalg.lexsort_dets(up, dn)
    pos = setalg.search_dets(up[order], dn[order], trial.psit_up, trial.psit_dn)
    vec[order[pos].numpy()] = trial.psit_coef.numpy()
    e0 = float(np.linalg.eigvalsh(H)[0])
    target = _fn_oracle(H, g, vec, 1.0)[1]
    assert target > e0 + 5e-2
    out = _guided_walk((s, guide, up, dn, H, g, trial, vec), "fixed_node1",
                       target, seed=2, nblk=6, nblk_eq=3)
    assert abs(out.e_mixed - target) < 1e-5, (out.e_mixed, target)


def test_fixed_node_dump_partly_inside_d(lattice):
    """D = the 150 largest dets of the same lattice: violating pairs lie
    inside D, across its border and outside it.  fixed_node1 lands on the
    dense fixed-node oracle within the file's statistical bound."""
    s, guide, up, dn, H, g, _, vec = lattice
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=40, n_imp=150)
    assert len(trial.imp_up) == 150
    target = _fn_oracle(H, g, vec, 1.0)[1]
    out = _guided_walk((s, guide, up, dn, H, g, trial, vec), "fixed_node1",
                       target, seed=3, nblk=6, nblk_eq=2)
    assert abs(out.e_mixed - target) < _tol(out, 1e-4, 1e-3), \
        (out.e_mixed, target, out.e_err)


def test_chain_dense_engine_fixed_node_energy_is_e0():
    """The 1x8 open chain, 2 + 2 electrons (784 dets), Gutzwiller guiding
    g = 0.7 on the lattice's own orbitals, as a card deck builds it: no
    transformed element violates the sign rule, so the dense engine's
    fixed_node1 projector is the exact one, and at min_wt = 0 (no random
    draw) it power-iterates to e0 = -5.634427.  An unbiased fixed-node
    walk on this system therefore has e0 as its target."""
    from sqmc_tpu_torch.algo.densewalk import (DenseWalkConfig,
                                               build_dense_tables,
                                               dense_walk_block,
                                               init_dense_state)
    from sqmc_tpu_torch.systems.hubbard.system import (
        enumerate_dets, make_hubbard_dense_system)
    L = 8
    s = make_hubbard_real_system(1, L, 1.0, U, NUP, NDN, pbc=False,
                                 device="cpu")
    guide = make_gutzwiller_guiding(s, g=GUTZ_G)
    toy = make_hubbard_dense_system(1, L, 1.0, U, NUP, NDN, pbc=False,
                                    device="cpu")
    up, dn = (torch.as_tensor(x) for x in enumerate_dets(L, NUP, NDN))
    g = eval_guiding(guide, "gutzwiller", up, dn, L, NUP, NDN)
    assert toy.ndet == 784 and float(g.abs().min()) > 1e-6
    assert _n_violators(toy.ham.numpy(), g.numpy()) == 0
    e0 = float(torch.linalg.eigvalsh(toy.ham)[0])
    assert abs(e0 - (-5.634427)) < 1e-6
    cfg = DenseWalkConfig(ndet=784, tau=0.05, w_abs_target=1000.0,
                          run_type="fixed_node1", importance_sampling=1,
                          min_wt=0.0)
    psi_t = torch.zeros(784, dtype=torch.float64)
    psi_t[int(g.abs().argmax())] = 1.0
    tables = build_dense_tables(toy, cfg, psi_t, g)
    assert torch.equal(tables.p_off, tables.p_off_exact)
    state = init_dense_state(cfg, psi_t, g, 1000.0, e0, device="cpu")
    state, stats = dense_walk_block(state, tables, cfg, 3000)
    assert abs(float(stats["e_gen"][-1]) - e0) < 1e-6
    assert abs(float(stats["e_gen"][-1]) - (-5.634427)) < 1e-6
