"""The port's walk in the deterministic limit, against the JAX package.

With the deterministic space D equal to the whole (FCI) space of the tiny
HEG, every spawn lands in D and is discarded by the merge, so a
generation is exact power iteration and independent of the random
stream: the port must reproduce the JAX package's per-generation
estimator trace value by value.  The system, trial and initial state are
built by the JAX package and handed over through sqmc_tpu_torch.convert,
so this checks the walk alone."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo import walk as JW
from sqmc_tpu.algo.hci import run_hci as j_hci
from sqmc_tpu.algo.semistoch import build_trial_wavefunction as j_trial
from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import walk as TW

torch.set_num_threads(2)

KW = dict(mwalk=2048, cap_spawn=4096, n_words=1, tau=5e-3,
          w_abs_target=500.0, has_singles=False)
KEYS = ("e_num_gen", "e_den_gen", "w_abs_gen", "nwalk")


@pytest.fixture(scope="module")
def exact():
    js = j_heg(3, 1.0, 4, 2, 1.6)
    res = j_hci(js, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                verbose=False)
    jt = j_trial(js, eps_var=1e-9, n_psi_t=len(res.up), n_imp=len(res.up))
    return js, res, jt, convert.system_from_numpy(js, device="cpu"), convert.trial_from_npz(jt, device="cpu")


def _port_trace(ts, tt, jst, f32, nsteps=10, cap_fresh=0):
    cfg = TW.WalkConfig(norb=ts.norb, nup=2, ndn=2, f32_state=f32,
                        cap_fresh=cap_fresh, **KW)
    tables = TW.build_walk_tables(ts, tt, cfg)
    st = convert.walk_state_from_numpy(jst, f32_state=f32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    out = []
    for _ in range(nsteps):
        st, stats = TW.walk_step(st, tables, cfg, gen)
        out.append([float(stats[k]) for k in KEYS])
    return np.asarray(out), tables


def test_deterministic_trace_matches_jax(exact):
    """f64 state, block-ELL projection: e_num_gen, e_den_gen, w_abs_gen and
    nwalk equal JAX's eager walk_step to 1e-10 relative for 10
    generations (float64 throughout; only summation order differs)."""
    js, res, jt, ts, tt = exact
    jcfg = JW.WalkConfig(norb=js.norb, nup=2, ndn=2, **KW)
    jtab = JW.build_walk_tables(js, jt, cfg=jcfg)
    jst = JW.init_walk_state(jcfg, jt, 500.0, float(res.energies[0]),
                             tables=jtab)
    conv = convert.walk_state_from_numpy(jst, device="cpu")   # walk_step donates jst
    got, tables = _port_trace(ts, tt, jst, f32=False)
    assert tables.imp_dense.numel() == 0 and tables.imp_ell_ptr.numel() > 1
    ref = []
    st = jst
    for _ in range(10):
        st, stats = JW.walk_step(st, jtab, jcfg)
        ref.append([float(stats[k]) for k in KEYS])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-10, atol=0)
    # the port's own initial state is the one JAX builds
    cfg = TW.WalkConfig(norb=ts.norb, nup=2, ndn=2, **KW)
    mine = TW.init_walk_state(cfg, tt, 500.0, float(res.energies[0]),
                              TW.build_walk_tables(ts, tt, cfg))
    for f in ("up", "dn", "wt", "init", "imp", "diag", "ct"):
        assert torch.equal(getattr(mine, f), getattr(conv, f)), f


@pytest.mark.parametrize("cutoff", [2.0, 2.45])
def test_deterministic_trace_general_keys(cutoff):
    """Two-electron HEGs with 33 and 81 plane waves: norb > 32 takes the
    general multi-key sort and the bisection C(T) search instead of the
    fused 32-bit key, and 81 orbitals need two words per spin.  Same
    1e-10 parity as above, 5 generations.  (The JAX side runs without its
    C(T) hash, whose constants overflow for two-word dets; the hash and
    the search give the same indices.)"""
    js = j_heg(3, 1.0, 2, 1, cutoff)
    assert js.norb == {2.0: 33, 2.45: 81}[cutoff]
    res = j_hci(js, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                verbose=False)
    jt = j_trial(js, eps_var=1e-9, n_psi_t=len(res.up), n_imp=len(res.up))
    kw = dict(KW, mwalk=1024, n_words=js.n_words)
    jcfg = JW.WalkConfig(norb=js.norb, nup=1, ndn=1, det_hash=False, **kw)
    jtab = JW.build_walk_tables(js, jt, cfg=jcfg)
    jst = JW.init_walk_state(jcfg, jt, 500.0, float(res.energies[0]),
                             tables=jtab)
    ts, tt = convert.system_from_numpy(js, device="cpu"), convert.trial_from_npz(jt, device="cpu")
    cfg = TW.WalkConfig(norb=ts.norb, nup=1, ndn=1, cap_fresh=1024, **kw)
    tables = TW.build_walk_tables(ts, tt, cfg)
    assert tables.ct_key.numel() == 0            # not the fused-key path
    st = convert.walk_state_from_numpy(jst, device="cpu")
    gen = torch.Generator().manual_seed(0)
    got, ref = [], []
    for _ in range(5):
        st, stats = TW.walk_step(st, tables, cfg, gen)
        got.append([float(stats[k]) for k in KEYS])
        jst, jstats = JW.walk_step(jst, jtab, jcfg)
        ref.append([float(jstats[k]) for k in KEYS])
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


def test_f32_dense_matches_f64_ell(exact):
    """f32 state with the dense float32 projection against f64 state with
    block-ELL, from the same initial state: equal to 2e-6 relative (a few
    float32 roundings per generation, compounding over 10)."""
    js, res, jt, ts, tt = exact
    jcfg = JW.WalkConfig(norb=js.norb, nup=2, ndn=2, **KW)
    jst = JW.init_walk_state(jcfg, jt, 500.0, float(res.energies[0]),
                             tables=JW.build_walk_tables(js, jt, cfg=jcfg))
    f64, _ = _port_trace(ts, tt, jst, f32=False)
    f32, tables = _port_trace(ts, tt, jst, f32=True)
    assert tables.imp_dense.shape == (len(tt.imp_up),) * 2
    np.testing.assert_allclose(f32, f64, rtol=2e-6, atol=0)


def test_run_walk_exact_energy(exact):
    """run_walk in the deterministic limit reproduces the FCI energy to
    1e-9 (the form of tests/test_walk.py:29-39)."""
    js, res, jt, ts, tt = exact
    cfg = TW.WalkConfig(norb=ts.norb, nup=2, ndn=2, cap_fresh=512, **KW)
    out = TW.run_walk(ts, tt, cfg, nstep=30, nblk=2, nblk_eq=1,
                      w_abs_begin=500.0, e_trial_initial=float(res.energies[0]),
                      verbose=False)
    assert abs(out.e_mixed - res.energies[0]) < 1e-9
    assert out.n_measured == 60 and out.capacity_grows == 0


def test_unported_options_raise():
    """The JAX package's capacity workarounds are not part of the port;
    ranks without an axis name, and fixed-node, guided or CT walks over
    several ranks, raise; an unknown name or a fixed-node run without a
    guide raises as in the JAX package; every other option is accepted,
    the sharded walk included."""
    base = dict(norb=4, nup=2, ndn=2, **KW)
    sharded = dict(axis_name="d", n_dev=2)
    for opt in (dict(time_sym=True, z=0), dict(n_dev=4),
                dict(sharded, run_type="fixed_node1", guiding="gutzwiller"),
                dict(sharded, guiding="gutzwiller"),
                dict(sharded, use_exponential_projector=True,
                     semistochastic=False),
                dict(cap_compact=64), dict(cap_single=64),
                dict(run_type="fixed_node1"), dict(run_type="vmc"),
                dict(proposal="heat_bath2"), dict(initiator_rule="pairwise"),
                dict(guiding="jastrow")):
        with pytest.raises(ValueError):
            TW.WalkConfig(**base, **opt)
    for opt in (dict(use_exponential_projector=True, ct_mode="heg"),
                dict(run_type="fixed_node1", guiding="gutzwiller"),
                dict(run_type="sr", guiding="table", sr_nwalk=100),
                dict(proposal="uniform"), dict(proposal="cauchy_schwarz"),
                dict(ct_in_d=True), dict(full_sort_merge=False, cap_new=64),
                dict(initiator_rule="sequential"), dict(proj_bf16=True),
                dict(det_hash=False), sharded, dict(axis_name="d")):
        TW.WalkConfig(**base, **opt)
