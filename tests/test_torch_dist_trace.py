"""The port's determinant-sharded walk over 4 gloo ranks against the JAX
package's make_sharded_walk on 4 virtual CPU devices and against the
port's serial walk.

In the deterministic limit (tests/test_torch_walk_modes.py: D is the
whole 2x3 open lattice at 2 + 2, so every spawn lands in D and the merge
discards it) a generation does not depend on the random stream: the
sharded trace of e_num_gen, e_den_gen, w_abs_gen and nwalk must equal the
JAX package's sharded trace (started from its own sharded state, cut
into ranks by convert.sharded_walk_from_numpy) and the port's serial
trace to 1e-10 relative in float64 state (block-ELL row slices through
the SpMV's plain version) and 2e-5 in float32 state (dense row slices),
where only the order of the sums differs.  Away from that limit the same
seed and world size repeat the trace bit for bit, and a stochastic
4-rank walk of the 4-electron gas lands on its FCI energy."""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from sqmc_tpu.algo import walk as JW
from sqmc_tpu.algo.semistoch import build_trial_wavefunction as j_trial
from sqmc_tpu.parallel import dist as JD
from sqmc_tpu.systems.hubbard.system import make_hubbard_real_system as j_real
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.parallel import dist

torch.set_num_threads(1)

N_DEV = 4
LATTICE = (2, 3, 1.0, 4.0, 2, 2)
KW = dict(mwalk=1024, cap_spawn=2048, n_words=1, tau=1e-2,
          w_abs_target=500.0, nup=2, ndn=2, has_singles=True)
W_BEGIN = 300.0
NSTEP = 5
FCI_HEG4 = 5.729482256
STOCH = dict(cfg=dict(mwalk=256, cap_spawn=1024, tau=5e-3,
                      w_abs_target=1000.0, r_initiator=0.0),
             w_begin=500.0, e_trial=FCI_HEG4, same_seed_steps=25,
             run=dict(nstep=50, nblk=6, nblk_eq=2))
CASES = {"f64_blockell": {}, "f32_dense": dict(f32_state=True)}


def _np_tree(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()
            if hasattr(v, "shape")}


@pytest.fixture(scope="module")
def runs():
    """The JAX package's sharded traces, the port's serial traces, and
    the port's 4-rank results."""
    js = j_real(*LATTICE, pbc=False)
    jt = j_trial(js, eps_var=1e-9, n_psi_t=10 ** 4, n_imp=10 ** 4,
                 verbose=False)
    assert len(jt.imp_up) == 225                 # D = the whole space
    tt = convert.trial_from_npz(jt, device="cpu")
    ts = convert.system_from_numpy(js, device="cpu")
    mesh = JD.make_mesh(N_DEV)
    jax_runs, jax_traces, serial = {}, {}, {}
    for name, opts in CASES.items():
        kw = dict(KW, norb=js.norb, **opts)
        jcfg = JW.WalkConfig(axis_name="d", n_dev=N_DEV, **kw)
        step, jst, jtab = JD.make_sharded_walk(js, jt, jcfg, mesh, W_BEGIN,
                                               float(jt.e_trial))
        jax_runs[name] = dict(
            cfg=dict(kw, axis_name="d", n_dev=N_DEV), w_begin=W_BEGIN,
            e_trial=float(jt.e_trial), nstep=NSTEP, state=_np_tree(jst),
            tables={k: np.asarray(getattr(jtab, k)) for k in (
                "imp_up", "imp_dn", "imp_rows", "imp_cols", "imp_vals",
                "imp_dense", "ct_num_imp", "ct_den_imp")})
        rows = []
        for _ in range(NSTEP):
            jst, st = step(jst, jtab)
            rows.append([float(st[k]) for k in ranks.KEYS])
        jax_traces[name] = np.asarray(rows)
        cfg = TW.WalkConfig(**kw)
        tab = TW.build_walk_tables(ts, tt, cfg)
        state = TW.init_walk_state(cfg, tt, W_BEGIN, float(jt.e_trial), tab)
        gen = torch.Generator().manual_seed(0)
        rows = []
        for _ in range(NSTEP):
            state, st = TW.walk_step(state, tab, cfg, gen)
            rows.append([float(st[k]) for k in ranks.KEYS])
        serial[name] = np.asarray(rows)
    lattice = dict(args=LATTICE, trial=dict(
        psit_up=jt.psit_up, psit_dn=jt.psit_dn, psit_coef=jt.psit_coef,
        e_trial=jt.e_trial, ct_up=jt.ct_up, ct_dn=jt.ct_dn, ct_num=jt.ct_num,
        ct_den=jt.ct_den, imp_up=jt.imp_up, imp_dn=jt.imp_dn,
        h_rows=jt.imp_ham.rows, h_cols=jt.imp_ham.cols,
        h_vals=jt.imp_ham.vals, h_diag=jt.imp_ham.diag))
    outs = dist.spawn(ranks.walks, N_DEV, device="cpu",
                      args=(lattice, jax_runs, STOCH))
    return jax_traces, serial, outs


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_trace_matches_jax_sharded_walk(runs, name):
    jax_traces, _, outs = runs
    rtol = 2e-5 if "f32" in name else 1e-10
    for out in outs:
        np.testing.assert_allclose(out[name], jax_traces[name], rtol=rtol,
                                   atol=0)
        np.testing.assert_array_equal(out[name], outs[0][name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_trace_matches_serial_walk(runs, name):
    _, serial, outs = runs
    rtol = 2e-5 if "f32" in name else 1e-10
    for out in outs:
        np.testing.assert_allclose(out[name + "_own"], serial[name],
                                   rtol=rtol, atol=0)
    assert serial[name][:, 3].min() == 225       # every D det stays resident


def test_sharded_same_seed_repeats_bitwise(runs):
    _, _, outs = runs
    for out in outs:
        np.testing.assert_array_equal(out["same_seed_0"], out["same_seed_1"])
    # a stochastic trace (not the deterministic limit): weights moved
    assert np.ptp(outs[0]["same_seed_0"][:, 2]) > 0


def test_sharded_stochastic_walk_reaches_fci(runs):
    """4 ranks at population ~1,000 on make_heg_system(3, 1.0, 4, 2, 1.6):
    within 6 * max(err, 5e-6) + 2e-5 of FCI (the JAX package's sharded
    gate), no capacity growth, every rank with walkers."""
    _, _, outs = runs
    e, err, grows, _ = outs[0]["stochastic"]
    assert abs(e - FCI_HEG4) < 6 * max(err, 5e-6) + 2e-5, (e, err)
    assert grows == 0
    for out in outs:
        assert out["stochastic"][:3] == outs[0]["stochastic"][:3]
        assert out["stochastic"][3] > 0
