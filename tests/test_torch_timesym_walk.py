"""The port's time-reversal symmetrized walk against the JAX package's,
on the 6-orbital random system of tests/test_time_sym_walk.py.

With the deterministic space D equal to the whole symmetrized space of
the sector, every spawn lands in D and is discarded by the merge, so a
generation is exact power iteration in the symmetrized basis and
independent of the random stream: the port's per-generation trace must
equal JAX's to 1e-10 relative, for z = +1 (closed-shell start) and z = -1
(open-shell start).  This covers the diagonal cross term z <i|H|rev i>
of the initial state, the symmetrized D-space H of build_walk_tables and
the orientation of every spawn (a target left off its representative
would live outside D and change nwalk); the spawn weights (sqrt2 norms,
z signs) are held by the stochastic walk of test_torch_timesym.py."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo import semistoch as JS
from sqmc_tpu.algo import walk as JW
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import semistoch as TS
from sqmc_tpu_torch.algo import walk as TW
from test_torch_timesym import _u64, same_trial, walk_system_pair

torch.set_num_threads(2)

WKW = dict(mwalk=1024, cap_spawn=4096, n_words=1, tau=5e-3,
           w_abs_target=500.0, has_singles=True)
KEYS = ("e_num_gen", "e_den_gen", "w_abs_gen", "nwalk")


@pytest.mark.parametrize("z", [1, -1])
def test_walk_deterministic_trace_time_sym(z):
    """The port's own trial (HCI at eps 1e-9 over the whole sector) is
    JAX's and its energy is the sector's exact e0 to 1e-8; the port's
    initial state is JAX's; 10 generations from JAX's state equal JAX's
    eager walk_step; run_walk reaches e0 to 1e-8."""
    js, ts, e0 = walk_system_pair(z)
    jt = JS.build_trial_wavefunction(js, eps_var=1e-9, n_psi_t=400,
                                     n_imp=400)
    mine = TS.build_trial_wavefunction(ts, eps_var=1e-9, n_psi_t=400,
                                       n_imp=400)
    same_trial(mine, jt)
    assert abs(mine.e_trial - e0) < 1e-8
    if z < 0:           # the z = -1 sector holds no self-symmetric det
        assert not (_u64(mine.imp_up) == _u64(mine.imp_dn)).all(1).any()
    tt = convert.trial_from_npz(jt, device="cpu")

    jcfg = JW.WalkConfig(norb=6, nup=2, ndn=2, time_sym=True, z=z, **WKW)
    jtab = JW.build_walk_tables(js, jt, cfg=jcfg)
    jst = JW.init_walk_state(jcfg, jt, 500.0, e0, tables=jtab)
    conv = convert.walk_state_from_numpy(jst, device="cpu")
    cfg = TW.WalkConfig(norb=6, nup=2, ndn=2, time_sym=True, z=z,
                        cap_fresh=512, **WKW)
    tables = TW.build_walk_tables(ts, tt, cfg)
    own = TW.init_walk_state(cfg, tt, 500.0, e0, tables)
    for f in ("up", "dn", "init", "imp", "ct"):
        assert torch.equal(getattr(own, f), getattr(conv, f)), f
    for f in ("wt", "diag"):
        np.testing.assert_allclose(getattr(own, f).numpy(),
                                   getattr(conv, f).numpy(), rtol=1e-14,
                                   atol=1e-12)

    st = conv
    gen = torch.Generator().manual_seed(0)
    got, ref = [], []
    for _ in range(10):
        st, stats = TW.walk_step(st, tables, cfg, gen)
        got.append([float(stats[k]) for k in KEYS])
        jst, jstats = JW.walk_step(jst, jtab, jcfg)
        ref.append([float(jstats[k]) for k in KEYS])
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)
    out = TW.run_walk(ts, tt, cfg, nstep=30, nblk=2, nblk_eq=1,
                      w_abs_begin=500.0, e_trial_initial=e0, verbose=False)
    assert abs(out.e_mixed - e0) < 1e-8


def test_walk_time_sym_must_match_system():
    js, ts, e0 = walk_system_pair(1)
    tt = TS.build_trial_wavefunction(ts, eps_var=1e-3, n_psi_t=5, n_imp=5)
    with pytest.raises(ValueError, match="time_sym"):
        TW.build_walk_tables(ts, tt, TW.WalkConfig(norb=6, nup=2, ndn=2,
                                                   **WKW))
    with pytest.raises(ValueError, match="sector"):
        TW.WalkConfig(norb=6, nup=2, ndn=2, time_sym=True, z=0, **WKW)
