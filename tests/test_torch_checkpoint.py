"""Walker checkpoints of the port: one npz layout for both packages (det
words as uint64), so a state saved by either loads in the other, and a
walk resumed from a checkpoint continues exactly as the uninterrupted
one."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo import walk as JW
from sqmc_tpu.algo.semistoch import build_trial_wavefunction as j_trial
from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
from sqmc_tpu.utils import checkpoint as JC
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.utils import checkpoint as TC

torch.set_num_threads(1)

KW = dict(mwalk=512, cap_spawn=2048, n_words=1, tau=5e-3, w_abs_target=400.0,
          nup=2, ndn=2, has_singles=False, r_initiator=0.0)
ARRAYS = ("up", "dn", "wt", "init", "imp", "diag", "ct")
SCALARS = ("nwalk", "e_trial", "e_est", "tau", "reweight_factor_inv",
           "reached_target", "equilibrated", "e_num_blkabs_cum",
           "e_den_blkabs_cum", "e_num_blk", "e_den_blk", "w_abs_gen", "step")


@pytest.fixture(scope="module")
def heg():
    js = j_heg(3, 1.0, 4, 2, 1.6)
    jt = j_trial(js, eps_var=1e-3, n_psi_t=30, n_imp=10, verbose=False)
    return (js, jt, convert.system_from_numpy(js, device="cpu"),
            convert.trial_from_npz(jt, device="cpu"))


def _walked(heg, f32=False, nstep=7):
    js, jt, ts, tt = heg
    cfg = TW.WalkConfig(norb=ts.norb, cap_fresh=512, f32_state=f32, **KW)
    tab = TW.build_walk_tables(ts, tt, cfg)
    st = TW.init_walk_state(cfg, tt, 300.0, float(jt.e_trial), tab)
    st, _ = TW.walk_block(st, tab, cfg, nstep, torch.Generator().manual_seed(5))
    return cfg, tab, st


def _same(a, b):
    for f in ARRAYS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in SCALARS:
        assert getattr(a, f).item() == getattr(b, f).item(), f


@pytest.mark.parametrize("f32", [False, True])
def test_round_trip_in_the_port(heg, tmp_path, f32):
    """save -> load gives back every field bit for bit, in both state
    precisions, with and without the .npz suffix."""
    cfg, _, st = _walked(heg, f32)
    st = st._replace(rng_state=torch.Generator().manual_seed(9).get_state())
    TC.save_walker_state(str(tmp_path / "w"), st)
    for name in ("w", "w.npz"):
        back = TC.load_walker_state(str(tmp_path / name), cfg, device="cpu")
        _same(st, back)
        assert back.wt.dtype == (torch.float32 if f32 else torch.float64)
        assert torch.equal(back.rng_state, st.rng_state)
    z = np.load(tmp_path / "w.npz")
    assert z["up"].dtype == np.uint64 and z["ct"].dtype == np.int32


def test_port_checkpoint_loads_in_jax(heg, tmp_path):
    """A state saved by the port loads through the JAX package's loader
    and steps there: the next generation's deterministic quantities agree
    with the port's own next step (population before spawning is the same
    state, so w_abs of the loaded state is equal)."""
    js, jt, ts, tt = heg
    cfg, tab, st = _walked(heg)
    TC.save_walker_state(str(tmp_path / "from_port"), st)
    jcfg = JW.WalkConfig(norb=js.norb, **KW)
    jst = JC.load_walker_state(str(tmp_path / "from_port"), jcfg)
    back = convert.walk_state_from_numpy(jst, device="cpu")
    _same(st, back)
    jtab = JW.build_walk_tables(js, jt, cfg=jcfg)
    jst2, stats = JW.walk_step(jst, jtab, jcfg)
    assert np.isfinite(float(stats["e_num_gen"])) and int(jst2.step) == int(st.step) + 1


def test_jax_checkpoint_loads_in_port(heg, tmp_path):
    """A state saved by the JAX package loads in the port with the same
    fields (the PRNG key is dropped) and walks on."""
    js, jt, ts, tt = heg
    jcfg = JW.WalkConfig(norb=js.norb, **KW)
    jtab = JW.build_walk_tables(js, jt, cfg=jcfg)
    jst = JW.init_walk_state(jcfg, jt, 300.0, float(jt.e_trial), tables=jtab)
    for _ in range(3):
        jst, _ = JW.walk_step(jst, jtab, jcfg)
    JC.save_walker_state(str(tmp_path / "from_jax"), jst)
    want = convert.walk_state_from_numpy(jst, device="cpu")
    cfg = TW.WalkConfig(norb=ts.norb, cap_fresh=512, **KW)
    got = TC.load_walker_state(str(tmp_path / "from_jax"), cfg, device="cpu")
    _same(want, got)
    assert got.rng_state is None
    tab = TW.build_walk_tables(ts, tt, cfg)
    nxt, stats = TW.walk_step(got, tab, cfg, torch.Generator().manual_seed(0))
    assert np.isfinite(float(stats["e_num_gen"])) and int(nxt.step) == 4


def test_resume_continues_the_uninterrupted_walk(heg, tmp_path):
    """run_walk with checkpoint_file writes the state after every block;
    a second run_walk resumed from the file after block 2 gives block 3's
    energy and final state exactly as the uninterrupted three-block run
    (the generator state rides in the checkpoint)."""
    js, jt, ts, tt = heg
    cfg = TW.WalkConfig(norb=ts.norb, cap_fresh=512, **KW)
    e0 = float(jt.e_trial)
    ck = str(tmp_path / "walk_ck")
    full = TW.run_walk(ts, tt, cfg, nstep=20, nblk=2, nblk_eq=1,
                       w_abs_begin=300.0, e_trial_initial=e0, verbose=False,
                       max_eq_extensions=0, seed=11)
    TW.run_walk(ts, tt, cfg, nstep=20, nblk=1, nblk_eq=1, w_abs_begin=300.0,
                e_trial_initial=e0, verbose=False, max_eq_extensions=0,
                seed=11, checkpoint_file=ck)
    mid = TC.load_walker_state(ck, cfg, device="cpu")
    assert int(mid.step) == 40 and mid.rng_state is not None
    assert float(mid.e_num_blk) == 0.0            # the block was rolled
    rest = TW.run_walk(ts, tt, cfg, nstep=20, nblk=1, nblk_eq=0,
                       w_abs_begin=300.0, e_trial_initial=e0, verbose=False,
                       max_eq_extensions=0, seed=999, resume_state=mid)
    assert rest.e_blocks[0] == full.e_blocks[1]
    _same(full.state, rest.state)
    np.testing.assert_array_equal(rest.w_abs_trace, full.w_abs_trace[40:])
