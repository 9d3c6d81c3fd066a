"""The walk's spawn histogram (sqmc_tpu_torch/ops/spawnhist.py) on the CPU:
its plain version against the JAX package's one-hot sum and against the
rule in numpy, on random and boundary weights, and inside the walk's
finalize.  The kernel (csrc/spawnhist.cu) is held to the plain version on
the card by tests/test_torch_cuda.py.

The JAX side is written out here from sqmc_tpu/algo/walk.py:2633-2644;
nothing in sqmc_tpu changes.  Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_spawnhist_cases as cases

from sqmc_tpu.algo import walk as JW
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.ops import spawnhist
from sqmc_tpu_torch.systems.heg.system import make_heg_system

torch.set_num_threads(1)


@jax.jit
def _jax_hist(spawn_wt, spawn_ok):
    """The JAX generation's histogram of |spawn weight|."""
    aw_sp = jnp.abs(spawn_wt)
    hbin = jnp.clip(jnp.floor(jnp.log2(jnp.maximum(aw_sp, JW.TINY))) + 20.0,
                    0, JW.N_HIST_BINS - 1).astype(jnp.int32)
    hbin = jnp.where(spawn_ok & (aw_sp > 0), hbin, JW.N_HIST_BINS)
    return jnp.sum(jax.nn.one_hot(hbin, JW.N_HIST_BINS, dtype=jnp.float32),
                   axis=0).astype(jnp.int32)


def _plain(wt, ok):
    return spawnhist.spawn_histogram_plain(torch.as_tensor(wt),
                                           torch.as_tensor(ok)).numpy()


def _old_chain(spawn_wt, spawn_ok):
    """The finalize's histogram as algo/walk.py computed it inline before
    it moved into ops/spawnhist.py."""
    aw = spawn_wt.abs()
    hbin = (torch.floor(torch.log2(aw.clamp(min=TW.TINY))) + 20.0).clamp(
        0, TW.N_HIST_BINS - 1).to(torch.int64)
    hbin = torch.where(spawn_ok & (aw > 0), hbin, TW.N_HIST_BINS)
    hist = torch.zeros(TW.N_HIST_BINS + 1, dtype=torch.int64,
                       device=spawn_wt.device)
    hist.scatter_add_(0, hbin, torch.ones_like(hbin))
    return hist[:TW.N_HIST_BINS]


def test_spawn_hist_constants_are_the_jax_packages():
    assert spawnhist.N_HIST_BINS == TW.N_HIST_BINS == JW.N_HIST_BINS
    assert spawnhist.TINY == TW.TINY == JW.TINY == cases.TINY


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 7, 100_003])
def test_spawn_hist_plain_matches_jax_one_hot(dt, n):
    """Random weights of both signs over 2^-26 .. 2^24 (past both clamp
    edges), a tenth of them zero and a third of the flags off: the plain
    version's counts equal the JAX one-hot sum's and numpy's."""
    rng = np.random.default_rng(n)
    wt = (2.0 ** rng.uniform(-26.0, 24.0, n)
          * rng.choice([-1.0, 1.0], n)).astype(dt)
    wt[rng.random(n) < 0.1] = 0
    ok = rng.random(n) < 0.67
    got = _plain(wt, ok)
    assert got.dtype == np.int64 and got.shape == (spawnhist.N_HIST_BINS,)
    np.testing.assert_array_equal(got, np.asarray(_jax_hist(wt, ok)))
    np.testing.assert_array_equal(got, cases.numpy_bins(wt, ok))
    assert got.sum() == int((ok & (wt != 0)).sum())


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_spawn_hist_plain_on_boundary_weights(dt):
    """Each boundary value alone: the plain version's bin equals numpy's
    (a correctly rounded log2).  0, -0.0, NaN and every row with its flag
    off count nowhere; TINY, subnormals and everything below 2^-20 go to
    bin 0; 2^19 and above, inf included, to bin 39; 2^k and one ulp above
    it to bin k + 20.  The JAX package's XLA log2 is not correctly rounded
    next to a power of two: it moves some powers of two and their
    neighbours one ulp away by one bin; and it counts a subnormal nowhere
    (XLA flushes it to zero on the CPU).  Those are the only rows where its
    one-hot sum differs."""
    wt, ok = cases.boundary_weights(dt)
    jax_diff = []
    normal = np.finfo(dt).smallest_normal
    for w, f in zip(wt, ok):
        got = _plain(np.array([w]), np.array([f]))
        np.testing.assert_array_equal(
            got, cases.numpy_bins(np.array([w]), np.array([f])))
        aw = abs(float(w))
        if not f or not aw > 0:
            assert got.sum() == 0, w
            continue
        b = int(np.argmax(got))
        assert got.sum() == 1 and got[b] == 1, w
        if aw < 2.0 ** -20:
            assert b == 0, w
        elif aw >= 2.0 ** 19:
            assert b == 39, w
        else:
            m, e = np.frexp(aw)                # aw = m 2^e, m in [0.5, 1)
            if m == 0.5 or np.nextafter(dt(m), dt(0)) == dt(0.5):
                assert b == e - 1 + 20, w      # 2^k and one ulp above
            else:
                assert b in (e - 1 + 20, e + 20), w
        ref = np.asarray(_jax_hist(np.array([w]), np.array([f])))
        if np.array_equal(got, ref):
            continue
        jax_diff.append(float(w))
        m, _ = np.frexp(dt(aw))
        if aw < normal:
            assert ref.sum() == 0, w
        else:
            assert (m == 0.5 or np.nextafter(m, dt(1)) == dt(1.0)
                    or np.nextafter(m, dt(0)) == dt(0.5)), w
            assert ref.sum() == 1 and abs(int(np.argmax(ref)) - b) == 1, w
    # and the whole set at once, in both orders
    want = cases.numpy_bins(wt, ok)
    np.testing.assert_array_equal(_plain(wt, ok), want)
    np.testing.assert_array_equal(_plain(wt[::-1].copy(), ok[::-1].copy()),
                                  want)


def test_spawn_hist_plain_is_the_finalizes_old_chain():
    """The discard-heavy finalize at a small CAP: the moved code gives the
    inline chain's counts."""
    rng = np.random.default_rng(5)
    for dt in (np.float32, np.float64):
        wt, ok = cases.discard_heavy(rng, 50_001, dt)
        w, f = torch.as_tensor(wt), torch.as_tensor(ok)
        assert torch.equal(spawnhist.spawn_histogram(w, f),
                           _old_chain(w, f))


def test_spawn_hist_dispatch():
    """A CPU tensor takes the plain version (no launch counted); another
    device raises."""
    w = torch.tensor([1.0, -3.0, 0.0])
    f = torch.tensor([True, True, True])
    before = spawnhist.launches
    got = spawnhist.spawn_histogram(w, f)
    assert spawnhist.launches == before
    assert int(got[20]) == 1 and int(got[21]) == 1 and int(got.sum()) == 2
    with pytest.raises(ValueError):
        spawnhist.spawn_histogram(w.to("meta"), f.to("meta"))


@pytest.fixture(scope="module")
def small_walk():
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=40)
    return s, trial


@pytest.mark.parametrize("f32", [True, False])
def test_finalize_spawn_hist_equals_the_old_chain(small_walk, f32,
                                                  monkeypatch):
    """Ten generations of a small walk: every generation's histogram, the
    trace's n_spawn_ok and the block's spawn_hist equal what the inline
    chain gives on the same spawn weights and flags."""
    s, trial = small_walk
    cfg = TW.WalkConfig(mwalk=2048, cap_spawn=4096, cap_fresh=1024,
                        norb=s.norb, nup=2, ndn=2, n_words=1,
                        w_abs_target=1000.0, tau=5e-3, has_singles=False,
                        f32_state=f32, r_initiator=0.5)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 750.0, trial.e_trial, tables)
    seen = []
    inner = spawnhist.spawn_histogram

    def recorded(wt, ok):
        out = inner(wt, ok)
        seen.append((wt.clone(), ok.clone(), out.clone()))
        return out

    monkeypatch.setattr(spawnhist, "spawn_histogram", recorded)
    _, stats = TW._walk_block_eager(st, tables, cfg, 10,
                                    torch.Generator().manual_seed(3))
    assert len(seen) == 10
    old = []
    for wt, ok, out in seen:
        assert wt.dtype == (torch.float32 if f32 else torch.float64)
        ref = _old_chain(wt, ok)
        assert torch.equal(out, ref)
        old.append(ref)
    old = torch.stack(old)
    assert torch.equal(stats["spawn_hist"], old.sum(0))
    assert torch.equal(stats["n_spawn_ok"], old.sum(1).to(torch.float64))
    assert int(old.sum()) > 0
