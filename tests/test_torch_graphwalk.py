"""The captured walk's runner (sqmc_tpu_torch/utils/cudagraph.py) on the
CPU.

On the card walk_block replays one captured generation; on a CPU state the
same runner runs its body eagerly over the same static buffers (nothing is
captured).  These tests hold that body to the eager loop bit for bit (the
state arrays, the per-generation trace, the block's spawn histogram and
the generator's state after the block), check the eager-or-graph rule and
the launch-counter arithmetic, and hold the runner's deterministic-limit
trace to the JAX package's walk_step.  The card tests of the capture
itself are in tests/test_torch_cuda.py (marker `cuda`).  Population
~1,000, few generations, one torch thread."""

import types

import numpy as np
import pytest
import torch
from reference_impl import random_integrals

from sqmc_tpu.algo import walk as JW
from sqmc_tpu.algo.semistoch import build_trial_wavefunction as j_trial
from sqmc_tpu.systems.hubbard.system import make_hubbard_real_system as j_real
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.heg.system import make_heg_system
from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system
from sqmc_tpu_torch.utils.cudagraph import StepGraph

torch.set_num_threads(1)

NGEN = 20


def _walk(name):
    """(tables, cfg, state) of a small walk on the CPU at population
    ~1,000: the tiny electron gas (f32 state, dense projection), dense
    random integrals with singles (f64 state, block-ELL projection), or
    the 2x2 Hubbard-k cluster's continuous-time chain."""
    if name == "heg":
        s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
        trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30,
                                         n_imp=40)
        extra = dict(tau=5e-3, has_singles=False, f32_state=True,
                     r_initiator=0.5)
    elif name == "chem":
        h, eri, core, _ = random_integrals(4, seed=5)
        s = make_system_from_arrays(h, eri, core, 2, 2, device="cpu")
        trial = build_trial_wavefunction(s, eps_var=1e-4, n_psi_t=10,
                                         n_imp=8)
        extra = dict(tau=2e-3, has_singles=True, r_initiator=0.5,
                     dense_proj_max=0)
    else:
        s = make_hubbard_k_system(2, 2, 1.0, 4.0, 2, 2, device="cpu")
        trial = build_trial_wavefunction(s, eps_var=1e-6, n_psi_t=36,
                                         n_imp=1)
        extra = dict(tau=0.05, has_singles=s.has_singles, r_initiator=0.0,
                     semistochastic=False, use_exponential_projector=True,
                     ct_mode="hubbardk")
    cfg = TW.WalkConfig(mwalk=2048, cap_spawn=4096, cap_fresh=1024,
                        norb=s.norb, nup=2, ndn=2, n_words=1,
                        w_abs_target=1000.0, **extra)
    tables = TW.build_walk_tables(s, trial, cfg)
    state = TW.init_walk_state(cfg, trial, 750.0, trial.e_trial, tables)
    return tables, cfg, state


@pytest.fixture(scope="module", params=["heg", "chem", "ct_hubbardk"])
def walk(request):
    return _walk(request.param)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _assert_same_state(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f


def _assert_same_stats(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_captured_body_equals_eager_loop(walk):
    """Two blocks of 20 generations through the runner's body (its static
    buffers, the device-side trace index, the summed histogram) equal
    _walk_block_eager bit for bit, and so does the generator's state after
    them: the warm-up and recording steps leave no trace in the stream."""
    tables, cfg, st = walk
    g_eager, g_graph = _gen(), _gen()
    a, b = st, st
    for _ in range(2):
        a, sa = TW._walk_block_eager(a, tables, cfg, NGEN, g_eager)
        b, sb = TW._replay_block(b, tables, cfg, NGEN, g_graph)
        _assert_same_state(a, b)
        _assert_same_stats(sa, sb)
        assert torch.equal(g_eager.get_state(), g_graph.get_state())
    assert int(a.nwalk) > 10 and float(sa["w_abs_gen"][-1]) > 100
    TW.release_graphs()


def test_trace_layout_and_spawn_hist_equal_eager():
    """The block's stats: one [nstep] float64 column per trace key in
    _TRACE_KEYS order, then spawn_hist ([N_HIST_BINS] int64, the block's
    sum), the same keys, shapes and dtypes as the eager loop's."""
    tables, cfg, st = _walk("heg")
    _, se = TW._walk_block_eager(st, tables, cfg, 5, _gen())
    _, sg = TW._replay_block(st, tables, cfg, 5, _gen())
    assert list(sg) == list(TW._TRACE_KEYS) + ["spawn_hist"]
    for k in TW._TRACE_KEYS:
        assert sg[k].shape == (5,) and sg[k].dtype == torch.float64
    assert sg["spawn_hist"].shape == (TW.N_HIST_BINS,)
    assert sg["spawn_hist"].dtype == torch.int64
    assert int(sg["spawn_hist"].sum()) > 0
    _assert_same_stats(se, sg)
    TW.release_graphs()


def test_walk_step_through_runner_equals_eager_step():
    """walk_step's graphed form (copy in, one replay, clones out) called
    three times on one input state, as entry()'s fn is: each call's state
    and every stat equal the eager step's, and the returned tensors are
    the caller's (a later call does not overwrite them)."""
    tables, cfg, st = _walk("chem")
    g_eager, g_graph = _gen(7), _gen(7)
    runner = TW._step_graph(st, tables, cfg, g_graph, 1)
    held = []
    for _ in range(3):
        a, sa = TW._walk_step_impl(st, tables, cfg, g_eager)
        b, sb = runner.step(st)
        _assert_same_state(a, b)
        _assert_same_stats(sa, sb)
        held.append((a, sa, b, sb))
    for a, sa, b, sb in held:
        _assert_same_state(a, b)
        _assert_same_stats(sa, sb)
    TW.release_graphs()


def test_graph_rule_picks_eager_on_cpu_sequential_and_mesh(monkeypatch):
    """The card replays a captured generation under either initiator rule
    (the sequential rule is the kernel K5 on the card, no host sync); the
    CPU and a mesh run the eager loop.  On a CPU state walk_block never
    reaches the runner, whatever the rule."""
    tables, cfg, st = _walk("heg")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TW._graphed(cuda, tables)
    assert not TW._graphed(cpu, tables)
    assert not TW._graphed(cuda, tables._replace(mesh=object()))

    def no_graph(*a, **k):
        raise AssertionError("the CPU reached the captured walk")
    monkeypatch.setattr(TW, "_replay_block", no_graph)
    monkeypatch.setattr(TW, "_step_graph", no_graph)
    TW.walk_block(st, tables, cfg, 2, _gen())
    TW.walk_step(st, tables, cfg, _gen())
    seq = TW.WalkConfig(**{**cfg.__dict__, "initiator_rule": "sequential"})
    TW.walk_block(st, tables, seq, 2, _gen())


class _CountingStep:
    """A stand-in step: adds `per_step` to a kernel module's counter, as a
    wrapper does at each launch, and one to every weight."""

    def __init__(self, per_step):
        self.mod = types.SimpleNamespace(launches=0)
        self.per_step = per_step

    def __call__(self, s):
        self.mod.launches += self.per_step
        new = s._replace(wt=s.wt + 1, step=s.step + 1)
        return new, {"x": new.wt.sum(), "h": torch.ones(3, dtype=torch.int64)}


def test_launch_counters_add_change_times_replays():
    """The counters read what the eager loop would launch: the warm-up and
    the recorded step leave them as they were, a block of n replays adds n
    times the recorded change, a step adds it once."""
    _, _, st = _walk("heg")
    step = _CountingStep(per_step=3)
    step.mod.launches = 11
    g = StepGraph(step, st, _gen(), ("x",), ("h",), counters=(step.mod,),
                  rows=8)
    assert g.delta == [3] and step.mod.launches == 11
    new, trace, sums = g.block(st, 5)
    assert step.mod.launches == 11 + 15 and g.replays == 5
    w, rows = st.wt, []
    for _ in range(5):
        w = w + 1
        rows.append(w.sum().to(torch.float64))
    assert torch.equal(new.wt, w) and int(new.step) == 5
    assert torch.equal(trace[:, 0], torch.stack(rows))
    assert sums["h"].tolist() == [5, 5, 5]
    g.step(st)
    assert step.mod.launches == 11 + 18


def test_runner_recaptures_for_a_grown_walk_and_longer_blocks():
    """One runner per (tables, generator, cfg, device, dtype): the same
    walk reuses it, a block longer than its trace rows or a grown cfg (a
    capacity growth) replaces it, and a block rerun at twice the capacity
    from the grown start state equals the eager rerun."""
    tables, cfg, st = _walk("heg")
    g = _gen()
    TW._replay_block(st, tables, cfg, 4, g)
    first = TW._step_graph(st, tables, cfg, g, 4)
    assert TW._step_graph(st, tables, cfg, g, 4) is first
    longer = TW._step_graph(st, tables, cfg, g, first.rows + 1)
    assert longer is not first and longer.rows == first.rows + 1
    big = TW.WalkConfig(**{**cfg.__dict__, "mwalk": 2 * cfg.mwalk,
                           "cap_spawn": 2 * cfg.cap_spawn,
                           "cap_fresh": 2 * cfg.cap_fresh})
    grown = TW.grow_walk_state(st, big)
    g_eager, g_graph = _gen(5), _gen(5)
    a, sa = TW._walk_block_eager(grown, tables, big, 6, g_eager)
    b, sb = TW._replay_block(grown, tables, big, 6, g_graph)
    assert TW._step_graph(grown, tables, big, g_graph, 6) is not longer
    assert len(TW._GRAPH) == 1
    _assert_same_state(a, b)
    _assert_same_stats(sa, sb)
    TW.release_graphs()
    assert not TW._GRAPH


def test_released_runners_are_freed_without_the_collector():
    """A runner holds no reference cycle (with marks too): once released
    it is freed at once, with Python's cyclic collector off.  On the card
    a runner left for the collector could be collected while another graph
    is recorded, and its destructor would invalidate that capture."""
    import gc
    import weakref
    tables, cfg, st = _walk("heg")
    collecting = gc.isenabled()
    gc.disable()
    try:
        runner = TW._step_graph(st, tables, cfg, _gen(), 2)
        assert runner.marks is not None
        runner.block(st, 2)
        walk_ref = weakref.ref(runner)
        marked = StepGraph(lambda s, mark: _CountingStep(1)(s), st, _gen(),
                           ("x",), rows=2, marks=2)
        marked_ref = weakref.ref(marked)
        del runner, marked
        TW.release_graphs()
        assert walk_ref() is None and marked_ref() is None
    finally:
        if collecting:
            gc.enable()


def test_runner_rejects_a_state_of_other_shape():
    """A state whose arrays differ from the captured ones raises instead
    of being copied into the static buffers by broadcasting or casting,
    and so does a state whose tensors lie on two devices."""
    tables, cfg, st = _walk("heg")
    with pytest.raises(ValueError):
        StepGraph(_CountingStep(1), st._replace(
            rng_state=torch.empty(2, device="meta")), _gen(), ("x",))
    runner = TW._step_graph(st, tables, cfg, _gen(), 2)
    with pytest.raises(ValueError):
        runner.block(st._replace(wt=st.wt.double()), 2)
    with pytest.raises(ValueError):
        runner.block(st._replace(up=st.up[:-1]), 2)
    with pytest.raises(ValueError):
        runner.block(st, runner.rows + 1)
    TW.release_graphs()


KW = dict(mwalk=1024, cap_spawn=2048, n_words=1, tau=1e-2,
          w_abs_target=500.0, nup=2, ndn=2, has_singles=True)


@pytest.mark.parametrize("f32", [False, True])
def test_runner_deterministic_trace_matches_jax(f32):
    """With D the whole space of the 2x3 open Hubbard lattice every spawn
    is discarded, so the generation does not depend on the random stream:
    five generations through the runner's body reproduce the JAX package's
    walk_step trace (e_num, e_den, |w|, nwalk) to 1e-10 relative in f64
    state, 2e-5 in f32 state (float32 matvec and weights summed in other
    orders), as tests/test_torch_walk_modes.py holds the eager step."""
    js = j_real(2, 3, 1.0, 4.0, 2, 2, pbc=False)
    jt = j_trial(js, eps_var=1e-9, n_psi_t=10 ** 4, n_imp=10 ** 4,
                 verbose=False)
    kw = dict(KW, norb=js.norb, f32_state=f32)
    jcfg = JW.WalkConfig(**kw)
    jtab = JW.build_walk_tables(js, jt, cfg=jcfg)
    jst = JW.init_walk_state(jcfg, jt, 300.0, float(jt.e_trial), tables=jtab)
    tcfg = TW.WalkConfig(**kw)
    ttab = TW.build_walk_tables(convert.system_from_numpy(js, device="cpu"),
                                convert.trial_from_npz(jt, device="cpu"), tcfg)
    tst = convert.walk_state_from_numpy(jst, device="cpu")
    _, st = TW._replay_block(tst, ttab, tcfg, 5, _gen(0))
    keys = ("e_num_gen", "e_den_gen", "w_abs_gen", "nwalk")
    got = np.stack([st[k].numpy() for k in keys], 1)
    ref = []
    for _ in range(5):
        jst, jstats = JW.walk_step(jst, jtab, jcfg)
        ref.append([float(jstats[k]) for k in keys])
    np.testing.assert_allclose(got, np.asarray(ref),
                               rtol=2e-5 if f32 else 1e-10, atol=0)
    TW.release_graphs()
