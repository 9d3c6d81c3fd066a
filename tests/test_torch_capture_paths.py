"""The port's last one-card eager loops through the captured-step runner
(sqmc_tpu_torch/utils/cudagraph.py), on the CPU.

On the card the dense engine's block, the VMC sweep, the CPMC block's
steps and the walk under the sequential initiator rule replay captured
CUDA graphs; on a CPU state the same runner runs each body eagerly over
the same static buffers (nothing is captured).  These tests hold that
runner to each path's eager loop bit for bit (state, trace and the
generator's state after it), across an equilibration switch and a
release_node block that crosses release_step; hold the runner's dense
deterministic-limit trace to the JAX package (1e-10); and hold the plain
version of the sequential initiator combine (ops/seqinit.py, the CPU path
of the kernel K5) to the JAX package's lax.scan exactly.  The card tests
of the captures and of K5 are in tests/test_torch_cuda.py (marker
`cuda`).  Small sizes, one torch thread."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo import densewalk as jdw
from sqmc_tpu.algo import walk as JW
from sqmc_tpu.systems.toy import make_fictitious_system as j_fictitious
from sqmc_tpu_torch.algo import densewalk as tdw
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.convert import (dense_state_from_numpy,
                                    dense_tables_from_numpy,
                                    toy_system_from_numpy)
from sqmc_tpu_torch.ops import seqinit
from sqmc_tpu_torch.systems.heg.system import make_heg_system
from sqmc_tpu_torch.systems.hubbard import cpmc as tcp
from sqmc_tpu_torch.systems.hubbard import meanfield as tmf
from sqmc_tpu_torch.systems.hubbard import vmc as tvmc

torch.set_num_threads(1)


def _same(a, b, what):
    """Two NamedTuple states (or dicts of stats) equal bit for bit."""
    items = a._asdict().items() if hasattr(a, "_asdict") else a.items()
    other = b._asdict() if hasattr(b, "_asdict") else b
    assert list(dict(items)) == list(other), what
    for k, x in items:
        y = other[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), (what, k)
        else:
            assert x == y, (what, k, x, y)


# ---------------------------------------------------------------------------
# The dense engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fermi():
    """Sign-problem fictitious matrix (bosonic=0), in both packages."""
    j = j_fictitious(16, bosonic=0, spectrum_coef=1.0, spectrum_power=1.0,
                     ham_diag_fluc=0.5, ham_offdiag_fluc=1.5,
                     seed=(1, 2, 3, 5))
    return j, toy_system_from_numpy(j, device="cpu")


def _guide(j):
    """A guiding vector with the wrong nodes in places: violators exist."""
    g = j.diagonalize()[1]
    rng = np.random.default_rng(0)
    g = g + 0.25 * rng.standard_normal(g.shape) * np.abs(g).mean()
    g[np.abs(g) < 1e-3] = 1e-3
    return g


DENSE_TYPES = ["none", "fixed_node1", "fixed_node2", "fixed_node3",
               "fixed_node4", "partial_node", "release_node", "sr", "vmc"]


def _dense(fermi, run_type, exponential, min_wt=0.25, jax_too=False):
    j, t = fermi
    g = _guide(j)
    psi_t = j.diagonalize()[1]
    kw = dict(ndet=j.ndet, tau=0.02, w_abs_target=1000.0, run_type=run_type,
              importance_sampling=0 if run_type == "none" else 1,
              partial_node_eps=0.6, release_step=7, min_wt=min_wt,
              sr_nwalk=600, use_exponential_projector=exponential)
    cfg = tdw.DenseWalkConfig(**kw)
    if jax_too:
        cj = jdw.DenseWalkConfig(**kw)
        tj = jdw.build_dense_tables(j, cj, psi_t, g)
        sj = jdw.init_dense_state(cj, psi_t, g, 700.0, -0.3, seed=0)
        return (cj, tj, sj), (cfg, dense_tables_from_numpy(tj, device="cpu"),
                              dense_state_from_numpy(sj, device="cpu"))
    tables = tdw.build_dense_tables(t, cfg, psi_t, g)
    state = tdw.init_dense_state(cfg, psi_t, g, 700.0, -0.3, seed=4,
                                 device="cpu")
    return cfg, tables, state


@pytest.mark.parametrize("exponential", [False, True],
                         ids=["linear", "exponential"])
@pytest.mark.parametrize("run_type", DENSE_TYPES)
def test_dense_runner_equals_eager_loop(fermi, run_type, exponential):
    """Three blocks of 5 generations through the runner equal the eager
    loop bit for bit: the state (w, the 0-dim sums, the host's step count
    and flags, the generator's state) and every stat.  The third block is
    equilibrated; release_node's second block crosses release_step (7)."""
    cfg, tables, st = _dense(fermi, run_type, exponential)
    a, b = st, st
    for blk in range(3):
        if blk == 2:
            a, b = (x._replace(equilibrated=True) for x in (a, b))
        a, sa = tdw._dense_walk_block_eager(a, tables, cfg, 5)
        b, sb = tdw._replay_dense_block(b, tables, cfg, 5)
        _same(a, b, f"state, block {blk}")
        _same(sa, sb, f"stats, block {blk}")
        a, b = tdw.end_of_dense_block(a), tdw.end_of_dense_block(b)
    assert b.step == 15 and float(b.w_abs_gen) > 100
    tdw.release_graphs()


def test_dense_release_node_block_splits_at_release_step(fermi):
    """A block of 10 from step 3 with release_step 7: the runner replays
    the fixed-node graph 4 times and the released graph 6 times, and the
    result is the eager loop's; the next block reuses the released graph."""
    cfg, tables, st = _dense(fermi, "release_node", False)
    a, _ = tdw._dense_walk_block_eager(st, tables, cfg, 3)
    b = a
    a, sa = tdw._dense_walk_block_eager(a, tables, cfg, 10)
    b, sb = tdw._replay_dense_block(b, tables, cfg, 10)
    _same(a, b, "state")
    _same(sa, sb, "stats")
    graphs = tdw._GRAPHS.graphs
    assert sorted(graphs) == [(False, False), (False, True)]
    assert graphs[(False, False)].replays == 4
    assert graphs[(False, True)].replays == 6
    a, _ = tdw._dense_walk_block_eager(a, tables, cfg, 5)
    b, _ = tdw._replay_dense_block(b, tables, cfg, 5)
    _same(a, b, "state after")
    assert graphs[(False, True)].replays == 11 and len(graphs) == 2
    # a walk started again on the same tables reuses the fixed-node graph
    # (captured in a block that went on past release_step): still fixed-node
    a, sa = tdw._dense_walk_block_eager(st, tables, cfg, 10)
    b, sb = tdw._replay_dense_block(st, tables, cfg, 10)
    _same(a, b, "state, again")
    _same(sa, sb, "stats, again")
    assert graphs[(False, False)].replays == 11
    tdw.release_graphs()


def test_dense_equilibration_switch_takes_its_own_graph(fermi):
    """The step reads the host's equilibrated flag: the runner keys a graph
    on it, and the state it returns carries the caller's flag and step
    count, not the capture's."""
    cfg, tables, st = _dense(fermi, "fixed_node1", False)
    b, _ = tdw._replay_dense_block(st, tables, cfg, 4)
    assert b.step == 4 and not b.equilibrated
    b, _ = tdw._replay_dense_block(b._replace(equilibrated=True), tables,
                                   cfg, 4)
    assert b.step == 8 and b.equilibrated
    graphs = tdw._GRAPHS.graphs
    assert sorted(graphs) == [(False, False), (True, False)]
    a = tdw._dense_walk_block_eager(st, tables, cfg, 4)[0]
    a = tdw._dense_walk_block_eager(a._replace(equilibrated=True), tables,
                                    cfg, 4)[0]
    _same(a, b, "state")
    tdw.release_graphs()
    assert not tdw._GRAPHS.graphs


@pytest.mark.parametrize("name", ["none", "fixed_node2", "release_node",
                                  "vmc", "exponential"])
def test_dense_runner_deterministic_limit_matches_jax(fermi, name):
    """min_wt = 0 (no draw): the runner's trace follows the JAX package's
    dense_walk_block to 1e-10, through an equilibration switch."""
    import jax.numpy as jnp
    run_type, expo = (("none", True) if name == "exponential"
                      else (name, False))
    (cj, tj, sj), (ct, tt, st) = _dense(fermi, run_type, expo, min_wt=0.0,
                                        jax_too=True)
    for iblk in range(3):
        if iblk == 2:
            sj = sj._replace(equilibrated=jnp.asarray(True))
            st = st._replace(equilibrated=True)
        sj, stats_j = jdw.dense_walk_block(sj, tj, cj, 6)
        st, stats_t = tdw._replay_dense_block(st, tt, ct, 6)
        assert st.step == int(sj.step) == 6 * (iblk + 1)
        scale = max(1.0, float(np.abs(np.asarray(sj.w)).max()))
        np.testing.assert_allclose(st.w.numpy(), np.asarray(sj.w), rtol=0,
                                   atol=1e-10 * scale)
        for k in ("e_num_gen", "e_den_gen", "w_abs_gen", "e_gen"):
            np.testing.assert_allclose(stats_t[k].numpy(),
                                       np.asarray(stats_j[k]), rtol=1e-10,
                                       atol=1e-10, err_msg=k)
        for f in ("e_trial", "e_est", "reweight_factor_inv"):
            a, b = float(getattr(st, f)), float(getattr(sj, f))
            assert abs(a - b) < 1e-10 * max(1.0, abs(b)), (f, iblk)
    tdw.release_graphs()


def test_run_dense_walk_frees_its_graphs(fermi):
    """run_dense_walk on the CPU runs the eager loop and leaves no graph."""
    _, t = fermi
    w, g = t.diagonalize()
    cfg = tdw.DenseWalkConfig(ndet=t.ndet, tau=0.02, w_abs_target=500.0)
    out = tdw.run_dense_walk(t, cfg, g, g, nstep=5, nblk=3, nblk_eq=1,
                             w_abs_begin=300.0, seed=1)
    assert out.state.step == 15 and not tdw._GRAPHS.graphs


# ---------------------------------------------------------------------------
# VMC and CPMC
# ---------------------------------------------------------------------------

LX, LY, T, U = 3, 2, 1.0, 4.0


@pytest.fixture(scope="module")
def vmc_setup():
    pu, pd, _ = tmf.hartree_fock(LX, LY, T, U, 2, 2, pbc=True, m=0.2)
    st = tvmc.init_vmc(pu, pd, LX, LY, n_walkers=24, seed=3, device="cpu")
    nbr = torch.as_tensor(tvmc.neighbor_table(LX, LY, True),
                          dtype=torch.int64)
    return (torch.as_tensor(pu), torch.as_tensor(pd), nbr), st


def test_vmc_sweep_runner_equals_eager(vmc_setup):
    """Four sweeps of 10 steps through the runner (one replay a sweep)
    equal the eager sweep bit for bit, with the inverse refresh of run_vmc
    loaded into the static buffers between them; the graph is captured
    once."""
    (pu, pd, nbr), st = vmc_setup
    args = (pu, pd, nbr, 0.7, U, T, 10, LX * LY)
    a, b = st, st
    for sweep in range(4):
        a, ea = tvmc._vmc_sweep_eager(a, *args)
        b, eb = tvmc._replay_sweep(b, *args)
        _same(a, b, f"state, sweep {sweep}")
        assert torch.equal(ea, eb)
        if sweep == 1:
            a, b = (x._replace(minv_up=torch.linalg.inv(pu[x.r_up]),
                               minv_dn=torch.linalg.inv(pd[x.r_dn]))
                    for x in (a, b))
    assert tvmc._GRAPH.graphs[None].replays == 4
    assert not torch.equal(b.r_up, st.r_up)
    tvmc.release_graphs()


def test_run_vmc_frees_its_graph():
    pu, pd, _ = tmf.hartree_fock(2, 2, T, U, 2, 1, pbc=True, m=0.2)
    e, err = tvmc.run_vmc(2, 2, T, U, 2, 1, 0.8, phi_up=pu, phi_dn=pd,
                          n_walkers=16, n_sweeps=6, n_eq=2, seed=1,
                          device="cpu")
    assert np.isfinite(e) and not tvmc._GRAPH.graphs


def test_cpmc_block_runner_equals_eager():
    """Two blocks of 6 steps through the runner equal the eager loop bit
    for bit (walkers, log weights, alive flags, the generator's state) and
    so does each block's mixed energy; the comb between blocks stays on
    the host."""
    cfg = tcp.CpmcConfig(LX, LY, T, U, 2, 1, tau=0.05, n_walkers=12)
    setup, st = tcp.init_cpmc(cfg, seed=2, device="cpu")
    a, b = st, st
    for blk in range(2):
        a, ea = tcp._cpmc_block_eager(a, setup, cfg, 6)
        b = tcp._replay_steps(b, setup, cfg, 6)
        eb = tcp._mixed_energy(b, setup, cfg)
        _same(a, b, f"state, block {blk}")
        assert torch.equal(ea, eb) and bool(torch.isfinite(eb))
        idx = torch.as_tensor(np.arange(12)[::-1].copy())
        a, b = (x._replace(phi_up=x.phi_up[idx], phi_dn=x.phi_dn[idx])
                for x in (a, b))
    assert tcp._GRAPH.graphs[None].replays == 12
    tcp.release_graphs()


def test_cpmc_block_on_cpu_is_the_eager_loop():
    """cpmc_block on the CPU: the eager loop, no graph kept; run_cpmc
    leaves none."""
    cfg = tcp.CpmcConfig(2, 2, T, U, 1, 1, tau=0.05, n_walkers=8)
    setup, st = tcp.init_cpmc(cfg, seed=0, device="cpu")
    a, ea = tcp.cpmc_block(st, setup, cfg, 3)
    b, eb = tcp._cpmc_block_eager(st, setup, cfg, 3)
    _same(a, b, "state")
    assert torch.equal(ea, eb) and not tcp._GRAPH.graphs
    tcp.run_cpmc(cfg, n_blocks=2, nstep=2, n_eq=1, device="cpu")
    assert not tcp._GRAPH.graphs


# ---------------------------------------------------------------------------
# The sequential initiator rule (K5's plain version) and its walk
# ---------------------------------------------------------------------------

def _seq_rows(seed, wdt):
    """Groups of 1 to 500 rows (every size 1-12, then 50, 137, 500, then
    random sizes), weights mixing exact ties, zeros and floats whose
    running sums round, initiators 0-3 (3 permanent)."""
    rng = np.random.default_rng(seed)
    sizes = list(range(1, 13)) + [50, 137, 500] + \
        list(rng.integers(1, 40, 60))
    rng.shuffle(sizes)
    n = int(sum(sizes))
    starts = np.zeros(n, bool)
    starts[np.cumsum([0] + sizes[:-1])] = True
    ties = rng.choice([-2.0, -1.0, 1.0, 2.0, 0.0], n)
    floats = rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e3], n)
    wts = np.where(rng.random(n) < 0.5, ties, floats).astype(wdt)
    inits = rng.integers(0, 4, n).astype(np.int32)
    return starts, wts, inits


def _zero_rows(case, wdt):
    """Zero-heavy merge rows for the skip of the zero-weight runs (starts,
    weights, initiators; row 0 starts a group, as in the walk):
    walk_like   the walk's merge scaled down ~100x: 1,360 rows of occupied
                dets in short groups (dead walkers' zero rows among them),
                then one group of 5,680 empty slots, all of weight 0;
    cancel_runs small integer weights, so that running sums cancel exactly
                and zero runs follow, with every initiator before them;
    neg_zero    -0.0 and +0.0 weights, at starts and inside groups;
    zero_starts group starts of weight 0 (initiators 0-3);
    ends_on_zeros  groups whose last rows are zero-weight;
    all_zero    every weight zero;
    nan_gaps    groups that start with weight 0 (initiator 1 or 2), then
                zero rows or none, then a NaN weight: the one row whose
                result z of the carry at a gap decides (a NaN compares
                false, so the rule keeps the carried initiator);
    n1          one row."""
    rng = np.random.default_rng(sum(map(ord, case)))
    inits = None
    if case == "walk_like":
        occ, empty = 1360, 5680
        starts = np.zeros(occ + empty, bool)
        starts[:occ] = rng.random(occ) < 0.4
        starts[occ] = True
        ties = rng.choice([-2.0, -1.0, 1.0, 2.0], occ)
        floats = rng.standard_normal(occ) * rng.choice([1e-3, 1.0, 1e3], occ)
        w = np.where(rng.random(occ) < 0.5, ties, floats)
        w[rng.random(occ) < 0.15] = 0.0
        wts = np.concatenate([w, np.zeros(empty)])
    elif case == "cancel_runs":
        n = 6000
        starts = rng.random(n) < 0.08
        wts = rng.choice([-2.0, -1.0, 1.0, 2.0], n)
        wts[rng.random(n) < 0.35] = 0.0
    elif case == "neg_zero":
        n = 3000
        starts = rng.random(n) < 0.2
        wts = rng.choice([-0.0, 0.0, -1.0, 1.0, 0.5, -2.0], n)
    elif case == "zero_starts":
        n = 3000
        starts = rng.random(n) < 0.3
        wts = rng.choice([-1.0, 1.0, 3.0], n) * rng.random(n)
        wts[starts & (rng.random(n) < 0.7)] = 0.0
        wts[rng.random(n) < 0.2] = 0.0
    elif case == "ends_on_zeros":
        sizes = rng.integers(2, 30, 200)
        n = int(sizes.sum())
        first = np.cumsum(sizes) - sizes
        starts = np.zeros(n, bool)
        starts[first] = True
        wts = rng.standard_normal(n)
        for a, size, z in zip(first, sizes, rng.integers(1, 10, 200)):
            wts[a + max(size - z, 1):a + size] = 0.0
    elif case == "all_zero":
        n = 2000
        starts = rng.random(n) < 0.1
        wts = np.zeros(n)
    elif case == "nan_gaps":
        groups = [[0.0] + [0.0] * int(rng.integers(0, 3)) + [np.nan, 1.0]
                  for _ in range(300)]
        starts = np.concatenate([[True] + [False] * (len(g) - 1)
                                 for g in groups])
        wts = np.concatenate(groups)
        inits = np.where(starts, rng.integers(1, 3, len(wts)),
                         rng.integers(0, 4, len(wts))).astype(np.int32)
    else:                                       # n1
        starts, wts, inits = (np.array([True]), np.array([0.0]),
                              np.array([2], np.int32))
    starts[0] = True
    if inits is None:
        inits = rng.integers(0, 4, starts.shape[0]).astype(np.int32)
    return starts, wts.astype(wdt), inits


ZERO_CASES = ["walk_like", "cancel_runs", "neg_zero", "zero_starts",
              "ends_on_zeros", "all_zero", "nan_gaps", "n1"]


def _jax_seq(starts, wts, inits):
    import jax.numpy as jnp
    return np.asarray(JW.sequential_initiator_scan(
        jnp.asarray(starts), jnp.asarray(wts), jnp.asarray(inits),
        jnp.dtype(wts.dtype)))


@pytest.mark.parametrize("case", [0, 1, 2] + ZERO_CASES)
@pytest.mark.parametrize("wdt", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_seqinit_plain_matches_jax_scan(wdt, case):
    """ops/seqinit.py's plain version (the CPU path of K5), which skips the
    zero-weight rows that start no group, equals the JAX package's
    sequential_initiator_scan (every row, no skip) exactly, in the walk's
    two weight types: mixed rows (seeds 0-2: a code-3 row is never demoted,
    an exact cancellation gives 0) and the zero-heavy rows of
    _zero_rows, each with the corner it is there for."""
    rows = _seq_rows(case, wdt) if isinstance(case, int) else \
        _zero_rows(case, wdt)
    starts, wts, inits = rows
    got = seqinit.sequential_initiator(
        *(torch.as_tensor(x) for x in rows)).numpy()
    ref = _jax_seq(*rows)
    assert got.dtype == np.int32 and got.shape == starts.shape
    np.testing.assert_array_equal(got, ref)
    prev = np.roll(got, 1)
    zero = (wts == 0) & ~starts
    if isinstance(case, int):             # the rule's corner cases occur
        assert ((~starts) & (prev == 3) & (got == 3)).any()
        assert ((~starts) & (got == 0) & (inits > 0)).any()
    elif case == "walk_like":
        assert zero[1360:].sum() == 5679 and zero[:1360].any()
    elif case == "cancel_runs":
        # an exact cancellation followed by a zero run, after every
        # running initiator 0-3
        gid = np.cumsum(starts)
        csum = np.array([wts[gid == g].astype(np.float64).cumsum()
                         for g in np.unique(gid)], dtype=object)
        run = np.concatenate(csum)
        cancel = (~starts) & (wts != 0) & (run == 0) & np.roll(zero, -1)
        assert set(prev[cancel]) == {0, 1, 2, 3}
    elif case == "neg_zero":
        nz = np.signbit(wts) & (wts == 0)
        assert (nz & starts).any() and (nz & ~starts).any()
    elif case == "zero_starts":
        assert ((wts == 0) & starts & (inits > 0)).sum() > 100
    elif case == "ends_on_zeros":
        assert (zero & np.roll(starts, -1)).sum() > 150
    elif case == "nan_gaps":               # z at the gap, kept by the NaN
        nan = np.isnan(wts)
        gap = nan & (np.roll(wts, 1) == 0) & ~np.roll(starts, 1)
        assert gap.any() and (nan & ~gap).any()
        assert (got[gap] == 0).all() and (got[nan & ~gap] > 0).all()
    elif case == "all_zero":               # z of each group's start
        head = inits[np.flatnonzero(starts)][np.cumsum(starts) - 1]
        assert not wts.any()
        np.testing.assert_array_equal(got, np.where(
            starts | (head == 3), head, 0))


def test_seqinit_plain_passes_number_the_longest_active_group():
    """The plain version ranks only the active rows: its passes number the
    longest group of ACTIVE rows less one (a handful at the walk-like
    rows), not the longest group (the 5,680 empty slots)."""
    starts, wts, inits = _zero_rows("walk_like", np.float32)
    stats = {}
    seqinit.sequential_initiator_plain(
        torch.as_tensor(starts), torch.as_tensor(wts),
        torch.as_tensor(inits), stats=stats)
    active = starts | (wts != 0)
    gid = np.cumsum(starts)
    longest_active = np.bincount(gid[active]).max()
    assert stats["active"] == active.sum()
    assert stats["passes"] == longest_active - 1
    assert longest_active < 60 and np.bincount(gid).max() == 5680


def test_seqinit_cases_by_hand():
    """Cancellation to 0, a permanent initiator through a tie and a sign
    flip, a one-row group, and row 0 starting a group whatever neq says."""
    t = torch.as_tensor
    got = seqinit.sequential_initiator(
        t([False, False, True, False, False, True, True]),
        t([1.0, -1.0, 2.0, -2.0, 5.0, 0.5, -0.25]),
        t([2, 1, 3, 1, 2, 1, 2], dtype=torch.int32))
    assert got.tolist() == [2, 0, 3, 3, 3, 1, 2]


def test_seqinit_dispatch_raises_off_cpu_and_cuda():
    x = torch.ones(3, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no path"):
        seqinit.sequential_initiator(
            x, torch.ones(3, device="meta"),
            torch.ones(3, dtype=torch.int32, device="meta"))


def _seq_walk():
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=40)
    cfg = TW.WalkConfig(mwalk=2048, cap_spawn=4096, cap_fresh=1024,
                        norb=s.norb, nup=2, ndn=2, n_words=1,
                        w_abs_target=1000.0, tau=5e-3, has_singles=False,
                        f32_state=True, r_initiator=0.5,
                        initiator_rule="sequential")
    tables = TW.build_walk_tables(s, trial, cfg)
    return tables, cfg, TW.init_walk_state(cfg, trial, 750.0, trial.e_trial,
                                           tables)


def test_sequential_rule_walk_through_runner_equals_eager():
    """The walk under initiator_rule="sequential" through the runner (what
    the card replays, K5 inside) equals the eager loop bit for bit over
    two blocks, generator state included; the runner counts K5's
    launches beside the other kernels'."""
    tables, cfg, st = _seq_walk()
    g_eager, g_graph = (torch.Generator().manual_seed(5) for _ in "ab")
    a, b = st, st
    for _ in range(2):
        a, sa = TW._walk_block_eager(a, tables, cfg, 8, g_eager)
        b, sb = TW._replay_block(b, tables, cfg, 8, g_graph)
        _same(a, b, "state")
        _same(sa, sb, "stats")
        assert torch.equal(g_eager.get_state(), g_graph.get_state())
    graph = TW._GRAPH[next(iter(TW._GRAPH))]
    assert seqinit in graph.counters
    assert int(b.nwalk) > 10
    TW.release_graphs()
