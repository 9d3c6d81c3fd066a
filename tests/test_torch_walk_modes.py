"""The port's other projectors and merges in the deterministic limit,
against the JAX package's walk_step.

With the deterministic space D equal to the whole HF-connected space every
spawn lands in D and is discarded by the merge, so a generation is the
exact (importance-transformed, fixed-node) projection and does not depend
on the random stream: the port must reproduce JAX's per-generation trace
to 1e-10 relative.  Run types that REDIRECT sign violators to the parent
(fixed_node1/4, partial_node, release_node before its release step) keep
a stochastic part even here (the redirected spawn is not discarded), so
their traces are compared where no violator exists (the open chain,
whose free-fermion guiding function is nodeless in the ordered basis)
and their stochastic parts are held to dense oracles in
tests/test_torch_walk_fixed_node.py.  The merges are also compared
directly on random rows, and the sequential initiator rule against the
pairwise reference of tests/test_initiator_sequential.py."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo import walk as JW
from sqmc_tpu.algo.guiding import make_gutzwiller_guiding as j_gutz
from sqmc_tpu.algo.semistoch import build_trial_wavefunction as j_trial
from sqmc_tpu.systems.hubbard.system import make_hubbard_real_system as j_real
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.ops import seqinit

torch.set_num_threads(1)

KW = dict(mwalk=1024, cap_spawn=2048, n_words=1, tau=1e-2,
          w_abs_target=500.0, nup=2, ndn=2, has_singles=True)
KEYS = ("e_num_gen", "e_den_gen", "w_abs_gen", "nwalk")
NSTEP = 5


def _setup(l_x, l_y):
    js = j_real(l_x, l_y, 1.0, 4.0, 2, 2, pbc=False)
    jg = j_gutz(js, g=0.7)
    jt = j_trial(js, eps_var=1e-9, n_psi_t=10 ** 4, n_imp=10 ** 4,
                 verbose=False)
    return (js, jg, jt, convert.system_from_numpy(js, device="cpu"),
            convert.guiding_from_numpy(jg, device="cpu"),
            convert.trial_from_npz(jt, device="cpu"))


@pytest.fixture(scope="module")
def lattice():
    """2x3 open lattice: the transformed flow has sign violators."""
    return _setup(2, 3)


@pytest.fixture(scope="module")
def chain():
    """1x6 open chain: no sign violators (fixed-node is exact)."""
    return _setup(1, 6)


def _traces(setup, nstep=NSTEP, **opts):
    """(port trace, JAX trace, port tables) over nstep generations from the
    JAX package's initial state."""
    js, jg, jt, ts, tg, tt = setup
    kw = dict(KW, norb=js.norb, **opts)
    guided = kw.get("guiding", "none") != "none"
    jcfg = JW.WalkConfig(**kw)
    jtab = JW.build_walk_tables(js, jt, guide=jg if guided else None, cfg=jcfg)
    jst = JW.init_walk_state(jcfg, jt, 300.0, float(jt.e_trial),
                             guide=jg if guided else None, tables=jtab)
    tcfg = TW.WalkConfig(**kw)
    ttab = TW.build_walk_tables(ts, tt, tcfg, guide=tg if guided else None)
    tst = convert.walk_state_from_numpy(jst, device="cpu")
    mine = TW.init_walk_state(tcfg, tt, 300.0, float(jt.e_trial), ttab)
    # the port's own initial state (weights x psi_g, |.| for fixed-node)
    assert torch.equal(mine.up, tst.up) and torch.equal(mine.imp, tst.imp)
    np.testing.assert_allclose(mine.wt.numpy(), tst.wt.numpy(), rtol=1e-12,
                               atol=1e-15)
    gen = torch.Generator().manual_seed(0)
    got, ref = [], []
    for _ in range(nstep):
        tst, st = TW.walk_step(tst, ttab, tcfg, gen)
        got.append([float(st[k]) for k in KEYS])
        jst, jstats = JW.walk_step(jst, jtab, jcfg)
        ref.append([float(jstats[k]) for k in KEYS])
    return np.asarray(got), np.asarray(ref), ttab


LATTICE_CASES = {
    "importance_sampled": dict(guiding="gutzwiller"),
    "fixed_node2": dict(guiding="gutzwiller", run_type="fixed_node2"),
    "fixed_node3": dict(guiding="gutzwiller", run_type="fixed_node3"),
    "released": dict(guiding="gutzwiller", run_type="release_node",
                     release_step=0),
    "partial_node_eps0": dict(guiding="gutzwiller", run_type="partial_node",
                              partial_node_eps=0.0),
    "ct_in_d": dict(ct_in_d=True),
    "ct_in_d_guided": dict(ct_in_d=True, guiding="gutzwiller"),
    "two_level": dict(full_sort_merge=False, cap_new=256),
    "two_level_guided": dict(full_sort_merge=False, guiding="gutzwiller",
                             run_type="fixed_node3"),
    "sequential": dict(initiator_rule="sequential"),
    "f32_dense_fixed_node3": dict(guiding="gutzwiller", run_type="fixed_node3",
                                  f32_state=True),
}


@pytest.mark.parametrize("name", sorted(LATTICE_CASES))
def test_deterministic_trace_matches_jax(lattice, name):
    """1e-10 relative on e_num_gen, e_den_gen, w_abs_gen and nwalk over 5
    generations (f64 state: only summation order differs); the f32-state
    case 2e-5 (float32 matvec and weights on both sides, summed in
    different orders)."""
    opts = LATTICE_CASES[name]
    got, ref, ttab = _traces(lattice, **opts)
    rtol = 2e-5 if opts.get("f32_state") else 1e-10
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
    if opts.get("run_type") in ("fixed_node2", "fixed_node3"):
        # this lattice does have violators: the fixed-node matrix differs
        # from the importance-sampled one
        _, _, plain = _traces(lattice, nstep=0, guiding="gutzwiller")
        assert (plain.imp_vals.to(torch.float64)
                - ttab.imp_vals.to(torch.float64)).abs().max() > 1e-3


@pytest.mark.parametrize("run_type,extra", [
    ("fixed_node1", {}), ("fixed_node4", {}),
    ("partial_node", dict(partial_node_eps=0.6)),
    ("release_node", dict(release_step=3))])
def test_redirecting_run_types_on_nodeless_chain(chain, run_type, extra):
    """On the open chain the transformed off-diagonal flow is <= 0
    everywhere, so no spawn is redirected and the trace is deterministic:
    1e-10 relative against JAX, for each redirecting run type."""
    got, ref, ttab = _traces(chain, guiding="gutzwiller", run_type=run_type,
                             **extra)
    off = ttab.imp_rows != ttab.imp_cols
    assert float(ttab.imp_vals[off].max()) <= 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


def test_ct_in_d_trace_is_the_gather_trace_shifted(lattice):
    """The C(T)-in-D estimator reads the step's INPUT state: with the
    population control switched off its (e_num, e_den) trace is the gather
    path's, one generation late (1e-12 relative)."""
    js, jg, jt, ts, tg, tt = lattice
    traces = {}
    for ct_in_d in (False, True):
        cfg = TW.WalkConfig(**dict(KW, norb=ts.norb, ct_in_d=ct_in_d,
                                   pop_ctrl_exponent=0.0))
        tab = TW.build_walk_tables(ts, tt, cfg)
        st = TW.init_walk_state(cfg, tt, 500.0, float(jt.e_trial), tab)
        st = st._replace(equilibrated=torch.tensor(True),
                         reached_target=torch.tensor(True))
        gen = torch.Generator().manual_seed(0)
        rows = []
        for _ in range(6):
            st, stats = TW.walk_step(st, tab, cfg, gen)
            rows.append([float(stats["e_num_gen"]), float(stats["e_den_gen"])])
        traces[ct_in_d] = np.asarray(rows)
    np.testing.assert_allclose(traces[True][1:], traces[False][:-1],
                               rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the merges on random rows
# ---------------------------------------------------------------------------

def _random_merge_input(seed, M=256, CAP=512, norb=8):
    """A sorted walker list (D dets at weight 0 among them) and random
    spawns: hits on resident dets, new dets with duplicates, D->D spawns,
    redirected spawns (imp 126), invalid slots."""
    rng = np.random.default_rng(seed)
    pool = np.array([(u, d) for u in range(1, 2 ** norb) for d in range(1, 40)
                     if bin(u).count("1") == 2 and bin(d).count("1") == 2])
    pool = pool[rng.permutation(len(pool))]
    n_w = 150
    wk = pool[:n_w]
    wk = wk[np.lexsort((wk[:, 1], wk[:, 0]))]
    up = np.full((M, 1), -1, np.int64)
    dn = np.full((M, 1), -1, np.int64)
    up[:n_w, 0], dn[:n_w, 0] = wk[:, 0], wk[:, 1]
    imp = np.full(M, 10 ** 6, np.int32)
    imp[:n_w] = rng.choice([0, -2, 1, 2, 5], n_w, p=[.2, .1, .3, .2, .2])
    wt = np.zeros(M)
    wt[:n_w] = rng.choice([-2.0, -1.0, -0.25, 0.0, 0.25, 1.0, 3.0], n_w)
    init = np.zeros(M, np.int32)
    init[:n_w] = rng.integers(0, 3, n_w)
    tgt = pool[rng.integers(0, 260, CAP)]           # ~58% hits, many repeats
    ok = rng.random(CAP) < 0.8
    c_imp = rng.choice([-1, 2, 3, 126], CAP).astype(np.int32)
    c_init = rng.integers(0, 2, CAP).astype(np.int32)
    s_wt = rng.choice([-1.5, -0.5, 0.5, 1.0], CAP)
    t = torch.as_tensor
    state = dict(up=t(up), dn=t(dn), wt=t(wt), init=t(init), imp=t(imp),
                 diag=torch.zeros(M, dtype=torch.float64),
                 ct=torch.full((M,), -1, dtype=torch.int64),
                 nwalk=torch.tensor(n_w, dtype=torch.int32))
    okt = t(ok)
    sp = dict(
        spawn_up=torch.where(okt[:, None], t(tgt[:, :1]), -1),
        spawn_dn=torch.where(okt[:, None], t(tgt[:, 1:]), -1),
        spawn_wt=torch.where(okt, t(s_wt), 0.0), spawn_ok=okt,
        child_imp=torch.where(okt, t(c_imp), 10 ** 6).to(torch.int32),
        child_init=torch.where(okt, t(c_init), 0).to(torch.int32))
    return state, sp


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("r_initiator", [0.0, 1.0])
def test_two_level_merge_equals_full_sort(lattice, seed, r_initiator):
    """Both annihilation strategies on the same rows with min_wt = 0 (no
    stochastic rounding): the same sorted det list, initiator flags and
    imp codes exactly, the same weights to 1e-14 (summation order)."""
    js, jg, jt, ts, tg, tt = lattice
    state_d, sp = _random_merge_input(seed)
    M, CAP = 256, 512
    # any tables and scalar state will do: the merges read the integral
    # table (fresh dets' diagonals) and the C(T) list only
    cfg6 = TW.WalkConfig(**dict(KW, norb=ts.norb))
    tab = TW.build_walk_tables(ts, tt, cfg6)
    st = TW.init_walk_state(cfg6, tt, 300.0, 0.0, tab)._replace(**state_d)
    tab = tab._replace(table=_table8())
    alive = torch.arange(M) < st.nwalk
    outs = []
    for full in (True, False):
        cfg = TW.WalkConfig(**dict(KW, norb=8, mwalk=M, cap_spawn=CAP,
                                   min_wt=0.0, r_initiator=r_initiator,
                                   full_sort_merge=full, cap_new=CAP,
                                   cap_fresh=M))
        merge = TW._full_sort_merge if full else TW._two_level_merge
        outs.append(merge(st, cfg, tab, torch.Generator().manual_seed(0),
                          alive, st.wt.clone(), sp["spawn_up"], sp["spawn_dn"],
                          sp["spawn_wt"], sp["spawn_ok"], sp["child_imp"],
                          sp["child_init"], torch.tensor(False)))
    a, b = outs
    n = int(a[7])
    assert n == int(b[7]) and 0 < n < M and not bool(a[8]) and not bool(b[8])
    for i in (0, 1, 3, 4):                       # up, dn, init, imp
        assert torch.equal(a[i][:n], b[i][:n]), i
    np.testing.assert_allclose(a[2][:n].numpy(), b[2][:n].numpy(), rtol=0,
                               atol=1e-14)
    assert (a[0][n:] == -1).all() and (b[0][n:] == -1).all()


def _table8():
    """An 8-orbital integral table for the merge test's fresh-det fill."""
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_real_system
    return make_hubbard_real_system(1, 8, 1.0, 4.0, 2, 2, pbc=False,
                                    with_heatbath=False, device="cpu").table


# ---------------------------------------------------------------------------
# the sequential initiator rule
# ---------------------------------------------------------------------------

def _reference_rule(starts, wts, inits):
    """Pairwise sequential combine, one group at a time (do_walk.f90:5897;
    the transcription of tests/test_initiator_sequential.py)."""
    out = np.zeros(len(wts), np.int32)
    acc_w, acc_i = 0.0, 0
    for i in range(len(wts)):
        if starts[i]:
            acc_w, acc_i = float(wts[i]), int(inits[i])
        else:
            w, ini = float(wts[i]), int(inits[i])
            if acc_w * w > 0:
                acc_i = max(acc_i, ini)
            elif acc_i != 3:
                if abs(acc_w) < abs(w):
                    acc_i = ini
                elif abs(acc_w) == abs(w):
                    acc_i = 0
            acc_w += w
        out[i] = acc_i
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p_start", [0.3, 0.02])
def test_sequential_scan_matches_pairwise_rule(seed, p_start):
    """Random groups (short ones, and long ones of ~50 rows) with sign
    mixes, exact ties, zeros and permanent initiators: equal to the
    pairwise reference and to the JAX package's lax.scan, exactly."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    n = 512
    starts = rng.random(n) < p_start
    starts[0] = True
    wts = rng.choice([-2.0, -1.0, 1.0, 2.0, 3.0, 0.0], n).astype(np.float32)
    inits = rng.integers(0, 4, n).astype(np.int32)
    got = seqinit.sequential_initiator(
        torch.as_tensor(starts), torch.as_tensor(wts),
        torch.as_tensor(inits)).numpy()
    np.testing.assert_array_equal(got, _reference_rule(starts, wts, inits))
    ref = np.asarray(JW.sequential_initiator_scan(
        jnp.asarray(starts), jnp.asarray(wts), jnp.asarray(inits), jnp.float32))
    np.testing.assert_array_equal(got, ref)


def test_sequential_scan_permanent_and_order():
    """A permanent initiator survives a tie and a sign flip; the rule is
    order dependent where group-max is not (the cases of
    tests/test_initiator_sequential.py)."""
    t = torch.as_tensor
    got = seqinit.sequential_initiator(
        t([True, False, False, True, False]),
        t([1.0, -1.0, -2.0, 1.0, -1.0]), t([3, 1, 1, 2, 1], dtype=torch.int32))
    assert got[2] == 3 and got[4] == 0
    rows = [(1.0, 2), (-2.0, 0), (3.0, 1)]

    def run(order):
        return int(seqinit.sequential_initiator(
            t([True, False, False]), t([rows[i][0] for i in order]),
            t([rows[i][1] for i in order], dtype=torch.int32))[-1])

    assert run([0, 1, 2]) == 1 and run([2, 0, 1]) == 2
