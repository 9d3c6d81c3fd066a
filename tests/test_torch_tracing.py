"""The port's tracing on the CPU: the host spans and counters of
utils/timers.py, the walk's per-generation marks (ops/mark.py's plain
version) and counters, the spans and counters of HCI, Davidson and PT,
and the benchmark's per-layer metrics that read them.  The card's marks
are held to CUDA events in tests/test_torch_cuda.py."""

import io
import math
import re
import types

import numpy as np
import pytest
import torch

from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.davidson import davidson
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.algo.pt import second_order_pt
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
from sqmc_tpu_torch.ops import mark as markmod
from sqmc_tpu_torch.ops.spmv import BlockEllSpmv
from sqmc_tpu_torch.systems.heg.system import make_heg_system
from sqmc_tpu_torch.utils import timers

torch.set_num_threads(1)

WALK_METRICS = ("project_ms_per_gen", "spawn_ms_per_gen",
                "annihilate_ms_per_gen", "fill_ms_per_gen",
                "finalize_ms_per_gen", "replay_gap_ms_per_gen",
                "host_enqueue_ms_per_gen", "spawn_accept", "fresh_per_gen")
SHCI_METRICS = ("hci_select_s", "hci_ham_s", "davidson_s",
                "davidson_matvecs", "spmv_roofline.shci")


@pytest.fixture
def traced():
    """Tracing on, with an empty record; off and empty again after."""
    timers.clear()
    timers.enable()
    yield
    timers.enable(False)
    timers.clear()


def _heg_walk(full_sort_merge=True):
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=40)
    cfg = TW.WalkConfig(mwalk=1024, cap_spawn=4096, norb=s.norb, nup=2,
                        ndn=2, n_words=1, tau=5e-3, w_abs_target=500.0,
                        has_singles=False, f32_state=True, r_initiator=0.5,
                        full_sort_merge=full_sort_merge)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 500.0, trial.e_trial, tables)
    return tables, cfg, st


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

LINE = re.compile(r"^(BEG|END) OF tag CP, REAL TIME +-?[\d.]+ +-?[\d.]+ "
                  r"+-?\d+ +-?\d+, Mem avail [\d.]+$")


def test_tracer_off_records_nothing_and_phase_prints_as_before(monkeypatch):
    """Off (no profiler session, not enabled), a span is the shared null
    context and a count does nothing: nothing is recorded and no profiler
    range is opened.  phase() prints the reference's BEG/END
    lines exactly as before, and nothing under enabled=False."""
    timers.clear()
    assert not timers.tracing()

    def no_range(*a, **k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(timers, "_range", no_range)
    with timers.span("a", n=1) as sp:
        timers.count("x", 3)
        assert sp is None
    buf = io.StringIO()
    with timers.phase("tag", out=buf, name="b"):
        timers.count("y", 1)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 2 and all(LINE.match(x) for x in lines)
    assert lines[0].startswith("BEG") and lines[1].startswith("END")
    quiet = io.StringIO()
    with timers.phase("tag", out=quiet, enabled=False):
        pass
    assert quiet.getvalue() == "" and timers.spans() == []


def test_spans_nest_and_counters_land_on_the_innermost(traced, monkeypatch):
    """On, spans nest with the right parents and times, each opens a
    profiler range of its name, counters land on the innermost open
    span and are dropped outside any span; phase() is a span too."""
    opened = []
    real = timers._range

    def rec(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(timers, "_range", rec)
    timers.count("dropped", 1)
    with timers.span("outer", gens=2) as a:
        timers.count("x", 1)
        with timers.phase("inner tag", enabled=False, name="inner") as _:
            timers.count("x", 5)
            timers.count("y", 2)
        timers.count("x", 1)
    with timers.span("next"):
        pass
    rec_ = timers.spans()
    assert [s.name for s in rec_] == ["outer", "inner", "next"]
    outer, inner, nxt = rec_
    assert outer is a and outer.parent is None and inner.parent is outer
    assert nxt.parent is None
    assert outer.counts == {"gens": 2, "x": 2} and inner.counts == {"x": 5,
                                                                    "y": 2}
    assert outer.start <= inner.start <= inner.end <= outer.end <= nxt.start
    assert inner.within(outer) and not outer.within(inner)
    assert opened == ["outer", "inner", "next"]


def test_a_profiler_session_turns_tracing_on():
    """With no enable(), a torch.profiler session records spans; the
    span's range is in the profiler's events as a host op, not a user
    annotation (which would get a mirror range on the device's timeline
    that a trace reader counts as device work)."""
    timers.clear()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timers.tracing()
        with timers.span("walk.block"):
            torch.ones(4).sum()
    assert not timers.tracing()
    assert [s.name for s in timers.spans()] == ["walk.block"]
    (ev,) = [e for e in prof.events() if e.name == "walk.block"]
    assert not getattr(ev, "is_user_annotation", False)
    timers.clear()


def test_walk_block_span_opens_no_profiler_range():
    """Under a profiler the walk block is recorded as span walk.block
    with its counters, but opens no range in the profiler's trace (it
    would be the parent of every replayed kernel there)."""
    from torch.profiler import ProfilerActivity, profile
    tables, cfg, st = _heg_walk()
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TW.walk_block(st, tables, cfg, 2, torch.Generator().manual_seed(0))
    assert [s.name for s in timers.spans()] == ["walk.block"]
    assert timers.spans()[0].counts == {"gens": 2, "lost": 0}
    assert "walk.block" not in {e.name for e in prof.events()}
    timers.clear()


# ---------------------------------------------------------------------------
# The walk's marks and counters
# ---------------------------------------------------------------------------

def test_mark_plain_writes_the_clock_at_the_slot():
    m = markmod.Marks(3, 4, "cpu")
    m.slot.fill_(2)
    t0 = __import__("time").perf_counter_ns()
    m(1)
    m.last()
    m.slot.fill_(4)
    m(0)                                # past the rows: writes nothing
    buf = m.read(4)
    assert buf[2, 1] >= t0 and buf[2, 2] >= buf[2, 1]
    assert (buf[[0, 1, 3]] == 0).all() and buf[2, 0] == 0
    with pytest.raises(ValueError):
        m(3)
    with pytest.raises(ValueError):
        markmod.mark(m.buf.double(), m.slot, 0)


@pytest.mark.parametrize("path", ["eager", "runner"])
def test_walk_block_writes_every_mark_in_order(traced, path):
    """The eager CPU loop and the step runner's CPU body write all six
    marks of every generation, in order; the five pieces and the gaps
    between generations sum to the block's first-to-last mark time, which
    lies inside the block's span and covers nearly all of it."""
    tables, cfg, st = _heg_walk()
    gen = torch.Generator().manual_seed(0)
    n = 6
    if path == "eager":
        st, stats = TW.walk_block(st, tables, cfg, n, gen)
        (span,) = [s for s in timers.spans() if s.name == "walk.block"]
        assert span.counts == {"gens": n, "lost": 0}
    else:
        TW._replay_block(st, tables, cfg, n, gen)       # capture once
        timers.clear()
        with timers.span("walk.block") as span:
            st, stats = TW._replay_block(st, tables, cfg, n, gen)
    m = TW._LAST_BLOCK["marks"].read(n)
    assert m.shape == (n, TW.N_MARKS) and (m > 0).all()
    flat = m.reshape(-1)
    assert (np.diff(flat) >= 0).all()
    rep = TW.block_report()
    assert rep["gens"] == n
    assert set(rep["piece_ns"]) == set(TW.PIECES) | {"replay_gap"}
    total = sum(rep["piece_ns"].values()) * n
    assert total == pytest.approx(float(m[-1, -1] - m[0, 0]), rel=1e-12)
    assert span.start <= m[0, 0] and m[-1, -1] <= span.end
    assert total >= 0.9 * (span.end - span.start)
    assert 0 < rep["host_enqueue_ms_per_gen"] * 1e6 * n \
        <= span.end - span.start
    for k in ("n_spawn", "n_spawn_ok", "n_fresh"):
        assert rep[k] == float(stats[k].sum())
    TW.release_graphs()


def test_run_walk_prints_the_piece_line(capsys):
    tables, cfg, st = _heg_walk()
    TW.run_walk(None, None, cfg, 5, 1, 1, 500.0, float(st.e_trial),
                tables=tables, state=st, verbose=True)
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("Generation pieces")]
    assert len(line) == 1
    for p in TW.PIECES + ("replay_gap", "wall", "host_enqueue",
                          "spawn_accept", "fresh/gen"):
        assert f" {p}=" in line[0]


def _dets(up, dn, n):
    return {(int(u), int(d)) for u, d in zip(up[:n, 0], dn[:n, 0])}


@pytest.mark.parametrize("merge", ["full_sort", "two_level"])
def test_spawn_and_fresh_counters_equal_independent_counts(merge,
                                                           monkeypatch):
    """n_spawn_ok is the count of spawn slots that reach the merge with a
    nonzero weight (read from the merge's own arguments), and n_fresh the
    count of output dets that no input walker held."""
    tables, cfg, st = _heg_walk(full_sort_merge=merge == "full_sort")
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):                       # a settled population
        st, _ = TW._walk_step_impl(st, tables, cfg, gen)
    name = "_full_sort_merge" if merge == "full_sort" else "_two_level_merge"
    seen = {}
    orig = getattr(TW, name)

    def spy(state, cfg_, tables_, gen_, alive, wt_par, su, sd, sw, ok, *a):
        seen["ok"] = int((ok & (sw != 0)).sum())
        return orig(state, cfg_, tables_, gen_, alive, wt_par, su, sd, sw,
                    ok, *a)
    monkeypatch.setattr(TW, name, spy)
    new, stats = TW._walk_step_impl(st, tables, cfg, gen)
    assert seen["ok"] > 0 and float(stats["n_spawn_ok"]) == seen["ok"]
    assert float(stats["n_spawn_ok"]) <= float(stats["n_spawn"])
    fresh = _dets(new.up, new.dn, int(new.nwalk)) \
        - _dets(st.up, st.dn, int(st.nwalk))
    assert len(fresh) > 0 and float(stats["n_fresh"]) == len(fresh)
    assert stats["n_spawn_ok"].dtype == stats["n_fresh"].dtype == torch.float64


# ---------------------------------------------------------------------------
# HCI, Davidson, PT
# ---------------------------------------------------------------------------

def test_hci_and_pt_spans_and_counters(traced):
    """A tiny HEG run_hci + second_order_pt records hci.run with one
    hci.iteration a pass (select, ham, davidson inside), Davidson's
    counters on hci.davidson, and pt.run with its candidates and
    connected dets; select + ham + davidson plus the iterations' own time
    is the hci.run span within 1 ms."""
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    res = run_hci(s, eps_var=1e-3, eps_var_sched=[1e-3] * 5, verbose=False)
    e2, n_conn = second_order_pt(s, res.up, res.dn, res.wts[:, 0],
                                 float(res.energies[0]), 1e-5, verbose=False)
    sp = timers.spans()
    (run,) = [x for x in sp if x.name == "hci.run"]
    iters = [x for x in sp if x.name == "hci.iteration"]
    assert len(iters) >= 2 and all(x.parent is run for x in iters)
    for name in ("hci.select", "hci.ham", "hci.davidson"):
        found = [x for x in sp if x.name == name]
        assert found and all(x.parent.name == "hci.iteration" for x in found)
    dav = [x for x in sp if x.name == "hci.davidson"]
    assert sum(x.counts.get("matvecs", 0) for x in dav) > 0
    assert sum(x.counts.get("davidson_iters", 0) for x in dav) > 0
    inside = sum(x.seconds for x in iters)
    assert 0 <= run.seconds - inside < 1e-3
    (pt,) = [x for x in sp if x.name == "pt.run"]
    assert pt.counts["pt_connected"] == n_conn > 0
    assert pt.counts["pt_candidates"] >= n_conn - len(res.up) > 0
    assert math.isfinite(e2)


def test_spmv_counters_of_the_davidson_matvec(traced):
    """BlockEllSpmv counts each call's rows, stored entries and vectors
    on the open span, from host-side shapes."""
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    res = run_hci(s, eps_var=1e-3, eps_var_sched=[1e-3] * 5, verbose=False)
    H = build_sparse_ham(s.table, res.up, res.dn, s.nup, s.ndn, s.norb)
    mv = BlockEllSpmv(H)
    timers.clear()
    with timers.span("hci.davidson") as sp:
        evals, _ = davidson(H, 1, tol=1e-8, matvec_fn=mv)
        mv(torch.ones(H.n, 2, dtype=torch.float64))
    c = sp.counts
    nnz = 2 * len(H.vals) + H.n           # both triangles and the diagonal
    assert c["spmv_calls"] == c["matvecs"] + 1 and c["spmv_calls"] > 1
    assert c["spmv_rows"] == H.n * c["spmv_calls"]
    assert c["spmv_nnz"] == nnz * c["spmv_calls"]
    assert c["spmv_cols"] == c["spmv_calls"] + 1
    assert c["davidson_iters"] > 0


# ---------------------------------------------------------------------------
# The benchmark's readers
# ---------------------------------------------------------------------------

def _read(name, run):
    from benchmark import registry
    return registry.metric(name).read(run)


def test_readers_return_none_on_an_older_program(monkeypatch):
    """A program without block_report, a cell whose last block lacks
    the new counters, and no recorded solve: every new reader returns
    None and raises nothing."""
    monkeypatch.delattr(TW, "block_report")
    last = {k: torch.ones(3, dtype=torch.float64)
            for k in ("e_num_gen", "n_spawn", "nwalk")}
    run = {"kind": "walk", "trace": {"units": 3, "rows": {}},
           "driver": types.SimpleNamespace(last=last)}
    for m in WALK_METRICS:
        assert _read(m, run) is None, m
    timers.clear()
    shci = {"kind": "shci", "trace": {"rows": {"k_spmv": (5.0, 1)}},
            "driver": object()}
    for m in SHCI_METRICS:
        assert _read(m, shci) is None, m
    for m in WALK_METRICS:
        assert _read(m, shci) is None, m
    for m in SHCI_METRICS:
        assert _read(m, run) is None, m


def test_spmv_roofline_shci_reads_the_counted_calls(traced):
    """The SHCI roofline: the counted calls' bytes at float32 over the
    k_spmv rows' time; None when the rows are not as many as the calls."""
    from benchmark.yardstick import kernel_bytes, peaks
    with timers.span("hci.run"):
        with timers.span("hci.davidson"):
            for n, nnz in ((1000, 50_000), (3000, 200_000)):
                for c, v in (("spmv_calls", 1), ("spmv_rows", n),
                             ("spmv_nnz", nnz), ("spmv_cols", 1)):
                    timers.count(c, v)
    run = {"kind": "shci", "trace": {"rows": {"k_spmv_x": (40.0, 2)}}}
    b1, f1 = kernel_bytes.spmv(1000, 50_000, 4)
    b2, f2 = kernel_bytes.spmv(3000, 200_000, 4)
    want = 100 * peaks.bound_us(b1 + b2, f1 + f2, "float32")[0] / 40.0
    assert _read("spmv_roofline.shci", run) == pytest.approx(want)
    run["trace"]["rows"] = {"k_spmv_x": (40.0, 3)}
    assert _read("spmv_roofline.shci", run) is None


@pytest.fixture(scope="module")
def tiny_runs():
    """The benchmark's tiny traced CPU runs of one walk cell and the SHCI
    cell (benchmark/checks/bench_tiny.py)."""
    from benchmark.checks import bench_tiny
    timers.clear()
    out = {c: bench_tiny.run(c, trace=True)
           for c in ("c2.walk", "heg14.shci")}
    timers.clear()
    return out


def test_readers_give_numbers_on_the_tiny_traced_run(tiny_runs):
    """Each new walk metric reads a finite number in the tiny traced walk,
    spawn_accept in (0, 100]; the SHCI span metrics read positive numbers
    in the tiny traced solve.  spmv_roofline.shci reads the card's k_spmv
    rows, and the tiny solve (277 dets) keeps Davidson on the COO
    matvec: it is left out there."""
    walk = tiny_runs["c2.walk"]["metrics"]
    for m in WALK_METRICS:
        assert m in walk and math.isfinite(walk[m]["value"]), m
    assert 0 < walk["spawn_accept"]["value"] <= 100
    assert walk["fresh_per_gen"]["value"] > 0
    pieces = [walk[m]["value"] for m in WALK_METRICS[:6]]
    assert all(p >= 0 for p in pieces) and sum(pieces) > 0
    shci = tiny_runs["heg14.shci"]["metrics"]
    for m in SHCI_METRICS[:4]:
        assert m in shci and shci[m]["value"] > 0, m
    assert "spmv_roofline.shci" not in shci
