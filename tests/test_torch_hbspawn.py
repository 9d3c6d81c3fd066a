"""The heat-bath proposal op of the port (sqmc_tpu_torch/ops/hbspawn.py,
whose kernel K3b is csrc/hbselect.cu's sqmc_hb_spawn) on the CPU.

The numpy emulation of K3b's documented arithmetic
(tests/torch_spawn_emulation.py) is held bit for bit to the plain version
at the four shapes the kernel is built for (the C2 walk's: 26 orbitals,
4 + 4, singles from sng_pack, float32; HEG-14's without singles; C2 in
float64 with the float64 singles rows; a two-word det), on tables whose
sums are exact in any order, and through whole generations of the
time-symmetrized C2 walk (z = +1 and -1: the proposal's outputs go
through the time-symmetrized mapping, the merge and the finalize).
tests/test_torch_cuda.py holds the kernel to the same emulation on the
card.  The walk's dispatch sends the other proposals, the CT chain and
tables the kernel has no build for to torch code."""

import dataclasses

import numpy as np
import pytest
import torch
import torch_spawn_emulation as se

from sqmc_tpu_torch.algo import walk as W
from sqmc_tpu_torch.ops import hbspawn

torch.set_num_threads(1)

CAP = 8192


def _walkers(state):
    n = int(state.nwalk)
    return state.up[:n].numpy(), state.dn[:n].numpy()


def _emulated(tables, up_w, dn_w, norb, singles, tau, wdt, streams):
    """emulate_hb_spawn on torch tensors, as torch tensors."""
    src = hbspawn.singles_source(tables, singles, wdt)
    out = se.emulate_hb_spawn(se.table_arrays(tables), up_w.numpy(),
                              dn_w.numpy(), norb, src, wdt == torch.float64,
                              float(tau), [u.numpy() for u in streams])
    return tuple(torch.as_tensor(np.ascontiguousarray(x)) for x in out)


def _same_bits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y), f"{int((x != y).sum())} differ"


@pytest.mark.parametrize("case", list(se.SPAWN_CASES))
def test_hb_spawn_emulation_is_plain_bitwise(case, tmp_path):
    """The emulated kernel and propose_plain give the same words, flags
    and factors, bit for bit, on CAP slots: a third random dets (empty ones
    and the walk's all-bits sentinel among them), the rest the walk's own
    dets, with uniforms from a seed.  The tables' selection rows are
    integers and their singles rows dyadic, so the two orders of the sums
    agree; the alias and heat-bath tables are the system's."""
    s, trial, cfg = se.spawn_case(case, "cpu", tmp_path)
    wdt = torch.float32 if cfg.f32_state else torch.float64
    tables = se.exact_sum_tables(W.build_walk_tables(s, trial, cfg))
    assert hbspawn.singles_source(tables, cfg.has_singles, wdt) in (
        hbspawn.NO_SINGLES, hbspawn.PACK, hbspawn.ROWS)
    state = W.init_walk_state(cfg, trial, 1e3, trial.e_trial, tables)
    rng = np.random.default_rng(11)
    up, dn, streams = se.slot_inputs(rng, CAP, s.norb, s.nup, s.ndn,
                                     _walkers(state))
    args = (tables, torch.as_tensor(up), torch.as_tensor(dn), s.norb,
            cfg.has_singles, state.tau, wdt,
            [torch.as_tensor(u) for u in streams])
    plain = hbspawn.propose_plain(*args)
    _same_bits(_emulated(*args), plain)
    _same_bits(hbspawn.propose(*args), plain)     # the CPU's path
    ok = plain[3]
    assert 0.2 < float(ok.double().mean()) < 0.95
    assert bool(torch.isfinite(plain[2]).all())
    if cfg.has_singles:                            # both kinds are drawn
        moved = ((plain[0] != args[1]).sum(1) + (plain[1] != args[2]).sum(1))
        assert int((ok & (moved > 0)).sum()) > CAP // 10


@pytest.mark.parametrize("z", [1, -1])
def test_hb_spawn_emulation_in_time_sym_generations(z, tmp_path,
                                                    monkeypatch):
    """Three generations of the time-symmetrized C2 walk (float64 state,
    singles from the float64 rows) from one state and seed, once with the
    plain proposal and once with the emulated kernel in its place: the
    states and the generations' statistics are equal bit for bit (the
    proposal's outputs pass through the time-symmetrized mapping of the
    targets, the merge and the finalize)."""
    s, trial, cfg = se.spawn_case("c2_f64_rows", "cpu", tmp_path, z=z)
    assert cfg.time_sym and cfg.z == z
    tables = se.exact_sum_tables(W.build_walk_tables(s, trial, cfg))
    start = W.init_walk_state(cfg, trial, 1e3, trial.e_trial, tables)

    def three(propose):
        monkeypatch.setattr(W, "_propose", propose)
        gen = torch.Generator().manual_seed(5)
        st, out = start, []
        for _ in range(3):
            st, stats = W._walk_step_impl(st, tables, cfg, gen)
            out.append(stats)
        return st, out

    plain_propose = W._propose

    def emulated(cfg_, tables_, up_w, dn_w, tau, wdt, streams, gen):
        return _emulated(tables_, up_w, dn_w, cfg_.norb, cfg_.has_singles,
                         tau, wdt, streams)

    a, sa = three(plain_propose)
    b, sb = three(emulated)
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
    for x, y in zip(sa, sb):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert int(a.step) == 3 and float(sa[-1]["n_spawn_ok"]) > 100


def test_hb_spawn_dispatch(tmp_path, monkeypatch):
    """The walk's proposal takes hbspawn.propose (the kernel on the card)
    for every heat-bath proposal, and torch code for the uniform and
    Cauchy-Schwarz proposals; the CT chain calls no proposal.  A table
    without float64 singles rows takes the plain version on the CPU, and
    the card's path raises for it before it launches anything, as it does
    for a pack under a float64 state or rows under a float32 one."""
    s, trial, cfg = se.spawn_case("c2_f32_pack", "cpu", tmp_path)
    calls = []
    real = hbspawn.propose

    def recorded(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(hbspawn, "propose", recorded)
    rng = np.random.default_rng(2)
    streams = [torch.as_tensor(rng.random(64)) for _ in range(5)]
    gen = torch.Generator().manual_seed(0)

    def propose(cfg_, tables):
        st = W.init_walk_state(cfg_, trial, 1e3, trial.e_trial, tables)
        b = torch.as_tensor(rng.integers(0, int(st.nwalk), 64))
        wdt = torch.float32 if cfg_.f32_state else torch.float64
        n = len(calls)
        out = W._propose(cfg_, tables, st.up[b], st.dn[b], st.tau, wdt,
                         streams, gen)
        assert out[2].dtype == torch.float64 and out[3].dtype == torch.bool
        return out if len(calls) > n else None

    for proposal, f32 in (("fast_heatbath", True), ("fast_heatbath", False),
                          ("uniform", True), ("cauchy_schwarz", True)):
        c = dataclasses.replace(cfg, proposal=proposal, f32_state=f32)
        tables = W.build_walk_tables(s, trial, c)
        taken = propose(c, tables) is not None
        assert taken == (proposal == "fast_heatbath"), proposal
    # a table without float64 singles rows (and so no sng_pack): the
    # plain version's elements from the integrals on the CPU; no build
    for f32 in (True, False):
        c = dataclasses.replace(cfg, f32_state=f32)
        tables = W.build_walk_tables(s, trial, c)
        tables = tables._replace(
            sng_pack=torch.zeros((0, 0)),
            table=dataclasses.replace(tables.table, sing_dir=None,
                                      sing_exch=None))
        wdt = torch.float32 if f32 else torch.float64
        with pytest.raises(ValueError):
            hbspawn.singles_source(tables, True, wdt)
        assert hbspawn.singles_source(tables, False, wdt) == hbspawn.NO_SINGLES
        out = propose(c, tables)
        assert out is not None
        _same_bits(out, hbspawn.propose_plain(*calls[-1]))
        with pytest.raises(ValueError):
            hbspawn.propose_cuda(*calls[-1])
    # a pack with a float64 state, float64 rows with a float32 one: none
    t32 = W.build_walk_tables(s, trial, cfg)
    t64 = W.build_walk_tables(s, trial, dataclasses.replace(cfg, f32_state=False))
    assert hbspawn.singles_source(t32, True, torch.float32) == hbspawn.PACK
    assert hbspawn.singles_source(t64, True, torch.float64) == hbspawn.ROWS
    for t, wdt in ((t32, torch.float64), (t64, torch.float32)):
        with pytest.raises(ValueError):
            hbspawn.singles_source(t, True, wdt)


def test_hb_spawn_ct_chain_calls_no_proposal(monkeypatch):
    """A generation of the exponential projector's CT chain (4x4
    Hubbard-k) runs its own chain: no call of the walk's proposal."""
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system
    s = make_hubbard_k_system(2, 2, 1.0, 4.0, 2, 2, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=1e-2, n_psi_t=20, n_imp=1)
    cfg = W.WalkConfig(mwalk=4096, cap_spawn=4096, norb=s.norb, nup=2, ndn=2,
                       n_words=1, tau=5e-3, w_abs_target=1e3,
                       semistochastic=False, use_exponential_projector=True,
                       has_singles=False)
    tables = W.build_walk_tables(s, trial, cfg)
    st = W.init_walk_state(cfg, trial, 1e3, trial.e_trial, tables)

    def refuse(*a):
        raise AssertionError("the CT chain called the proposal")

    monkeypatch.setattr(W, "_propose", refuse)
    monkeypatch.setattr(hbspawn, "propose", refuse)
    st, stats = W._walk_step_impl(st, tables, cfg,
                                  torch.Generator().manual_seed(1))
    assert int(st.step) == 1 and float(stats["n_spawn"]) > 0


def test_hb_spawn_wrapper_has_no_path_for_other_devices():
    """hbspawn.propose takes the plain version on the CPU only; another
    device without a kernel raises (the meta device stands in)."""
    meta = torch.device("meta")
    w = torch.zeros((4, 1), dtype=torch.int64, device=meta)
    u = [torch.zeros(4, dtype=torch.float64, device=meta)] * 5
    with pytest.raises(ValueError):
        hbspawn.propose(None, w, w, 3, False, None, torch.float32, u)
