"""The momentum-space Hubbard cells of the benchmark (hubbardk4x4.walk,
hubbardk4x4.walk-ct) at CPU sizes: the benchmark's plain Hubbard-k
reference against the port's system, the CT chain's two counters
against a recount, the proposal seam the planted spawn faults use in a
CT walk, and the CT judge on a small walk."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from benchmark import faults, harness, registry
from benchmark.drivers import walk_ct
from benchmark.reference import hubbardk, judge_walk_ct, slater
from sqmc_tpu_torch import dets
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.systems.chem.slater import pair_matrix_elements
from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system

torch.set_num_threads(1)


def _reference(l_x, l_y, t=1.0, U=4.0):
    return slater.Hamiltonian(*hubbardk.integrals(l_x, l_y, t, U))


def _word(orbs):
    return sum(1 << int(o) for o in orbs)


def _connected(u, d, norb):
    """Every det one or two excitations from (u, d), as two int64
    tensors (plain enumeration, both spins)."""
    def moves(w, k):
        occ = [o for o in range(norb) if w >> o & 1]
        emp = [o for o in range(norb) if not w >> o & 1]
        return [w ^ _word(a) ^ _word(b)
                for a in itertools.combinations(occ, k)
                for b in itertools.combinations(emp, k)]
    out = [(x, d) for k in (1, 2) for x in moves(u, k)]
    out += [(u, y) for k in (1, 2) for y in moves(d, k)]
    out += [(x, y) for x in moves(u, 1) for y in moves(d, 1)]
    out.append((u, d))
    a = torch.tensor(out, dtype=torch.int64)
    return a[:, 0], a[:, 1]


@pytest.mark.parametrize("l_x,l_y,nup,ndn", [(2, 2, 2, 2), (3, 3, 3, 2),
                                             (4, 4, 5, 5)])
def test_reference_rows_equal_the_programs_elements(l_x, l_y, nup, ndn):
    """Rows of H from seeded random dets to every det within two
    excitations (the odd-L shift at 3x3, umklapp at 4x4): the benchmark's
    reference equals the port's elements to 1e-12, and a quarter or more
    of the doubles are momentum-conserving nonzeros."""
    s = make_hubbard_k_system(l_x, l_y, 1.0, 4.0, nup, ndn, device="cpu")
    H = _reference(l_x, l_y)
    norb = s.norb
    rng = np.random.default_rng(l_x * 10 + l_y)
    n_nonzero = 0
    for _ in range(3):
        u = _word(rng.choice(norb, nup, replace=False))
        d = _word(rng.choice(norb, ndn, replace=False))
        cu, cd = _connected(u, d, norb)
        iu, idn = torch.full_like(cu, u), torch.full_like(cd, d)
        ref = H.pairs(iu, idn, cu, cd)
        bits = lambda w: dets.to_bits(w[:, None], norb)  # noqa: E731
        prog = pair_matrix_elements(s.table, bits(iu), bits(idn), bits(cu),
                                    bits(cd))
        assert float((ref - prog).abs().max()) < 1e-12
        n_nonzero += int((ref[:-1] != 0).sum())
    assert n_nonzero > 0


def _sector(l_x, l_y, nup, ndn):
    """Every det of the HF det's total momentum (integer units, modulo
    the reciprocal lattice)."""
    k, _ = hubbardk.kvectors(l_x, l_y)
    mod = np.array([2 * l_x, 2 * l_y])
    norb = len(k)
    hf = np.mod(k[:nup].sum(0) + k[:ndn].sum(0), mod)
    ups = list(itertools.combinations(range(norb), nup))
    dns = list(itertools.combinations(range(norb), ndn))
    ku = {c: k[list(c)].sum(0) for c in ups}
    kd = {c: k[list(c)].sum(0) for c in dns}
    out = [(_word(a), _word(b)) for a in ups for b in dns
           if (np.mod(ku[a] + kd[b], mod) == hf).all()]
    a = torch.tensor(out, dtype=torch.int64)
    return a[:, 0], a[:, 1]


@pytest.mark.parametrize("l_x,l_y,nup,ndn", [(2, 2, 2, 2), (2, 4, 3, 3)])
def test_reference_sector_energy_equals_the_programs_hci(l_x, l_y, nup,
                                                         ndn):
    """The reference's lowest eigenvalue over the HF det's momentum
    sector equals the port's HCI at eps_var 1e-9."""
    s = make_hubbard_k_system(l_x, l_y, 1.0, 4.0, nup, ndn, device="cpu")
    res = run_hci(s, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                  verbose=False)
    u, d = _sector(l_x, l_y, nup, ndn)
    H = _reference(l_x, l_y)
    A = H.rows(u, d, u, d)
    e0 = float(torch.linalg.eigvalsh(A)[0])
    assert abs(float(res.energies[0]) - e0) < 1e-9, (res.energies[0], e0)


# ---------------------------------------------------------------------------
# the CT chain's counters
# ---------------------------------------------------------------------------

def _ct_walk(l_x=2, l_y=4, nup=3, ndn=3, **kw):
    s = make_hubbard_k_system(l_x, l_y, 1.0, 4.0, nup, ndn, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=30)
    knobs = dict(mwalk=4096, cap_spawn=4096, norb=s.norb, nup=nup, ndn=ndn,
                 n_words=1, tau=0.05, w_abs_target=1000.0, f32_state=True,
                 semistochastic=False, use_exponential_projector=True,
                 has_singles=False, r_initiator=1.0, min_wt=0.5)
    knobs.update(kw)
    cfg = TW.WalkConfig(**knobs)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 800.0, trial.e_trial, tables)
    st, _ = TW.walk_block(st, tables, cfg, 5, torch.Generator().manual_seed(3))
    return s, trial, cfg, tables, st


def _chain_at(cfg, args, state, k):
    """_ct_chain's outputs on the recorded inputs, from the recorded
    generator state, with at most k moves."""
    tables, up_w, dn_w, slot_valid, gen, tau, e_trial = args
    g = torch.Generator().set_state(state)
    return TW._ct_chain(dataclasses.replace(cfg, ct_max_jumps=k), tables,
                        up_w, dn_w, slot_valid, g, tau, e_trial)


def _record_chain(monkeypatch):
    seen = {}
    orig = TW._ct_chain

    def spy(cfg, tables, up_w, dn_w, slot_valid, gen, tau, e_trial):
        seen["cfg"] = cfg
        seen["args"] = (tables, up_w, dn_w, slot_valid, gen, tau, e_trial)
        seen["state"] = gen.get_state()
        seen["out"] = orig(cfg, tables, up_w, dn_w, slot_valid, gen, tau,
                           e_trial)
        return seen["out"]
    monkeypatch.setattr(TW, "_ct_chain", spy)
    return seen


@pytest.mark.parametrize("l_x,l_y,nup,ndn", [(2, 2, 2, 2), (2, 4, 3, 3)])
def test_ct_counters_equal_a_recount_of_the_moves(l_x, l_y, nup, ndn,
                                                  monkeypatch):
    """n_ct_jumps of a generation equals a recount from the chain's moves
    re-run eagerly from the same generator state with 0, 1, ..., 12
    moves allowed: a jump is a slot whose det changed at that move (a
    jump always moves an electron; a crossing or an invalid proposal
    leaves the det).  n_ct_cut counts exactly the chains that
    ct_max_jumps = 1 zeroes: those that jumped at the first move, each
    left with a zero factor."""
    _, _, cfg, tables, st = _ct_walk(l_x, l_y, nup, ndn)
    seen = _record_chain(monkeypatch)
    gen = torch.Generator().manual_seed(11)
    _, stats = TW._walk_step_impl(st, tables, cfg, gen)
    args, state = seen["args"], seen["state"]
    up0, dn0 = args[1], args[2]
    prev = (up0, dn0)
    recount = 0
    for k in range(1, cfg.ct_max_jumps + 1):
        cu, cd = _chain_at(cfg, args, state, k)[:2]
        recount += int(((cu != prev[0]) | (cd != prev[1])).any(1).sum())
        prev = (cu, cd)
    assert recount > 100
    assert float(stats["n_ct_jumps"]) == recount == float(seen["out"][4])
    assert float(stats["n_ct_cut"]) == float(seen["out"][5])

    cu, cd, f, ok, n_j, n_cut = _chain_at(cfg, args, state, 1)
    moved = ((cu != up0) | (cd != dn0)).any(1)
    assert int(moved.sum()) > 0 and float(n_cut) == int(moved.sum())
    assert not bool((ok & moved).any()) and bool((f[moved] == 0).all())
    assert float(n_j) == int(moved.sum())


def test_ct_cut_in_a_walk_and_zero_counters_in_a_heat_bath_walk():
    """Through walk_block: a CT walk at ct_max_jumps = 1 counts cut
    chains, at 12 and tau rate ~ 1 none in the trace; a heat-bath walk's
    two counters are 0 in every generation."""
    _, _, cfg, tables, st = _ct_walk()
    for k, cut in ((1, True), (12, False)):
        c = dataclasses.replace(cfg, ct_max_jumps=k)
        _, stats = TW.walk_block(st, tables, c, 3,
                                 torch.Generator().manual_seed(2))
        assert (float(stats["n_ct_cut"].sum()) > 0) == cut
        assert float(stats["n_ct_jumps"].sum()) > 0
        rep = TW.block_report()
        assert rep["n_ct_jumps"] == float(stats["n_ct_jumps"].sum())
        assert rep["n_ct_cut"] == float(stats["n_ct_cut"].sum())
        assert rep["sub_ns"]["propose"] > 0
    s, trial, _, _, _ = _ct_walk()
    hb = TW.WalkConfig(mwalk=4096, cap_spawn=4096, norb=s.norb, nup=3,
                       ndn=3, n_words=1, tau=5e-3, w_abs_target=1000.0,
                       f32_state=True, has_singles=False, r_initiator=0.5)
    tb = TW.build_walk_tables(s, trial, hb)
    st = TW.init_walk_state(hb, trial, 800.0, trial.e_trial, tb)
    _, stats = TW.walk_block(st, tb, hb, 3, torch.Generator().manual_seed(2))
    assert float(stats["n_spawn_ok"].sum()) > 0
    for k in ("n_ct_jumps", "n_ct_cut"):
        assert stats[k].dtype == torch.float64
        assert not bool(stats[k].any()), k


# ---------------------------------------------------------------------------
# the planted spawn faults reach the CT chain
# ---------------------------------------------------------------------------

def test_spawn_faults_reach_the_ct_chain():
    """Patching the walk's _propose as the benchmark's spawn faults do
    changes a CT walk's spawns: doubling the factors keeps every accepted
    slot and doubles its weight (each histogram bin moves up by one);
    leaving out every other slot accepts fewer."""
    _, _, cfg, tables, st = _ct_walk()

    def step():
        return TW._walk_step_impl(st, tables, cfg,
                                  torch.Generator().manual_seed(5))
    new, sound = step()
    for name in ("scaled", "half"):
        undo = faults.FOR["walk"][name](None)
        try:
            out, stats = step()
        finally:
            undo()
        assert not torch.equal(out.wt, new.wt), name
        if name == "scaled":
            assert float(stats["n_spawn_ok"]) == float(sound["n_spawn_ok"])
            assert torch.equal(stats["spawn_hist"][1:],
                               sound["spawn_hist"][:-1])
        else:
            assert float(stats["n_spawn_ok"]) < float(sound["n_spawn_ok"])
        assert float(stats["n_ct_jumps"]) == float(sound["n_ct_jumps"])


# ---------------------------------------------------------------------------
# the CT judge on a small walk
# ---------------------------------------------------------------------------

CONFIG = {"name": "hubbardk2x4", "system": "hubbardk", "l_x": 2, "l_y": 4,
          "t": 1.0, "U": 4.0, "nup": 3, "ndn": 3}
SEED = 20260023


def test_ct_judge_reads_a_sound_walk_and_the_spawn_faults():
    """A sound CT walk on the 2x4 cluster (the CT cell's driver and
    traffic at a CPU size, one block of 100 generations) reads 0 broken
    walker rows, with no D-space number and no D det required resident;
    doubling or halving the spawns (planted as control.py plants them,
    before the walk equilibrates again) moves the window's energy past
    the sound run's."""
    spec = registry.Spec()
    traffic = spec.traffic(spec.cell("hubbardk4x4.walk-ct")["traffic"])
    traffic["trial"] = dict(traffic["trial"], n_psi_t=30, n_imp=60)
    traffic["walk"] = dict(traffic["walk"], mwalk=2048, cap_spawn=2048,
                           w_abs_target=500.0, tau=0.02)
    traffic["run"] = dict(traffic["run"], nstep=100, eq_blocks=1,
                          w_abs_begin=400.0)
    traffic["reference"] = dict(traffic["reference"], eps_pt=1e-9)
    sysmod = registry.system(CONFIG["system"])
    wd = harness.workdir(spec.root)
    drv = walk_ct.Driver(CONFIG, traffic, SEED, torch.device("cpu"), wd,
                         sysmod)
    drv.setup({})
    H = sysmod.reference(CONFIG, traffic, "cpu", wd)
    read = {}
    for fault in (None, "half", "scaled"):
        undo = faults.FOR["walk"][fault](drv) if fault else None
        try:
            if fault:
                drv.restart(SEED)
            drv.window(0.0)                 # one block
            out = drv.outputs()
        finally:
            if undo:
                undo()
        read[fault] = walk_ct.judge(H, out)
        if fault is None:
            sound = read[None]
            assert set(sound) == {"trial_energy", "estimator", "population",
                                  "walkers", "stale", "energy_mHa"}
            assert sound["walkers"] == 0.0
            assert sound["trial_energy"] < 1e-12
            assert sound["estimator"] < 1e-5
            # the count left out of `walkers`: D dets no walker holds
            # (a few at this population), one more when a walker on a D
            # det is written over
            n_miss = judge_walk_ct.missing_d(H, out)
            nw = out["nwalk"]
            on_d = ((out["walk_up"][:nw, None] == out["imp_up"][None])
                    & (out["walk_dn"][:nw, None] == out["imp_dn"][None]))
            at = int(on_d.any(1).nonzero()[0, 0])
            gone = dict(out, walk_up=out["walk_up"].clone())
            gone["walk_up"][at] = 0
            assert judge_walk_ct.missing_d(H, gone) == n_miss + 1
            assert n_miss == len(out["imp_up"]) - int(on_d.any(0).sum())
    drv.release()
    for fault in ("half", "scaled"):
        assert read[fault]["walkers"] == 0.0
        assert read[fault]["energy_mHa"] > 5 * read[None]["energy_mHa"], read
