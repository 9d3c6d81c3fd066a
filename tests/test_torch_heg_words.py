"""Dets of two int64 words a spin in the benchmark, on the CPU: the
14-electron gas in 81 plane waves (make_heg_system(3, 0.5, 14, 7, 2.5):
two words a spin, the shape of the benchmark's heg54-pw81.walk cell at a
size the CPU runs) and the padded chem system of test_torch_multiword.

The reference's Slater-Condon rules for W words a spin
(benchmark/reference/slater_words.py) are held to the port's elements on
two-word dets and to the one-word reference on HEG-14; the words judge
(benchmark/reference/judge_walk_words.py) to the pair-keyed judge at one
word; a short walk through the cell's driver (drivers/walk_words.py) is
read `correct` by its judge and a planted fault is not; and the walk's
device marks, with the sort's, come in time order."""

import math

import numpy as np
import pytest
import torch

from benchmark import faults, registry
from benchmark.reference import (heg, judge_walk_wide, judge_walk_words,
                                 slater, slater_words)
from sqmc_tpu_torch import dets
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.chem import slater as PS
from test_torch_multiword import NDN, NORB, NPAD, NUP, _padded

torch.set_num_threads(2)

CPU = torch.device("cpu")
GAS = (14, 7, 2.5)                    # electrons, up electrons, cutoff: 81 PW
TINY = {"trial": {"eps_var": 1e-2, "n_psi_t": 50, "n_imp": 400},
        "walk": {"mwalk": 16384, "cap_spawn": 16384, "w_abs_target": 1000.0,
                 "tau": 2e-3, "pop_ctrl_exponent": 10.0},
        "run": {"nstep": 10, "eq_blocks": 20, "w_abs_begin": 1000.0,
                "trace_blocks": 1}}
# At this size the walk's energy gap holds D's own PT error (a D of 400
# dets, PT -147 mHa) and one block's noise: it is read against a limit of
# its own, the other numbers against the cell's.  CPU readings at these
# sizes (one block of 10 generations in the window, at four settings of
# the capacities and the equilibration): sound 6.1-15.1 mHa, half 81-85;
# at D 100, sound 41.9, half 167
TINY_ENERGY_MHA = 30.0


def _config(nelec=GAS[0], nup=GAS[1], cutoff=GAS[2]):
    base = registry.Spec().config("heg54-pw81")
    return dict(base, name="heg14-pw81", nelec=nelec, nup=nup,
                cutoff_radius=cutoff)


@pytest.fixture(scope="module")
def gas():
    """The 81-plane-wave gas of 14 electrons: (port system, reference H)."""
    config = _config()
    s = registry.system("heg_words").program_system(config, {}, CPU, "")
    H = registry.system("heg_words").reference(config, {}, CPU, "")
    assert (s.norb, s.n_words, H.norb, H.W) == (81, 2, 81, 2)
    return s, H


def _words(occ, norb):
    return np.stack([dets.det_from_orbs(o, norb) for o in occ])


def _excite(rng, occ, norb, k):
    """occ with k electrons moved to empty orbitals."""
    occ = set(occ)
    for _ in range(k):
        occ.remove(int(rng.choice(sorted(occ))))
        occ.add(int(rng.choice(sorted(set(range(norb)) - occ))))
    return sorted(occ)


def _random_pairs(rng, norb, nup, ndn, n, must=()):
    """n det pairs (i, j) as [n, W] words: i random (orbitals `must`
    among the first dets' occupied), j i with 0-2 electrons a spin moved."""
    ui, di, uj, dj = [], [], [], []
    for a in range(n):
        u = sorted(rng.choice(norb, nup, replace=False).tolist())
        d = sorted(rng.choice(norb, ndn, replace=False).tolist())
        if a < len(must) and must[a] not in u:
            u = sorted(u[1:] + [must[a]])
        ku, kd = [(0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (1, 1), (2, 1)][
            a % 7]
        ui.append(u), di.append(d)
        uj.append(_excite(rng, u, norb, ku)), dj.append(_excite(rng, d, norb,
                                                                 kd))
    return [torch.as_tensor(_words(x, norb)) for x in (ui, di, uj, dj)]


def _program(table, norb, ui, di, uj, dj):
    b = [dets.to_bits(x, norb) for x in (ui, di, uj, dj)]
    return (PS.diag_elements(table, b[0], b[1]),
            PS.pair_matrix_elements(table, *b))


def _close(a, b, tol=1e-12):
    scale = float(b.abs().max())
    assert scale > 0
    assert float((a - b).abs().max()) <= tol * scale, \
        float((a - b).abs().max()) / scale


@pytest.fixture(scope="module")
def chem70():
    """The padded chem system of test_torch_multiword (6 live orbitals
    among 70) at two layouts: the first six orbitals, and six straddling
    the word boundary; with the dense integrals the reference reads."""
    from reference_impl import random_integrals
    h, eri, core, eri_fn = random_integrals(NORB, seed=13)
    out = {}
    for name, live in (("first", range(NORB)),
                       ("straddling", (0, 2, 62, 63, 64, 69))):
        hp, erip, sym = _padded(h, eri, live)
        s = make_system_from_arrays(hp, erip, core, NUP, NDN, orb_sym=sym,
                                    device="cpu")
        g = np.indices((NORB,) * 4).reshape(4, -1)
        dense = np.zeros((NPAD,) * 4)
        lv = np.asarray(live)
        dense[lv[g[0]], lv[g[1]], lv[g[2]], lv[g[3]]] = eri_fn(*g)
        out[name] = (s, slater_words.Hamiltonian(hp, dense, core, NPAD),
                     list(lv))
    return out


def test_words_reference_equals_the_port_on_the_gas(gas):
    """Diagonals and pair elements of two-word dets of the 81-plane-wave
    gas, random pairs at every excitation level and momentum-conserving
    doubles (several across the word boundary), to 1e-12 of the largest."""
    s, H = gas
    rng = np.random.default_rng(81)
    ui, di, uj, dj = _random_pairs(rng, 81, 7, 7, 140, must=(63, 64, 80))
    mom = judge_walk_wide.Momentum(H, judge_walk_wide.kvectors(3, 2.5))
    cu, cd, rf = judge_walk_words.doubles(mom, ui[:20], di[:20], 7, 7)
    pick = torch.as_tensor(rng.choice(len(cu), 400, replace=False))
    ui = torch.cat([ui, ui[:20][rf[pick]]])
    di = torch.cat([di, di[:20][rf[pick]]])
    uj, dj = torch.cat([uj, cu[pick]]), torch.cat([dj, cd[pick]])
    assert bool(((uj[:, 1] != ui[:, 1]) | (dj[:, 1] != di[:, 1])).any())
    diag, el = _program(s.table, 81, ui, di, uj, dj)
    _close(H.diag(ui, di), diag)
    ref = H.pairs(ui, di, uj, dj)
    assert int((ref[140:] != 0).sum()) > 300
    _close(ref, el)


@pytest.mark.parametrize("layout", ["first", "straddling"])
def test_words_reference_equals_the_port_on_padded_chem(chem70, layout):
    """The same on the padded chem system (70 orbitals, two words),
    singles included; the straddling layout puts live orbitals on both
    sides of bit 63."""
    s, H, live = chem70[layout]
    assert s.n_words == 2 and H.W == 2
    rng = np.random.default_rng(70)
    ui, di, uj, dj = _random_pairs(rng, NPAD, NUP, NDN, 210)
    # pairs inside the live orbitals, where the elements are nonzero
    occ = [sorted(rng.choice(live, NUP, replace=False).tolist())
           for _ in range(210)]
    exc = [sorted(rng.choice(live, NUP, replace=False).tolist())
           for _ in range(210)]
    lu, ld = torch.as_tensor(_words(occ, NPAD)), torch.as_tensor(
        _words(exc, NPAD))
    ui, di = torch.cat([ui, lu, lu]), torch.cat([di, ld, ld])
    uj, dj = torch.cat([uj, lu, ld]), torch.cat([dj, ld, ld])
    diag, el = _program(s.table, NPAD, ui, di, uj, dj)
    _close(H.diag(ui, di), diag)
    ref = H.pairs(ui, di, uj, dj)
    single = (slater_words.count(ui ^ uj) + slater_words.count(di ^ dj)) == 2
    assert int((single & (ref != 0)).sum()) > 20
    _close(ref, el)


def test_words_reference_equals_the_one_word_reference_on_heg14():
    """At one word a spin (HEG-14's 19 orbitals) the words reference gives
    the one-word reference's diagonals and elements, every level."""
    cfg = registry.Spec().config("heg14")
    h, eri, core, norb = heg.integrals(3, 0.5, 14, cfg["cutoff_radius"])
    one = slater.Hamiltonian(h, eri, core, norb)
    words = slater_words.Hamiltonian(h, eri, core, norb)
    rng = np.random.default_rng(14)
    ui, di, uj, dj = _random_pairs(rng, norb, 7, 7, 700)
    assert ui.shape[1] == 1
    _close(words.diag(ui, di), one.diag(ui[:, 0], di[:, 0]))
    a = words.pairs(ui, di, uj, dj)
    b = one.pairs(ui[:, 0], di[:, 0], uj[:, 0], dj[:, 0])
    assert int((b != 0).sum()) > 100
    _close(a, b)


def test_words_helpers_on_the_sign_bit():
    """lowest, between, onehot and past on strings with bit 63 set."""
    S = slater_words
    o = torch.tensor([0, 62, 63, 64, 100, 127])
    one = S.onehot(o, 2)
    assert torch.equal(S.lowest(one), o)
    s = one.sum(0, keepdim=True).expand(6, 2)          # all six set
    assert torch.equal(S.count(s), torch.full((6,), 6))
    a, b = torch.tensor([0, 0, 62, 63, 62, 100]), torch.tensor(
        [127, 64, 64, 127, 100, 127])
    assert S.between(s, a, b).tolist() == [4, 2, 1, 2, 2, 0]
    assert S.between(s, b, a).tolist() == [4, 2, 1, 2, 2, 0]
    assert S.past(s, 128).tolist() == [False] * 6
    assert S.past(s, 101).tolist() == [True] * 6
    assert S.past(s[:, :1], 64).tolist() == [False] * 6
    assert torch.equal(S.bits(s, 128).sum(1), torch.full((6,), 6))


def _driven(config, traffic, seed=20260025, seconds=0.5, faults=(None,)):
    """The words driver set up once, then for each of `faults` (None: none)
    equilibrated from `seed` with the fault planted, as control.py does,
    and walked for `seconds`: the outputs of each."""
    mod = registry.driver("walk_words")
    sysmod = registry.system(config["system"])
    drv = mod.Driver(config, traffic, seed, CPU, "", sysmod)
    drv.setup({})
    outs = []
    try:
        for i, fault in enumerate(faults):
            undo = fault(drv) if fault is not None else None
            if i:
                drv.restart(seed)
            try:
                drv.window(seconds)
                outs.append(drv.outputs())
            finally:
                if undo is not None:
                    undo()
        return outs
    finally:
        drv.release()


def _traffic():
    spec = registry.Spec()
    traffic = spec.traffic(spec.cell("heg54-pw81.walk")["traffic"])
    for k, v in TINY.items():
        traffic[k] = dict(traffic[k], **v)
    return traffic


def test_words_judge_gives_the_pair_judges_numbers_at_one_word(tmp_path):
    """On HEG-14's walk outputs through the words driver (one word a
    spin) the words judge gives the pair-keyed judge's numbers and the
    control's to 1e-12; its PT over D gives the same candidates,
    numerators and diagonals; and its keys find and count the same dets."""
    cfg = dict(registry.Spec().config("heg14"), name="heg14")
    (out,) = _driven(cfg, _traffic())
    assert out["walk_up"].dim() == 2 and out["walk_up"].shape[1] == 1
    words = ("psit_up", "psit_dn", "imp_up", "imp_dn", "walk_up", "walk_dn",
             "start_up", "start_dn")
    flat = dict(out, **{k: out[k][:, 0] for k in words})
    H1 = registry.system("heg").reference(cfg, {}, CPU, "")
    Hw = registry.system("heg_words").reference(cfg, {}, CPU, "")
    control = {"trial": "float32", "diag": "float32", "state": "bfloat16",
               "projector": "tf32"}
    for ctl in (None, control):
        ia, ib = {}, {}
        a = judge_walk_wide.numbers(H1, flat, ctl, ia)
        b = judge_walk_words.numbers(Hw, out, ctl, ib)
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-12 * max(abs(a[k]), 1.0), k
        for k in ia:
            assert abs(ia[k] - ib[k]) <= 1e-12 * max(abs(ia[k]), 1.0), k
    iu, idn = out["imp_up"], out["imp_dn"]
    nvec = judge_walk_wide.kvectors(3, cfg["cutoff_radius"])
    v = torch.linspace(1.0, 0.1, len(iu), dtype=torch.float64)
    e = float(Hw.diag(iu[:1], idn[:1])[0]) - 1.0
    a = judge_walk_wide.pt_en(H1, nvec, iu[:, 0], idn[:, 0], v, e, 7, 7, 2e-7)
    b = judge_walk_words.pt_en(Hw, nvec, iu, idn, v, e, 7, 7, 2e-7, block=16)
    assert a[1] == b[1] and len(a[2]) == len(b[2]) > 100
    assert torch.allclose(a[2], b[2], rtol=1e-12, atol=1e-15)
    assert torch.equal(a[3], b[3])
    assert abs(a[0] - b[0]) <= 1e-12 * abs(a[0])
    rng = np.random.default_rng(6)
    pool = rng.integers(-(1 << 62), 1 << 62, (300, 2))
    pool[100:150] = pool[:50]
    q = np.concatenate([pool[rng.integers(0, 300, 200)],
                        rng.integers(-(1 << 62), 1 << 62, (100, 2))])
    t = torch.as_tensor
    assert torch.equal(
        judge_walk_wide.member(t(q[:, 0]), t(q[:, 1]), t(pool[:, 0]),
                               t(pool[:, 1])),
        judge_walk_words.member(t(q[:, :1]), t(q[:, 1:]), t(pool[:, :1]),
                                t(pool[:, 1:])))
    assert judge_walk_wide.n_unique(t(pool[:, 0]), t(pool[:, 1])) \
        == judge_walk_words.n_unique(t(pool[:, :1]), t(pool[:, 1:])) == 250


def _judged(out, H):
    got = judge_walk_words.numbers(H, out)
    limits = dict(registry.Spec().limits("heg54-pw81.walk"),
                  energy_mHa=TINY_ENERGY_MHA)
    return got, all(math.isfinite(got[k]) and got[k] <= limits[k]
                    for k in got)


def test_short_two_word_walk_is_correct_and_half_is_not(gas):
    """A short walk of the 81-plane-wave gas through heg54-pw81.walk's
    driver and traffic (tiny sizes, two words a spin): its judge reads
    every number within the cell's limits (the energy within the tiny
    size's); with every other spawn left out (faults.half) it does not."""
    _, H = gas
    config, traffic = _config(), _traffic()
    out, half = _driven(config, traffic, faults=(None, faults.half))
    assert out["walk_up"].shape[1] == 2 and out["nwalk"] > 300
    assert bool((out["walk_up"][:out["nwalk"], 1] != 0).any())
    got, ok = _judged(out, H)
    assert ok, got
    got, ok = _judged(half, H)
    assert not ok, got


@pytest.mark.parametrize("merge", ["full_sort", "two_level"])
def test_sort_mark_inside_the_annihilation(gas, merge):
    """A block of the two-word gas writes its marks in time order every
    generation; under the full-sort merge sub_ns "sort" lies in (0,
    annihilate] and the benchmark's reader gives it in ms; the two-level
    merge writes no sort mark and reports none."""
    s, _ = gas
    trial = build_trial_wavefunction(s, eps_var=2e-2, n_psi_t=50, n_imp=100)
    cfg = TW.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn, n_words=2,
                        has_singles=False, mwalk=16384, cap_spawn=16384,
                        tau=2e-3, w_abs_target=1000.0, f32_state=True,
                        full_sort_merge=merge == "full_sort")
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 1000.0, trial.e_trial, tables)
    n = 4
    TW.walk_block(st, tables, cfg, n, torch.Generator().manual_seed(3))
    rep = TW.block_report()
    m = TW._LAST_BLOCK["marks"].read(n)
    reader = registry.metric("sort_ms_per_gen").read
    assert m.shape == (n, TW.N_MARKS) and TW.MARK_SORT not in TW.MARK_STARTS
    total = sum(rep["piece_ns"].values()) * n
    assert total == pytest.approx(float(m[-1, -1] - m[0, 0]), rel=1e-12)
    if merge == "two_level":
        assert "sort" not in rep["sub_ns"] and (m[:, TW.MARK_SORT] == 0).all()
        assert reader({"kind": "walk"}) is None
        m = np.delete(m, TW.MARK_SORT, axis=1)
    else:
        assert 0 < rep["sub_ns"]["sort"] <= rep["piece_ns"]["annihilate"]
        assert reader({"kind": "walk"}) == rep["sub_ns"]["sort"] * 1e-6
    assert (m > 0).all() and (np.diff(m.reshape(-1)) >= 0).all()
