"""The electron gas past one fused key and past K3b's register path, on
the CPU: a 38-electron gas in 33 plane waves (make_heg_system(3, 0.5, 38,
19, 2.0): the merge sorts on two key words and searches C(T) and D by
set algebra; 19 electrons a spin), the shape of the benchmark's
heg54.walk cell at a size the CPU runs.

The port's rows and diagonals are held to the benchmark's reference; a
short walk through the cell's own driver (benchmark/drivers/walk_wide.py)
is read by the cell's judge (benchmark/reference/judge_walk_wide.py)
within the cell's limits; and that judge, whose dets are keyed on their
pair of words and whose PT enumerates only momentum-conserving doubles,
is held to the one-key judge (judge_walk) and its full enumeration
(judge_shci.pt_en) on HEG-14.  The walk's proposal mark is read too."""

import math
import types

import numpy as np
import pytest
import torch

from benchmark import registry
from benchmark.reference import eigen, judge_shci, judge_walk, judge_walk_wide
from sqmc_tpu_torch import dets
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.systems.chem import slater
from sqmc_tpu_torch.systems.heg.system import make_heg_system

torch.set_num_threads(2)

WIDE = (38, 19, 2.0)                    # electrons, up electrons, cutoff
CPU = torch.device("cpu")
TINY = {"trial": {"eps_var": 2e-2, "n_psi_t": 50, "n_imp": 100},
        "walk": {"mwalk": 8192, "cap_spawn": 8192, "w_abs_target": 1000.0},
        "run": {"nstep": 10, "eq_blocks": 6, "w_abs_begin": 1000.0,
                "trace_blocks": 1}}


def _config(name, nelec, nup, cutoff):
    base = registry.Spec().config("heg54")
    return dict(base, name=name, nelec=nelec, nup=nup, cutoff_radius=cutoff)


def _traffic(cell):
    spec = registry.Spec()
    traffic = spec.traffic(spec.cell(cell)["traffic"])
    for k, v in TINY.items():
        traffic[k] = dict(traffic[k], **v)
    return traffic


def _driven(kind, config, traffic, tmp_path, seed=20260019, seconds=0.3):
    """A driver of `kind` set up, walked for `seconds` and released:
    (driver module, outputs, the reference's H)."""
    mod = registry.driver(kind)
    sysmod = registry.system(config["system"])
    drv = mod.Driver(config, traffic, seed, CPU, str(tmp_path), sysmod)
    drv.setup({})
    drv.window(seconds)
    out = drv.outputs()
    drv.release()
    return mod, out, sysmod.reference(config, traffic, CPU, str(tmp_path))


def test_the_wide_gas_runs_past_the_fused_key_and_the_register_path():
    s = make_heg_system(3, 0.5, *WIDE, device="cpu")
    cfg = TW.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn, n_words=s.n_words,
                        has_singles=s.has_singles, mwalk=64, cap_spawn=64,
                        tau=1e-3, w_abs_target=100.0)
    assert (s.norb, s.n_words, s.has_singles) == (33, 1, False)
    assert not TW._fused_keys(cfg) and s.nup > 16


def test_port_rows_and_diagonals_match_the_reference(tmp_path):
    """The port's diagonals (float64) and matrix elements over the trial's
    D space agree with the reference's to 1e-12 of the largest; the walk
    table's float32 projector rows to float32 rounding."""
    config = _config("heg38", *WIDE)
    s = registry.system("heg").program_system(config, {}, CPU, str(tmp_path))
    H = registry.system("heg").reference(config, {}, CPU, str(tmp_path))
    trial = build_trial_wavefunction(s, eps_var=2e-2, n_psi_t=50, n_imp=100)
    u, d = trial.imp_up, trial.imp_dn
    bu, bd = dets.to_bits(u, s.norb), dets.to_bits(d, s.norb)
    diag = slater.diag_elements(s.table, bu, bd)
    ref_diag = H.diag(u[:, 0], d[:, 0])
    assert float((diag - ref_diag).abs().max()) <= 1e-12 * float(
        ref_diag.abs().max())
    n = len(u)
    i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    rows = slater.pair_matrix_elements(s.table, bu[i], bd[i], bu[j],
                                       bd[j]).reshape(n, n)
    ref = H.rows(u[:, 0], d[:, 0], u[:, 0], d[:, 0])
    off = ~torch.eye(n, dtype=torch.bool)
    scale = float(ref[off].abs().max())
    assert scale > 0 and int((ref[off] != 0).sum()) > n
    assert float((rows - ref)[off].abs().max()) <= 1e-12 * scale
    cfg = TW.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn, n_words=1,
                        has_singles=False, mwalk=1024, cap_spawn=1024,
                        tau=1e-3, w_abs_target=100.0, f32_state=True)
    tables = TW.build_walk_tables(s, trial, cfg)
    dense = tables.imp_dense.double()
    assert dense.shape == (n, n)
    assert float((dense - ref)[off].abs().max()) <= 2.0 ** -23 * scale
    assert float((tables.imp_diag - ref_diag).abs().max()) <= 1e-12 * float(
        ref_diag.abs().max())


def test_short_wide_walk_reads_within_the_cells_limits(tmp_path):
    """A short walk of the wide gas through heg54.walk's driver and
    traffic (tiny sizes): the cell's judge reads its trial, D rows,
    walkers, estimator, population and staleness within heg54.walk's
    limits, and a finite energy."""
    mod, out, H = _driven("walk_wide", _config("heg38", *WIDE),
                          _traffic("heg54.walk"), tmp_path)
    assert out["basis"] == {"n_dim": 3, "cutoff_radius": 2.0}
    info = {}
    got = mod.judge(H, out, info=info)
    limits = registry.Spec().limits("heg54.walk")
    for k in ("trial_energy", "d_space", "walkers", "estimator",
              "population", "stale"):
        assert got[k] <= limits[k], (k, got[k], limits[k])
    assert math.isfinite(got["energy_mHa"]) and info["pt_d"] < 0
    assert out["nwalk"] > 100
    # a window that left no weight on Psi_T's dets reads as not finite
    dead = dict(out, e_num_sum=0.0, e_den_sum=0.0, e_num=0.0, e_den=0.0)
    got = mod.judge(H, dead)
    assert math.isnan(got["energy_mHa"]) and got["estimator"] == 1.0


def test_wide_judge_gives_the_one_key_judges_numbers_on_heg14(tmp_path):
    """On HEG-14's walk outputs (19 orbitals) the pair-keyed judge and
    judge_walk give the same numbers, and the control's, to 1e-12."""
    cfg = dict(registry.Spec().config("heg14"), name="heg14")
    mod, out, H = _driven("walk_wide", cfg, _traffic("heg14.walk"), tmp_path)
    control = {"trial": "float32", "diag": "float32", "state": "bfloat16",
               "projector": "tf32"}
    for ctl in (None, control):
        ia, ib = {}, {}
        a = judge_walk.numbers(H, out, ctl, ia)
        b = judge_walk_wide.numbers(H, out, ctl, ib)
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-12 * max(abs(a[k]), 1.0), k
        for k in ia:
            assert abs(ia[k] - ib[k]) <= 1e-12 * max(abs(ia[k]), 1.0), k


def test_momentum_pt_matches_the_full_enumeration_on_heg14(tmp_path):
    """The momentum-conserving enumeration's PT over HEG-14's D space at
    eps_pt 2e-7 (the cell's) against judge_shci.pt_en's singles and
    doubles: the same candidates, numerators and diagonals, the PT to
    1e-12 relative."""
    cfg = dict(registry.Spec().config("heg14"), name="heg14")
    s = registry.system("heg").program_system(cfg, {}, CPU, str(tmp_path))
    H = registry.system("heg").reference(cfg, {}, CPU, str(tmp_path))
    trial = build_trial_wavefunction(s, eps_var=2e-2, n_psi_t=50, n_imp=100)
    u, d = trial.imp_up[:, 0], trial.imp_dn[:, 0]
    e, v = eigen.lowest(eigen.dense(H, u, d))
    nvec = judge_walk_wide.kvectors(3, cfg["cutoff_radius"])
    full = judge_shci.pt_en(H, u, d, v, e, 7, 7, 2e-7)
    mom = judge_walk_wide.pt_en(H, nvec, u, d, v, e, 7, 7, 2e-7, block=16)
    assert full[1] == mom[1] and len(full[2]) == len(mom[2]) > 1000
    assert torch.allclose(full[2], mom[2], rtol=1e-12, atol=1e-15)
    assert torch.equal(full[3], mom[3])
    assert abs(full[0] - mom[0]) <= 1e-12 * abs(full[0])


def test_momentum_doubles_are_every_nonzero_double():
    """Each momentum-conserving double of a wide-gas det conserves the
    total k and moves two electrons; no other double or single of the
    det has a nonzero element."""
    config = _config("heg38", *WIDE)
    H = registry.system("heg").reference(config, {}, CPU, "")
    nvec = judge_walk_wide.kvectors(3, 2.0)
    mom = judge_walk_wide.Momentum(H, nvec)
    rng = np.random.default_rng(3)
    up = torch.tensor([sum(1 << int(o) for o in rng.choice(33, 19, False))
                       for _ in range(4)])
    dn = torch.tensor([sum(1 << int(o) for o in rng.choice(33, 19, False))
                       for _ in range(4)])
    cu, cd, rf = judge_walk_wide.doubles(mom, up, dn, 19, 19)
    lvl = judge_walk_wide.popcount(cu ^ up[rf]) + judge_walk_wide.popcount(
        cd ^ dn[rf])
    assert bool((lvl == 4).all())
    k = torch.as_tensor(nvec)

    def ktot(w):
        bits = (w[:, None] >> torch.arange(33)) & 1
        return bits.double() @ k.double()
    assert torch.equal(ktot(cu) + ktot(cd), ktot(up[rf]) + ktot(dn[rf]))
    assert judge_walk_wide.n_unique(cu, cd) == len(cu)
    h = H.pairs(cu, cd, up[rf], dn[rf])
    assert float((h != 0).double().mean()) > 0.9
    for i in range(4):
        ou, vu = judge_shci._occ_virt(up[i:i + 1], 19, 33)
        od, vd = judge_shci._occ_virt(dn[i:i + 1], 19, 33)
        allu = torch.cat([judge_shci._singles(up[i:i + 1], ou, vu),
                          judge_shci._doubles(up[i:i + 1], ou, vu)], 1)[0]
        alld = torch.cat([judge_shci._singles(dn[i:i + 1], od, vd),
                          judge_shci._doubles(dn[i:i + 1], od, vd)], 1)[0]
        h_u = H.pairs(allu, dn[i].expand_as(allu), up[i].expand_as(allu),
                      dn[i].expand_as(allu))
        h_d = H.pairs(up[i].expand_as(alld), alld, up[i].expand_as(alld),
                      dn[i].expand_as(alld))
        mine = rf == i
        same_u = mine & (cd == dn[i])
        same_d = mine & (cu == up[i])
        assert int((h_u != 0).sum()) == int((h[same_u] != 0).sum())
        assert int((h_d != 0).sum()) == int((h[same_d] != 0).sum())


def test_pair_keys_member_and_count():
    """member and n_unique on dets whose words pass 2^31 and 2^61: the
    index of each query in the pool or -1, the count of distinct dets."""
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 1 << 61, (300, 2))
    pool[100:150] = pool[:50]                              # repeats
    pool[150:160, 0] = pool[0, 0]                          # same up word
    queries = np.concatenate([pool[rng.integers(0, 300, 200)],
                              rng.integers(0, 1 << 61, (100, 2))])
    queries[-5:, 0] = pool[0, 0]
    t = torch.as_tensor
    got = judge_walk_wide.member(t(queries[:, 0]), t(queries[:, 1]),
                                 t(pool[:, 0]), t(pool[:, 1])).numpy()
    seen = {tuple(x) for x in pool.tolist()}
    for q, g in zip(queries.tolist(), got):
        if tuple(q) in seen:
            assert tuple(pool[g].tolist()) == tuple(q)
        else:
            assert g == -1
    assert judge_walk_wide.n_unique(t(pool[:, 0]), t(pool[:, 1])) \
        == len(seen)


def test_proposal_mark_inside_the_spawn_piece():
    """A heat-bath walk of the wide gas writes the proposal's mark in
    every generation, in time order inside the spawn piece: sub_ns
    "propose" lies in (0, spawn], and the benchmark's reader gives it in
    ms; the uniform proposal writes no such mark and reports none."""
    s = make_heg_system(3, 0.5, *WIDE, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=2e-2, n_psi_t=50, n_imp=100)
    reader = registry.metric("propose_ms_per_gen").read
    for proposal in ("fast_heatbath", "uniform"):
        cfg = TW.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn, n_words=1,
                            has_singles=False, mwalk=8192, cap_spawn=8192,
                            tau=2e-4, w_abs_target=1000.0, f32_state=True,
                            proposal=proposal)
        tables = TW.build_walk_tables(s, trial, cfg)
        st = TW.init_walk_state(cfg, trial, 1000.0, trial.e_trial, tables)
        gen = torch.Generator().manual_seed(2)
        n = 4
        TW.walk_block(st, tables, cfg, n, gen)
        rep = TW.block_report()
        m = TW._LAST_BLOCK["marks"].read(n)
        assert m.shape == (n, TW.N_MARKS)
        if proposal == "uniform":
            assert "propose" not in rep["sub_ns"]
            assert (m[:, TW.MARK_PROPOSE] == 0).all()
            assert reader({"kind": "walk"}) is None
            continue
        assert (m > 0).all() and (np.diff(m.reshape(-1)) >= 0).all()
        assert 0 < rep["sub_ns"]["propose"] <= rep["piece_ns"]["spawn"]
        assert reader({"kind": "walk"}) == rep["sub_ns"]["propose"] * 1e-6
        total = sum(rep["piece_ns"].values()) * n
        assert total == pytest.approx(float(m[-1, -1] - m[0, 0]), rel=1e-12)


def test_hb_spawn_roofline_counts_the_compulsory_bytes():
    """The K3b roofline: the drawn slots' det words in and outputs out
    and each table once, over the k_hb_spawn rows' mean time; None
    without those rows or counters."""
    from benchmark.yardstick import hb_spawn_bytes, peaks
    s = make_heg_system(3, 0.5, *WIDE, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=2e-2, n_psi_t=50, n_imp=100)
    cfg = TW.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn, n_words=1,
                        has_singles=False, mwalk=1024, cap_spawn=1000,
                        tau=1e-3, w_abs_target=100.0, f32_state=True)
    tables = TW.build_walk_tables(s, trial, cfg)
    tab = sum(getattr(tables, k).numel() * getattr(tables, k).element_size()
              for k in hb_spawn_bytes.HB_TABLES)
    assert hb_spawn_bytes.compulsory(10, 1, tables, False, True) \
        == 10 * (16 + 25) + tab
    last = {"n_spawn": torch.tensor([600.0, 1600.0])}   # mean > the cap
    drv = types.SimpleNamespace(cfg=cfg, tables=tables, last=last)
    row = "void k_hb_spawn<1, true, float, 0>(Args)"    # heg54.walk's
    run = {"kind": "walk", "driver": drv,
           "trace": {"rows": {row: (30.0, 3)}}}
    want = 100 * peaks.bound_us(hb_spawn_bytes.compulsory(
        1000.0, 1, tables, False, True))[0] / 10.0
    read = registry.metric("hb_spawn_roofline").read
    assert read(run) == pytest.approx(want) and 0 < read(run) < 100
    run["trace"]["rows"] = {}
    assert read(run) is None
    assert read({"kind": "walk", "driver": drv, "trace": None}) is None
