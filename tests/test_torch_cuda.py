"""Tests that need an NVIDIA card (marked `cuda`; each skips without one).

The card has no jax, and tests/conftest.py imports it, so on the card run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

This file imports only torch, numpy and the port.
"""

import numpy as np
import pytest
import torch
from torch_hb_emulation import random_dets as _random_dets

from sqmc_tpu_torch.ops import segscan as tseg
from sqmc_tpu_torch.ops import spmv as tspmv

OPS6 = ["min", "max", "sum", "sum", "min", "max"]


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _six_fields(n, fdt, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 131, n).astype(np.int32),
            rng.integers(0, 4, n).astype(np.int32),
            rng.standard_normal(n).astype(fdt),
            (rng.standard_normal(n) * (rng.random(n) < 0.2)).astype(fdt),
            rng.standard_normal(n).astype(fdt),
            rng.integers(-2, 1000, n).astype(np.int32))


@pytest.mark.cuda
def test_seg_scan_kernel_matches_plain():
    """The hand kernel against the plain version on the card: the walk
    merge's field mix at a multi-tile ragged length, float64 fields and
    uint32 min/max.  Integers and min/max exact; float sums within
    atol + rtol * (segment prefix sum of |x|), the rounding bound of the
    two association orders."""
    dev = _device()
    n = 70001
    rng = np.random.default_rng(0)
    s = rng.random(n) < 0.3
    s[0] = True
    start = torch.as_tensor(s, device=dev)
    before = tseg.launches
    for fdt, (atol, rtol) in ((np.float32, (1e-5, 4e-6)),
                              (np.float64, (1e-12, 1e-14))):
        fields = [torch.as_tensor(x, device=dev) for x in _six_fields(n, fdt)]
        got = tseg.seg_scan(fields, OPS6, start)
        ref = tseg.seg_scan_plain(fields, OPS6, start)
        for k, (g, r, o) in enumerate(zip(got, ref, OPS6)):
            if o == "sum" and g.dtype.is_floating_point:
                bound = atol + rtol * tseg.seg_scan_plain(
                    [fields[k].abs().double()], ["sum"], start)[0]
                assert bool(((g.double() - r.double()).abs() <= bound).all())
            else:
                assert torch.equal(g, r)
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u = torch.as_tensor(u.view(np.int32), device=dev).view(torch.uint32)
    g = tseg.seg_scan([u, u], ["max", "min"], start)
    r = tseg.seg_scan_plain([u, u], ["max", "min"], start)
    for a, b in zip(g, r):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert tseg.launches == before + 3


@pytest.mark.cuda
def test_seg_scan_wrapper_raises_on_bad_input():
    dev = _device()
    start = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        tseg.seg_scan([torch.zeros(8, dtype=torch.int64, device=dev)], ["sum"],
                      start)
    with pytest.raises(ValueError):
        tseg.seg_scan([torch.zeros(8, device="cpu")], ["sum"], start)
    with pytest.raises(ValueError):
        tseg.seg_scan([torch.zeros(8, device=dev)] * 9, ["sum"] * 9, start)


def _exact_walk(d, which):
    """Ten deterministic-limit generations (D = the whole FCI space) on
    device `d`: the tiny HEG in f64 state (block-ELL), or dense random
    integrals with singles in f32 state (dense projection, packed singles
    rows).  Returns the [4, 10] trace."""
    from reference_impl import random_integrals
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.base import make_system_from_arrays
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    if which == "heg_f64":
        s, f32 = make_heg_system(3, 1.0, 4, 2, 1.6, device=d), False
    else:
        h, eri, core, _ = random_integrals(5, seed=5)
        s, f32 = make_system_from_arrays(h, eri, core, 2, 2, device=d), True
    res = run_hci(s, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                  verbose=False)
    trial = build_trial_wavefunction(s, eps_var=1e-9, n_psi_t=len(res.up),
                                     n_imp=len(res.up))
    cfg = TW.WalkConfig(mwalk=2048, cap_spawn=4096, norb=s.norb, nup=s.nup,
                        ndn=s.ndn, n_words=1, tau=5e-3, w_abs_target=500.0,
                        has_singles=s.has_singles, f32_state=f32)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 500.0, float(res.energies[0]), tables)
    st, stats = TW.walk_block(st, tables, cfg, 10,
                              torch.Generator(device=d).manual_seed(0))
    return torch.stack([stats[k] for k in ("e_num_gen", "e_den_gen",
                                           "w_abs_gen", "nwalk")]).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("which,rtol", [("heg_f64", 1e-10), ("chem_f32", 2e-6)])
def test_walk_on_card_matches_cpu(which, rtol):
    """The deterministic-limit walk on the card equals the same walk on
    the CPU: to 1e-10 in f64 state; to 2e-6 in f32 state, where the two
    devices round the float32 matmuls and sums differently.  Each
    generation's merge goes through the seg-scan kernel on the card, and
    each f64-state projection through the SpMV kernel."""
    dev = _device()
    before, sp_before = tseg.launches, tspmv.launches
    card = _exact_walk(dev, which)
    assert tseg.launches == before + 10
    # f64 state projects through the block-ELL SpMV kernel; f32 state with
    # a small D space through the dense matvec
    assert tspmv.launches == sp_before + (10 if which == "heg_f64" else 0)
    np.testing.assert_allclose(card, _exact_walk("cpu", which), rtol=rtol,
                               atol=0)


@pytest.mark.cuda
def test_generation_never_waits_on_the_card():
    """Inside a generation nothing synchronizes with the host: the step
    runs under torch's sync debug mode set to raise (count -> cumsum ->
    fixed slots, order-preserving compactions, no .item() or masked
    indexing); the driver reads the overflow flag once per block."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    dev = _device()
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device=dev)
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=40)
    cfg = TW.WalkConfig(mwalk=1024, cap_spawn=4096, norb=s.norb, nup=2,
                        ndn=2, n_words=1, tau=5e-3, w_abs_target=2000.0,
                        has_singles=False, f32_state=True, r_initiator=0.5)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 1000.0, trial.e_trial, tables)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            st, _ = TW._walk_step_impl(st, tables, cfg, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not bool(st.overflow) and int(st.nwalk) > 0


@pytest.mark.cuda
def test_generation_marks_agree_with_cuda_events():
    """One captured block of 200 generations: its five pieces plus the
    gaps between generations (the device marks' first-to-last time) agree
    within 3% with CUDA events recorded around the block, and every mark
    of every generation is written in order, captured and eager alike."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    dev = _device()
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device=dev)
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=40)
    cfg = TW.WalkConfig(mwalk=4096, cap_spawn=8192, norb=s.norb, nup=2,
                        ndn=2, n_words=1, tau=5e-3, w_abs_target=2000.0,
                        has_singles=False, f32_state=True, r_initiator=0.5)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 1000.0, trial.e_trial, tables)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 200
    st, _ = TW.walk_block(st, tables, cfg, n, gen)      # capture and warm
    st = TW.end_of_block(st)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    st, _ = TW.walk_block(st, tables, cfg, n, gen)
    b.record()
    torch.cuda.synchronize()
    events_ms = a.elapsed_time(b)
    rep = TW.block_report()
    m = TW._LAST_BLOCK["marks"].read(n)
    assert rep["gens"] == n and (m > 0).all()
    assert (np.diff(m.reshape(-1)) >= 0).all()
    marks_ms = sum(rep["piece_ns"].values()) * n * 1e-6
    assert abs(marks_ms - events_ms) <= 0.03 * events_ms, (marks_ms,
                                                           events_ms)
    TW.release_graphs()
    st, _ = TW._walk_block_eager(TW.end_of_block(st), tables, cfg, 5, gen)
    m = TW._LAST_BLOCK["marks"].read(5)
    assert (m > 0).all() and (np.diff(m.reshape(-1)) >= 0).all()


@pytest.mark.cuda
def test_propose_mark_inside_the_spawn_piece_of_a_graphed_block():
    """A captured block of the 38-electron gas's walk (33 orbitals: two
    key words; 38 electrons: K3b past its register path): every mark of
    every generation written in time order, and the proposal's mark
    inside the spawn piece, so 0 < sub_ns["propose"] <= the spawn
    piece."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    dev = _device()
    s = make_heg_system(3, 0.5, 38, 19, 2.0, device=dev)
    trial = build_trial_wavefunction(s, eps_var=2e-2, n_psi_t=50, n_imp=100)
    cfg = TW.WalkConfig(mwalk=32768, cap_spawn=32768, norb=s.norb, nup=19,
                        ndn=19, n_words=1, tau=2e-4, w_abs_target=4000.0,
                        has_singles=False, f32_state=True, r_initiator=0.5)
    assert not TW._fused_keys(cfg)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 4000.0, trial.e_trial, tables)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 20
    st, _ = TW.walk_block(st, tables, cfg, n, gen)      # capture and warm
    st, _ = TW.walk_block(TW.end_of_block(st), tables, cfg, n, gen)
    assert not bool(st.overflow)
    rep = TW.block_report()
    m = TW._LAST_BLOCK["marks"].read(n)
    assert (m > 0).all() and (np.diff(m.reshape(-1)) >= 0).all()
    assert 0 < rep["sub_ns"]["propose"] <= rep["piece_ns"]["spawn"]
    print(f"wide gas: propose {rep['sub_ns']['propose'] * 1e-3:.1f} us of "
          f"spawn {rep['piece_ns']['spawn'] * 1e-3:.1f} us a generation")
    TW.release_graphs()


def _sym_coo(n, seed):
    """Strictly-upper COO + diagonal with skewed row lengths."""
    rng = np.random.default_rng(seed)
    per_row = np.minimum(rng.geometric(0.02, n), 1500)
    r = np.repeat(np.arange(n), per_row)
    c = rng.integers(0, n, len(r))
    lo, hi = np.minimum(r, c), np.maximum(r, c)
    key = np.unique(lo[lo < hi] * n + hi[lo < hi])
    return (n, key // n, key % n, rng.standard_normal(len(key)),
            rng.standard_normal(n))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ell", "blockell"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
def test_spmv_kernel_matches_plain(layout, dtype, rtol):
    """The hand SpMV kernel against its plain version on the card, m = 1
    and 3 right-hand sides: every row within rtol * sum_k |v_k x_k| (other
    summation orders); the m columns of one launch equal m single
    launches bit for bit (a fixed shuffle tree, no atomics)."""
    dev = _device()
    coo = _sym_coo(5000, seed=7)
    if layout == "ell":
        c, v, _, p, k = tspmv.ell_from_coo(*coo)
        c, v = c.reshape(-1), v.reshape(-1)
    else:
        c, v, _, p, k = tspmv.blockell_from_coo(*coo, dtype=np.float64)
    cols = torch.as_tensor(c, device=dev)
    vals = torch.as_tensor(v, device=dev).to(dtype)
    ptr = torch.as_tensor(p, device=dev)
    cnt = torch.as_tensor(k, device=dev)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((5000, 3)),
                        device=dev).to(dtype)
    before = tspmv.launches
    for xs in (x[:, 0].contiguous(), x):
        got = tspmv.spmv(xs, cols, vals, ptr, cnt)
        torch.cuda.synchronize()
        ref = tspmv.spmv_plain(xs, cols, vals, ptr, cnt)
        bound = tspmv.spmv_plain(xs.abs().double(), cols, vals.abs().double(),
                                 ptr, cnt)
        assert got.dtype == dtype and got.shape == ref.shape
        assert bool(((got.double() - ref.double()).abs() <= rtol * bound).all())
    y = tspmv.spmv(x, cols, vals, ptr, cnt)
    for j in range(3):
        assert torch.equal(y[:, j], tspmv.spmv(x[:, j].contiguous(), cols,
                                               vals, ptr, cnt))
    assert tspmv.launches == before + 6


@pytest.mark.cuda
def test_spmv_wrapper_raises_on_bad_input():
    dev = _device()
    cols = torch.zeros(128, dtype=torch.int32, device=dev)
    vals = torch.zeros(128, device=dev)
    ptr = torch.tensor([0, 128], device=dev)
    cnt = torch.tensor([128], dtype=torch.int32, device=dev)
    x = torch.zeros(1, device=dev)
    with pytest.raises(ValueError):
        tspmv.spmv(x, cols.long(), vals, ptr, cnt)
    with pytest.raises(ValueError):
        tspmv.spmv(x.double(), cols, vals, ptr, cnt)
    with pytest.raises(ValueError):
        tspmv.spmv(x, cols.cpu(), vals, ptr, cnt)
    with pytest.raises(ValueError):
        tspmv.spmv(x, cols, vals, ptr, cnt.cpu())


@pytest.mark.cuda
def test_device_davidson_on_card():
    """run_hci(device_davidson=True) on the card (HEG-14 at eps_var 2e-3,
    3,265 dets) selects the float64 CPU run's dets, within 1e-6 in energy,
    with its matvecs on the SpMV kernel."""
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    dev = _device()
    kw = dict(eps_var=2e-3, eps_var_sched=[2e-3] * 5, verbose=False)
    before = tspmv.launches
    card = run_hci(make_heg_system(3, 0.5, 14, 7, 1.49, device=dev),
                   device_davidson=True, **kw)
    assert tspmv.launches > before
    cpu = run_hci(make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu"), **kw)
    assert torch.equal(card.up.cpu(), cpu.up) and torch.equal(card.dn.cpu(),
                                                              cpu.dn)
    np.testing.assert_allclose(card.energies, cpu.energies, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The single-pass seg-scan kernel: look-back across tiles, dtypes, alignment
# ---------------------------------------------------------------------------

_NP = {torch.int32: np.int32, torch.uint32: np.uint32,
       torch.float32: np.float32, torch.float64: np.float64}


def _field(rng, n, dtype, dev):
    npdt = _NP[dtype]
    if dtype == torch.uint32:
        a = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        return torch.as_tensor(a.view(np.int32), device=dev).view(torch.uint32)
    if dtype == torch.int32:
        return torch.as_tensor(rng.integers(-1000, 1000, n).astype(npdt),
                               device=dev)
    return torch.as_tensor(rng.standard_normal(n).astype(npdt), device=dev)


def _check_scan(fields, ops, start, got):
    """Integers and min/max exactly; float sums within atol + rtol x the
    segment's running sum of |x| (other association orders)."""
    ref = tseg.seg_scan_plain(fields, ops, start)
    tol = {torch.float32: (1e-5, 4e-6), torch.float64: (1e-12, 1e-14)}
    for f, g, r, o in zip(fields, got, ref, ops):
        assert g.dtype == r.dtype and g.shape == r.shape
        if o == "sum" and g.dtype.is_floating_point:
            atol, rtol = tol[g.dtype]
            bound = atol + rtol * tseg.seg_scan_plain([f.abs().double()],
                                                      ["sum"], start)[0]
            assert bool(((g.double() - r.double()).abs() <= bound).all())
        elif g.dtype == torch.uint32:
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        else:
            assert torch.equal(g, r)


def _starts(rng, n, p, dev):
    s = rng.random(n) < p
    s[0] = True
    return torch.as_tensor(s, device=dev)


@pytest.mark.cuda
def test_seg_scan_many_tiles_segments_cross_borders():
    """Over 300 tiles, segments of ~1,000 rows crossing tile borders and a
    stretch of 20,000 rows with no start (whole tiles inside one segment,
    so the look-back walks past several tiles)."""
    dev = _device()
    rng = np.random.default_rng(3)
    n = 300 * 2048 + 1234
    s = rng.random(n) < 1e-3
    s[0] = True
    s[100_000:120_000] = False
    start = torch.as_tensor(s, device=dev)
    fields = [_field(rng, n, dt, dev) for dt in
              (torch.float32, torch.int32, torch.float64, torch.uint32)]
    ops = ["sum", "max", "sum", "min"]
    _check_scan(fields, ops, start, tseg.seg_scan(fields, ops, start))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["all_starts", "single_start"])
def test_seg_scan_all_starts_and_one_segment(which):
    dev = _device()
    rng = np.random.default_rng(4)
    n = 50 * 2048 + 17
    s = np.ones(n, bool) if which == "all_starts" else np.eye(1, n, 0, bool)[0]
    start = torch.as_tensor(s, device=dev)
    fields = [_field(rng, n, torch.float32, dev),
              _field(rng, n, torch.int32, dev)]
    ops = ["sum", "min"]
    got = tseg.seg_scan(fields, ops, start)
    _check_scan(fields, ops, start, got)
    if which == "all_starts":                 # every row its own segment
        for f, g in zip(fields, got):
            assert torch.equal(f, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_seg_scan_every_dtype_and_op(dtype, op):
    dev = _device()
    rng = np.random.default_rng(5)
    n = 40 * 2048 + 999
    start = _starts(rng, n, 2e-4, dev)
    f = [_field(rng, n, dtype, dev)]
    _check_scan(f, [op], start, tseg.seg_scan(f, [op], start))


@pytest.mark.cuda
def test_seg_scan_eight_fields():
    dev = _device()
    rng = np.random.default_rng(6)
    n = 20 * 2048 + 5
    start = _starts(rng, n, 0.01, dev)
    dts = [torch.int32, torch.uint32, torch.float32, torch.float64] * 2
    ops = ["sum", "min", "max", "sum", "max", "max", "min", "min"]
    fields = [_field(rng, n, dt, dev) for dt in dts]
    _check_scan(fields, ops, start, tseg.seg_scan(fields, ops, start))


@pytest.mark.cuda
def test_seg_scan_misaligned_views():
    """Views that start 4 bytes (fields) or 1 byte (flags) past a 16-byte
    boundary, as big[1:n+1], give the result of their aligned copies."""
    dev = _device()
    rng = np.random.default_rng(7)
    n = 9 * 2048 + 3
    big_s = _starts(rng, n + 1, 0.05, dev)
    big_f = _field(rng, n + 1, torch.float32, dev)
    big_i = _field(rng, n + 1, torch.int32, dev)
    views = [big_f[1:n + 1], big_i[1:n + 1]]
    start = big_s[1:n + 1].clone()
    start[0] = True
    start_v = torch.cat([big_s[:1], start])[1:]      # a misaligned flag view
    assert views[0].data_ptr() % 16 and start_v.data_ptr() % 16
    ops = ["sum", "max"]
    got = tseg.seg_scan(views, ops, start_v)
    _check_scan([v.clone() for v in views], ops, start, got)


@pytest.mark.cuda
def test_seg_scan_two_calls_same_bits():
    """Two back-to-back calls on the walk merge's shape (a start in every
    tile) give the same bits: the status words are reset per call and the
    look-back's association cannot reach the values."""
    dev = _device()
    n = 458_752 + 262_144
    rng = np.random.default_rng(8)
    start = _starts(rng, n, 0.4, dev)
    fields = [torch.as_tensor(x, device=dev)
              for x in _six_fields(n, np.float32, seed=9)]
    a = tseg.seg_scan(fields, OPS6, start)
    b = tseg.seg_scan(fields, OPS6, start)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _check_scan(fields, OPS6, start, a)


# ---------------------------------------------------------------------------
# The SpMV kernel: row counts, vector loads, heads and tails, many columns
# ---------------------------------------------------------------------------

def _rows_layout(lengths, layout, dtype, dev, seed=0):
    """A row-pointer layout with the given row lengths (row_nnz), padding
    after each row's entries: ELL with K = max length, or 128-slot
    blocks."""
    rng = np.random.default_rng(seed)
    n = len(lengths)
    nnz = int(lengths.sum())
    if layout == "ell":
        ptr = np.arange(n + 1, dtype=np.int64) * int(lengths.max())
    else:
        nb = np.maximum(1, -(-lengths // 128))
        ptr = np.concatenate([[0], np.cumsum(nb)]).astype(np.int64) * 128
    rank = np.arange(nnz) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    slot = np.repeat(ptr[:-1], lengths) + rank
    c = np.zeros(int(ptr[-1]), np.int32)
    v = np.zeros(int(ptr[-1]))
    c[slot] = rng.integers(0, n, nnz)
    v[slot] = rng.standard_normal(nnz)
    return (torch.as_tensor(c, device=dev),
            torch.as_tensor(v, device=dev).to(dtype),
            torch.as_tensor(ptr, device=dev),
            torch.as_tensor(lengths.astype(np.int32), device=dev))


_LENGTHS = np.array([1, 2, 3, 5, 0, 7, 127, 128, 129, 1347, 250, 0, 6, 4]
                    + list(np.random.default_rng(1).integers(1, 300, 400)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ell", "blockell"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
def test_spmv_row_counts_heads_tails_and_columns(layout, dtype, rtol):
    """Rows whose count is not a multiple of 4, padding-only rows (count
    0), an 11-step row (1,347 entries) and ELL with K = 1,347 (K % 4 = 3:
    rows start off the 16-byte grid), for m in {1, 2, 3, 4, 5, 8, 9}: every
    row within rtol x sum_k |v_k x_k| of the plain version; each column of
    one launch equal to its single launch bit for bit; a second run equal
    bit for bit; padding-only rows exactly 0."""
    dev = _device()
    cols, vals, ptr, cnt = _rows_layout(_LENGTHS, layout, dtype, dev)
    n = len(_LENGTHS)
    rng = np.random.default_rng(2)
    for m in (1, 2, 3, 4, 5, 8, 9):
        x = torch.as_tensor(rng.standard_normal((n, m)), device=dev).to(dtype)
        y = tspmv.spmv(x, cols, vals, ptr, cnt)
        ref = tspmv.spmv_plain(x, cols, vals, ptr, cnt)
        bound = tspmv.spmv_plain(x.abs().double(), cols, vals.abs().double(),
                                 ptr, cnt)
        assert y.dtype == dtype and y.shape == (n, m)
        assert bool(((y.double() - ref.double()).abs() <= rtol * bound).all())
        assert torch.equal(y, tspmv.spmv(x, cols, vals, ptr, cnt))
        assert not bool(y[torch.as_tensor(_LENGTHS == 0, device=dev)].any())
        for j in range(m):
            assert torch.equal(y[:, j], tspmv.spmv(x[:, j].contiguous(), cols,
                                                   vals, ptr, cnt))


@pytest.mark.cuda
def test_spmv_misaligned_x():
    """A misaligned x view (big[1:n+1]) gives its aligned copy's result,
    within rtol x sum_k |v_k x_k| of the plain version."""
    dev = _device()
    cols, vals, ptr, cnt = _rows_layout(_LENGTHS, "ell", torch.float32, dev)
    n = len(_LENGTHS)
    big = torch.as_tensor(np.random.default_rng(3).standard_normal(n + 1),
                          device=dev).float()
    x = big[1:n + 1]
    assert x.data_ptr() % 16
    y = tspmv.spmv(x, cols, vals, ptr, cnt)
    assert torch.equal(y, tspmv.spmv(x.clone(), cols, vals, ptr, cnt))
    ref = tspmv.spmv_plain(x, cols, vals, ptr, cnt)
    bound = tspmv.spmv_plain(x.abs().double(), cols, vals.abs().double(),
                             ptr, cnt)
    assert bool(((y.double() - ref.double()).abs() <= 1e-5 * bound).all())


# ---------------------------------------------------------------------------
# The time-reversal symmetrized basis on the card (both kernels)
# ---------------------------------------------------------------------------

def _ts_system(norb, nel, dev, z=1, seed=5):
    """Random chem integrals made with numpy (no JAX on the card), as a
    time-symmetrized system of sector z on `dev`: z = +1 from the
    closed-shell start, z = -1 from an open-shell one."""
    from sqmc_tpu_torch import dets as tdets
    from sqmc_tpu_torch.systems.base import make_system_from_arrays
    from sqmc_tpu_torch.systems.chem.fcidump import n_eri
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(norb, norb))
    h = 0.3 * 0.5 * (h + h.T) + np.diag(np.arange(norb) * 0.5)
    eri = 0.1 * rng.normal(size=n_eri(norb))
    s = make_system_from_arrays(h, eri, float(rng.normal()), nel, nel,
                                device=dev)
    s.time_sym, s.z = True, z
    if z < 0:
        s.hf_dn = tdets.det_from_orbs(list(range(nel - 1)) + [nel], norb)
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
def test_spmv_kernel_on_time_sym_h(dtype, rtol):
    """K2 on the time-symmetrized H of an HCI run on the card (9 orbitals,
    3 + 3 electrons, z = +1, two states: the sqrt2-scaled rows of the
    self-symmetric dets included) at m = 2, the Davidson's width: every row
    within rtol x sum_k |v_k x_k| of the plain version, one launch."""
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
    dev = _device()
    s = _ts_system(9, 3, dev)
    res = run_hci(s, eps_var=1e-3, eps_var_sched=[1e-3] * 2, n_states=2,
                  verbose=False)
    H = build_sparse_ham(s.table, res.up, res.dn, 3, 3, 9, time_sym=True,
                         z=1)
    selfs = (res.up == res.dn).all(dim=1)
    assert H.n >= 2000 and bool(selfs.any()) and bool((~selfs).any())
    c, v, _, p, k = tspmv.blockell_from_coo(H.n, H.rows, H.cols, H.vals,
                                            H.diag, dtype=np.float64)
    cols, ptr, cnt = (torch.as_tensor(a, device=dev) for a in (c, p, k))
    vals = torch.as_tensor(v, device=dev).to(dtype)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((H.n, 2)),
                        device=dev).to(dtype)
    before = tspmv.launches
    y = tspmv.spmv(x, cols, vals, ptr, cnt)
    assert tspmv.launches == before + 1
    ref = tspmv.spmv_plain(x, cols, vals, ptr, cnt)
    bound = tspmv.spmv_plain(x.abs().double(), cols, vals.abs().double(),
                             ptr, cnt)
    assert y.shape == (H.n, 2) and y.dtype == dtype
    assert bool(((y.double() - ref.double()).abs() <= rtol * bound).all())
    # the device Davidson on this H (m = 2 per launch) refines to the
    # float64 Davidson's energies
    dd = run_hci(s, eps_var=1e-3, eps_var_sched=[1e-3] * 2, n_states=2,
                 verbose=False, device_davidson=True)
    assert tspmv.launches > before + 1
    np.testing.assert_allclose(dd.energies, res.energies, rtol=0, atol=2e-6)


def _ts_exact_trace(dev, z, ngen=10):
    """Deterministic-limit generations of the time-symmetrized walk (6
    orbitals, 2 + 2 electrons, D = the whole sector) on `dev` in f64 state:
    each merge is K1 on the card, each projection K2.  Returns the trace
    and the sector's exact e0 (dense symmetrized H)."""
    from sqmc_tpu_torch import dets as tdets
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.chem import slater
    s = _ts_system(6, 2, dev, z=z, seed=3)
    trial = build_trial_wavefunction(s, eps_var=1e-9, n_psi_t=400, n_imp=400)
    bu = tdets.to_bits(trial.imp_up, 6)
    bd = tdets.to_bits(trial.imp_dn, 6)
    n = len(bu)
    i, j = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(n, device=dev), torch.arange(n, device=dev),
        indexing="ij"))
    Hts = slater.pair_matrix_elements_time_sym(s.table, bu[i], bd[i], bu[j],
                                               bd[j], z).reshape(n, n)
    e0 = float(torch.linalg.eigvalsh(Hts.cpu())[0])
    cfg = TW.WalkConfig(mwalk=1024, cap_spawn=4096, norb=6, nup=2, ndn=2,
                        n_words=1, tau=5e-3, w_abs_target=500.0,
                        has_singles=True, time_sym=True, z=z, cap_fresh=512)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 500.0, e0, tables)
    st, stats = TW.walk_block(st, tables, cfg, ngen,
                              torch.Generator(device=dev).manual_seed(0))
    return torch.stack([stats[k] for k in ("e_num_gen", "e_den_gen",
                                           "w_abs_gen", "nwalk")]
                       ).cpu().numpy(), e0, trial


@pytest.mark.cuda
@pytest.mark.parametrize("z", [1, -1])
def test_time_sym_walk_on_card_matches_cpu(z):
    """Ten deterministic-limit generations of the time-symmetrized walk on
    the card (K1 each merge, K2 each projection) equal the CPU's (the
    plain scan and SpMV) to 1e-10, and their energy is the sector's exact
    e0 (z = -1 from an open-shell start)."""
    dev = _device()
    before, sp_before = tseg.launches, tspmv.launches
    card, e0, trial = _ts_exact_trace(dev, z)
    assert tseg.launches == before + 10 and tspmv.launches == sp_before + 10
    cpu, e0_cpu, _ = _ts_exact_trace("cpu", z)
    np.testing.assert_allclose(card, cpu, rtol=1e-10, atol=0)
    assert abs(e0 - e0_cpu) < 1e-12
    assert abs(trial.e_trial - e0) < 1e-8
    np.testing.assert_allclose(card[0] / card[1], e0, rtol=0, atol=1e-8)


@pytest.mark.cuda
def test_time_sym_walk_kernel_vs_plain_scan(monkeypatch):
    """A stochastic time-symmetrized walk (D = 20 dets, so most moves are
    spawns mapped to representatives) for 20 generations on the card, once
    with K1 and once with the plain scan in its place, from the same state
    and random stream: the same trace to 1e-9 relative."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    dev = _device()
    s = _ts_system(9, 3, dev)
    trial = build_trial_wavefunction(s, eps_var=2e-3, n_psi_t=30, n_imp=20)
    cfg = TW.WalkConfig(mwalk=8192, cap_spawn=16384, norb=9, nup=3, ndn=3,
                        n_words=1, tau=5e-3, w_abs_target=3000.0,
                        has_singles=True, r_initiator=0.5, time_sym=True,
                        z=1)
    tables = TW.build_walk_tables(s, trial, cfg)

    def trace():
        st = TW.init_walk_state(cfg, trial, 2000.0, trial.e_trial, tables)
        st, stats = TW.walk_block(st, tables, cfg, 20,
                                  torch.Generator(device=dev).manual_seed(5))
        return torch.stack([stats[k] for k in ("e_num_gen", "e_den_gen",
                                               "w_abs_gen", "nwalk")]
                           ).cpu().numpy(), st

    before = tseg.launches
    kern, st = trace()
    assert tseg.launches == before + 20
    u, d = st.up[:int(st.nwalk), 0].cpu(), st.dn[:int(st.nwalk), 0].cpu()
    assert bool((u <= d).all())            # representatives (norb < 63)
    monkeypatch.setattr(tseg, "seg_scan", tseg.seg_scan_plain)
    plain, _ = trace()
    assert tseg.launches == before + 20
    np.testing.assert_allclose(kern, plain, rtol=1e-9, atol=0)


# ---------------------------------------------------------------------------
# Fixed-node walks on the card: a non-symmetric projector through K2, and
# a merge with redirected spawns through K1
# ---------------------------------------------------------------------------

def _fixed_node_setup(dev, run_type, n_imp, **cfg_opts):
    """The 2x3 open real-space Hubbard lattice (2 + 2 electrons, 225 dets,
    240 sign-violating transformed elements) on `dev` with Gutzwiller
    guiding from the orbitals of h plus a small random site potential (so
    no det sits on a node), a trial with a deterministic space of at most
    n_imp dets, and the walk tables of `run_type`."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.guiding import make_gutzwiller_guiding
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_real_system
    s = make_hubbard_real_system(2, 3, 1.0, 4.0, 2, 2, pbc=False, device=dev)
    pot = 0.3 * np.random.default_rng(4).normal(size=6)
    _, phi = np.linalg.eigh(s.table.h.cpu().numpy() + np.diag(pot))
    guide = make_gutzwiller_guiding(s, g=0.7, phi_up=phi[:, :2],
                                    phi_dn=phi[:, :2])
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=40, n_imp=n_imp)
    cfg = TW.WalkConfig(mwalk=4096, cap_spawn=8192, norb=6, nup=2, ndn=2,
                        n_words=1, tau=1e-2, w_abs_target=2000.0,
                        has_singles=True, r_initiator=0.0, run_type=run_type,
                        guiding="gutzwiller", cap_fresh=2048, **cfg_opts)
    return s, guide, trial, cfg, TW.build_walk_tables(s, trial, cfg,
                                                      guide=guide)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-13)])
@pytest.mark.parametrize("run_type", ["fixed_node1", "fixed_node3"])
def test_spmv_kernel_on_fixed_node_matrix(run_type, dtype, rtol):
    """K2 on the importance-transformed fixed-node projector of the
    lattice's whole 225-det space: NOT symmetric (violators zeroed, their column
    sums on the diagonal), with explicit zeros where fixed_node3 dropped
    a violator, and with one row emptied of every off-diagonal entry.
    m = 1 (the walk's call): every row within rtol x sum_k |v_k x_k| of
    the plain version; the empty row gives exactly 0."""
    dev = _device()
    f32 = dtype == torch.float32
    _, _, trial, cfg, tab = _fixed_node_setup(
        dev, run_type, 10 ** 4, f32_state=f32, dense_proj_max=0)
    n = len(trial.imp_up)
    r, c, v = (t.cpu().numpy() for t in (tab.imp_rows, tab.imp_cols,
                                         tab.imp_vals))
    A = np.zeros((n, n))
    A[r, c] = v
    assert np.abs(A - A.T).max() > 1e-3                  # not symmetric
    off = r != c
    if run_type == "fixed_node3":
        assert (v[off] == 0).any()                       # dropped violators
    assert tab.imp_ell_vals.dtype == dtype and tab.imp_dense.numel() == 0
    empty = int(np.argmax(np.bincount(r[off], minlength=n)))
    keep = off & (r != empty)
    ec, ev, _, ep, en = tspmv.blockell_from_full_coo(
        n, r[keep], c[keep], v[keep],
        dtype=np.float32 if f32 else np.float64)
    assert en[empty] == 0
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(n),
                        device=dev).to(dtype)
    layouts = {"walk tables": (tab.imp_ell_cols, tab.imp_ell_vals,
                               tab.imp_ell_ptr, tab.imp_ell_nnz),
               "one row emptied": tuple(torch.as_tensor(a, device=dev)
                                        for a in (ec, ev, ep, en))}
    for name, (cols, vals, ptr, cnt) in layouts.items():
        before = tspmv.launches
        y = tspmv.spmv(x, cols, vals, ptr, cnt)
        assert tspmv.launches == before + 1, name
        ref = tspmv.spmv_plain(x, cols, vals, ptr, cnt)
        bound = tspmv.spmv_plain(x.abs().double(), cols, vals.abs().double(),
                                 ptr, cnt)
        assert bool(((y.double() - ref.double()).abs() <= rtol * bound).all()), name
        assert torch.equal(y, tspmv.spmv(x, cols, vals, ptr, cnt)), name
    assert float(y[empty]) == 0.0


@pytest.mark.cuda
def test_seg_scan_on_redirected_spawn_merge(monkeypatch):
    """K1 on the merge of a fixed_node1 walk, where sign-violating spawns
    were redirected to their parents (rows that share the parent's key,
    imp code 126): every generation's scan is recorded and held against
    the plain version on the same rows - integer fields (priority min,
    initiator max, C(T) index max) bit for bit, float sums within the
    rounding bound of the two association orders.  The walk runs the
    eager loop: a replayed CUDA graph calls no wrapper, so only the eager
    generations can be recorded (the graphed walk is held to the eager
    one bit for bit by test_captured_walk_equals_eager_bit_for_bit)."""
    from sqmc_tpu_torch.algo import walk as TW
    dev = _device()
    _, _, trial, cfg, tab = _fixed_node_setup(dev, "fixed_node1", 20)
    calls = []
    real = tseg.seg_scan

    def recording(fields, ops, start):
        out = real(fields, ops, start)
        calls.append((fields, ops, start, out))
        return out

    monkeypatch.setattr(tseg, "seg_scan", recording)
    st = TW.init_walk_state(cfg, trial, 1500.0, trial.e_trial, tab)
    before = tseg.launches
    st, _ = TW._walk_block_eager(st, tab, cfg, 8,
                                 torch.Generator(device=dev).manual_seed(3))
    assert tseg.launches == before + 8 and len(calls) == 8
    redirected = 0
    for fields, ops, start, got in calls:
        _check_scan(fields, ops, start, got)
        # priority value of a redirected spawn row: imp 126 -> u = 127
        redirected += int((fields[0] == 127).sum())
    assert redirected > 100
    assert not bool(st.overflow)


@pytest.mark.cuda
def test_fixed_node_walk_on_card_matches_cpu():
    """Deterministic-limit generations of a fixed_node3 walk (D = the
    whole 225-det space of the lattice, f64 state) on the card - K2 on the
    non-symmetric projector, K1 in the merge, guiding ratios on the card -
    equal the CPU's to 1e-10."""
    from sqmc_tpu_torch.algo import walk as TW

    def trace(dev):
        _, _, trial, cfg, tab = _fixed_node_setup(dev, "fixed_node3", 10 ** 4)
        st = TW.init_walk_state(cfg, trial, 1500.0, trial.e_trial, tab)
        st, stats = TW.walk_block(st, tab, cfg, 6,
                                  torch.Generator(device=dev).manual_seed(0))
        return torch.stack([stats[k] for k in ("e_num_gen", "e_den_gen",
                                               "w_abs_gen", "nwalk")]
                           ).cpu().numpy()

    dev = _device()
    before, sp_before = tseg.launches, tspmv.launches
    card = trace(dev)
    assert tseg.launches == before + 6 and tspmv.launches == sp_before + 6
    np.testing.assert_allclose(card, trace("cpu"), rtol=1e-10, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("run_type,imp", [("none", 0), ("fixed_node1", 1),
                                          ("partial_node", 1), ("vmc", 1)])
def test_dense_tables_and_generation_on_card_match_cpu(run_type, imp):
    """The dense engine's tables built on the card and one
    deterministic-limit generation (min_wt = 0: no draw) equal the CPU's
    to 1e-12."""
    from sqmc_tpu_torch.algo import densewalk as dw
    from sqmc_tpu_torch.systems.toy import make_fictitious_system
    dev = _device()
    kw = dict(bosonic=0, ham_diag_fluc=0.5, ham_offdiag_fluc=1.5,
              seed=(1, 2, 3, 5))
    cpu = make_fictitious_system(64, device="cpu", **kw)
    gpu = make_fictitious_system(64, device=dev, **kw)
    assert torch.equal(gpu.ham.cpu(), cpu.ham)
    w, g = cpu.diagonalize()
    rng = np.random.default_rng(0)
    psi_g = g.numpy() + 0.25 * rng.standard_normal(64) * g.abs().mean().item()
    psi_g[np.abs(psi_g) < 1e-3] = 1e-3
    cfg = dw.DenseWalkConfig(ndet=64, tau=0.01, w_abs_target=1000.0,
                             run_type=run_type, importance_sampling=imp,
                             partial_node_eps=0.6, min_wt=0.0)
    tc = dw.build_dense_tables(cpu, cfg, g, psi_g)
    tg = dw.build_dense_tables(gpu, cfg, g, psi_g)
    for name in dw.DenseTables._fields:
        a, b = getattr(tg, name), getattr(tc, name)
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) < 1e-12, name
    sc = dw.init_dense_state(cfg, g, psi_g, 700.0, float(w[0]), device="cpu")
    sg = dw.init_dense_state(cfg, g, psi_g, 700.0, float(w[0]), device=dev)
    sc, stc = dw.dense_walk_block(sc, tc, cfg, 1)
    sg, stg = dw.dense_walk_block(sg, tg, cfg, 1)
    assert float((sg.w.cpu() - sc.w).abs().max()) < 1e-12 * 700.0
    for f in ("e_trial", "e_est", "reweight_factor_inv", "w_abs_gen"):
        a, b = float(getattr(sg, f)), float(getattr(sc, f))
        assert abs(a - b) < 1e-12 * max(1.0, abs(b)), f
    for k in stc:
        assert float((stg[k].cpu() - stc[k]).abs().max()) < 1e-9, k


def _heg14_hci(dev, eps=2e-3):
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    s = make_heg_system(3, 0.5, 14, 7, 1.49, device=dev)
    return s, run_hci(s, eps_var=eps, eps_var_sched=[eps] * 5, verbose=False)


@pytest.mark.cuda
def test_arpack_operator_kernel_matches_plain():
    """The ARPACK operator's matvec, K2 over the float64 block-ELL layout
    on the card, against the plain SpMV on the same layout (1e-13 of the
    |H| |x| bound), and the ARPACK eigenvalues on the card against the
    CPU's (1e-10)."""
    from sqmc_tpu_torch.algo.davidson import arpack_diagonalize
    from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    dev = _device()
    s, res = _heg14_hci(dev)
    H = build_sparse_ham(s.table, res.up, res.dn, s.nup, s.ndn, s.norb)
    op = tspmv.BlockEllSpmv(H, dtype=np.float64)
    assert op.vals.dtype == torch.float64
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(H.n),
                        device=dev)
    before = tspmv.launches
    got = op(x)
    torch.cuda.synchronize()
    assert tspmv.launches == before + 1
    args = (op.cols, op.vals, op.row_ptr, op.row_nnz)
    ref = tspmv.spmv_plain(x, *args)
    bound = tspmv.spmv_plain(x.abs(), op.cols, op.vals.abs(), op.row_ptr,
                             op.row_nnz)
    assert bool(((got - ref).abs() <= 1e-13 * bound).all())
    w_card, _ = arpack_diagonalize(H, 2)
    sc = make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu")
    H_cpu = build_sparse_ham(sc.table, res.up.cpu(), res.dn.cpu(), s.nup,
                             s.ndn, s.norb)
    w_cpu, _ = arpack_diagonalize(H_cpu, 2)
    np.testing.assert_allclose(w_card, w_cpu, rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_apply_h_on_the_fly_on_card_matches_cpu():
    """The matrix-free H application of the legacy CI over a
    few-thousand-det list (HEG-14's 3,265 HCI dets) on the card against
    the CPU (1e-12)."""
    from sqmc_tpu_torch.algo.legacy_ci import apply_h_on_the_fly
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    dev = _device()
    s, res = _heg14_hci(dev)
    x = np.random.default_rng(3).standard_normal(len(res.up))
    y = apply_h_on_the_fly(s, res.up, res.dn, x, chunk=1000).cpu().numpy()
    sc = make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu")
    yc = apply_h_on_the_fly(sc, res.up.cpu(), res.dn.cpu(), x).numpy()
    np.testing.assert_allclose(y, yc, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_rdm_and_greens_on_card_match_cpu():
    """get_1rdm and greens_function_g0 of HEG-14's HCI wavefunction on the
    card against the CPU (1e-12)."""
    from sqmc_tpu_torch.algo.greens import greens_function_g0
    from sqmc_tpu_torch.algo.rdm import get_1rdm
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    dev = _device()
    s, res = _heg14_hci(dev, eps=5e-3)
    sc = make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu")
    c = res.wts[:, 0]
    up, dn = res.up.cpu(), res.dn.cpu()
    np.testing.assert_allclose(get_1rdm(s, res.up, res.dn, c),
                               get_1rdm(sc, up, dn, c), rtol=0, atol=1e-12)
    w = np.array([-1.0, 0.5, 3.0])
    e0 = float(res.energies[0])
    for a, b in zip(greens_function_g0(s, res.up, res.dn, c, e0, w, 0.1),
                    greens_function_g0(sc, up, dn, c, e0, w, 0.1)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_legacy_ci_on_card_is_reproducible():
    """The selected CI and the truncated Lanczos on the 4x4 Hubbard-k
    cluster (5 + 5), whose truncations cut through shells of equal |c|,
    give bitwise the same per-iteration energies, dets and final energies
    on two runs on the card."""
    from sqmc_tpu_torch.algo.legacy_ci import (perform_selected_ci,
                                               perform_truncated_lanczos)
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system
    s = make_hubbard_k_system(4, 4, 1.0, 4.0, 5, 5, device=_device())
    for run in (lambda: perform_selected_ci(s, iters=3, n_initiators=2000,
                                            n_truncate=2000),
                lambda: perform_truncated_lanczos(s, iters=4,
                                                  n_initiators=2000,
                                                  n_truncate=2000)):
        a, b = run(), run()
        assert a.energies_per_iter == b.energies_per_iter
        # C7 repaired: the last Davidson's COO sums are ordered too
        assert a.energy == b.energy
        assert torch.equal(a.up, b.up) and torch.equal(a.dn, b.dn)


def _random_coo(n, nnz, dev, seed=0):
    """A symmetric SparseHam on the card whose strictly-upper entries pile
    many duplicates onto few rows (the case atomics reorder)."""
    from sqmc_tpu_torch.algo.sparseham import SparseHam
    rng = np.random.default_rng(seed)
    r = np.minimum(rng.zipf(1.5, nnz), n - 1) - 1
    c = rng.integers(0, n, nnz)
    r, c = np.minimum(r, c), np.maximum(r, c)
    keep = r < c
    r, c = r[keep], c[keep]
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return SparseHam(n=n, rows=t(r), cols=t(c),
                     vals=t(rng.standard_normal(len(r))),
                     diag=t(rng.standard_normal(n) * 10.0))


@pytest.mark.cuda
def test_coo_davidson_and_unique_dets_on_card_are_reproducible():
    """C7: the COO Davidson matvec and setalg.unique_dets's payload sums
    sum in a fixed order on the card (index_put_ with accumulate, no
    atomics): two runs in one process agree bit for bit, at a size where
    index_add_'s atomics reorder the sums (rows with thousands of
    duplicate entries)."""
    from sqmc_tpu_torch.algo.davidson import davidson, matvec
    from sqmc_tpu_torch.ops import setalg
    dev = _device()
    H = _random_coo(20_000, 2_000_000, dev)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((H.n, 2)),
                        device=dev)
    assert torch.equal(matvec(H, v), matvec(H, v))
    assert torch.equal(matvec(H, v[:, 0]), matvec(H, v[:, 0]))
    e1, x1 = davidson(H, n_states=2, tol=1e-10)
    e2, x2 = davidson(H, n_states=2, tol=1e-10)
    assert np.array_equal(e1, e2) and np.array_equal(x1, x2)
    rng = np.random.default_rng(2)
    up = torch.as_tensor(rng.integers(0, 64, (1_000_000, 1)), device=dev)
    dn = torch.as_tensor(rng.integers(0, 64, (1_000_000, 1)), device=dev)
    w = torch.as_tensor(rng.standard_normal((1_000_000, 2)), device=dev)
    a = setalg.unique_dets(up, dn, [w, w[:, 0]])
    b = setalg.unique_dets(up, dn, [w, w[:, 0]])
    assert len(a[0]) == 4096
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.cuda
def test_spmv_kernel_at_the_sharded_layout():
    """K2 on one rank's rows of a sharded matrix: m_loc local rows whose
    columns index the all-gathered vector of n_glob > m_loc entries
    (parallel.dist._blockell_local, as the sharded walk's float64
    projection and the sharded Davidson call it), float32 and float64,
    against the plain version."""
    from sqmc_tpu_torch.parallel.dist import _blockell_local
    dev = _device()
    rng = np.random.default_rng(3)
    n_dev, m_loc, rank = 4, 3_000, 2
    n_glob = n_dev * m_loc
    nnz = 400_000
    rows = rng.integers(0, m_loc, nnz)
    cols = rng.integers(0, n_glob, nnz)
    vals = rng.standard_normal(nnz)
    rows = np.concatenate([rows, np.arange(m_loc)])          # the diagonal
    cols = np.concatenate([cols, rank * m_loc + np.arange(m_loc)])
    vals = np.concatenate([vals, rng.standard_normal(m_loc)])
    before = tspmv.launches
    for dt, tol in ((np.float32, 1e-3), (np.float64, 1e-10)):
        ec, ev, _, ptr, nnz_r, diag = _blockell_local(
            m_loc, rows, cols, vals, rank * m_loc, dtype=dt)
        off = cols != rank * m_loc + rows
        assert int(nnz_r.sum()) == int(off.sum())
        assert np.allclose(diag.sum(), vals[~off].sum())
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        x = t(rng.standard_normal(n_glob).astype(dt))
        got = tspmv.spmv(x, t(ec), t(ev), t(ptr), t(nnz_r))
        ref = tspmv.spmv_plain(x, t(ec), t(ev), t(ptr), t(nnz_r))
        assert got.shape == (m_loc,)
        assert float((got - ref).abs().max()) < tol
    assert tspmv.launches == before + 2


@pytest.mark.cuda
def test_det_owner_on_card_matches_numpy():
    """The owner hash on int64 words on the card equals the uint64 numpy
    one bit for bit (words with bit 63 set, W = 1 and 2, n = 1..8)."""
    from sqmc_tpu_torch.parallel.dist import det_owner, det_owner_np
    dev = _device()
    rng = np.random.default_rng(4)
    for W in (1, 2):
        up = rng.integers(-(1 << 63), (1 << 63) - 1, (100_000, W),
                          dtype=np.int64)
        dn = rng.integers(-(1 << 63), (1 << 63) - 1, (100_000, W),
                          dtype=np.int64)
        for n in range(1, 9):
            got = det_owner(torch.as_tensor(up, device=dev),
                            torch.as_tensor(dn, device=dev), n)
            assert np.array_equal(got.cpu().numpy(), det_owner_np(up, dn, n))


# ---------------------------------------------------------------------------
# The slot -> parent kernel K4
# ---------------------------------------------------------------------------

K4_CASES = ["below", "at", "above", "none", "one_walker", "childless_run",
            "tile_end", "tile_end_minus1", "cap_off_tile", "m2"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES)
def test_slot_parents_kernel_matches_plain(case):
    """K4 bit for bit against its plain version at the walk's shape (M =
    458,752 walkers, CAP = 262,144 slots) with runs of walkers without
    children, one walker owning thousands of slots, and spawn totals below,
    at and above CAP (overflow: the clip puts walker M - 1 on the last
    slot); and cases that stress the merge's split into tiles of walkers
    + slots: a run of 100,000 childless walkers inside the spawned range
    (it spans many tiles), the last walker's merge item ending a tile
    exactly (the tiles after it take the no-search path) and one item
    before that, CAP not a multiple of the tile, and M = 2."""
    from sqmc_tpu_torch.ops import slotpar
    dev = _device()
    M, cap = 458_752, 262_144
    rng = np.random.default_rng(3)
    tile = slotpar.launch_shape(M, cap, dev)["tile_items"]
    if case == "one_walker":
        nchild, cap = np.array([5]), 8
    elif case == "m2":
        nchild, cap = np.array([3000, 7]), 4099
    else:
        if case == "cap_off_tile":
            cap -= 777
            assert cap % tile
        nchild = rng.poisson(3.0, M) * (rng.random(M) < 0.5)
        nchild[1000:9000] = 0
        nchild[500] = 5000
        nchild[-20_000:] = 0
        if case == "childless_run":
            nchild[150_000:250_000] = 0
        goal = {"below": cap // 3, "at": cap, "above": 2 * cap, "none": 0,
                "childless_run": int(0.9 * cap), "cap_off_tile": cap // 2}
        if case in ("tile_end", "tile_end_minus1"):
            # the last walker of the merge (M - 2) has key cum + M - 2;
            # put it on the last item of a tile (or one item earlier)
            k = -(-(cap // 2 + M - 1) // tile)
            goal[case] = k * tile - (M - 1) - (case == "tile_end_minus1")
        goal = goal[case]
        cum = np.cumsum(nchild)
        i = int(np.searchsorted(cum, goal))
        nchild[i] -= cum[i] - goal
        nchild[i + 1:] = 0
        assert nchild.sum() == goal and (nchild >= 0).all()
        if case == "childless_run":
            assert cum[250_000] < goal
    cum = torch.cumsum(torch.as_tensor(nchild, dtype=torch.int64,
                                       device=dev), 0)
    if case.startswith("tile_end"):
        key = int(cum[-2]) + len(nchild) - 2
        assert (key + 1 + (case == "tile_end_minus1")) % tile == 0
    before = slotpar.launches
    got = slotpar.slot_parents(cum, cap)
    torch.cuda.synchronize()
    assert slotpar.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (cap,)
    assert torch.equal(got, slotpar.slot_parents_plain(cum, cap))


@pytest.mark.cuda
def test_spawn_wrappers_raise_on_bad_input():
    from sqmc_tpu_torch.ops import slotpar
    dev = _device()
    with pytest.raises(ValueError):
        slotpar.slot_parents(torch.zeros(4, dtype=torch.int32, device=dev), 8)


@pytest.mark.cuda
def test_heg14_walk_spawn_kernels_vs_plain_ops(monkeypatch):
    """Phase 3's HEG-14 walk on the card, warmed for 200 generations, then
    50 generations through K3b (the proposal) and K4 and 50 from the same
    state and seed with their plain versions patched in: the two
    mixed energies agree within 3 combined error bars (the draws differ
    where a target lies within an ulp of a cell edge, so the trajectories
    part after a few generations), and the population stays within 25% of
    its target in every generation of both."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.ops import hbspawn, slotpar
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    from sqmc_tpu_torch.utils.blocking import ratio_stats
    dev = _device()
    s = make_heg_system(3, 0.5, 14, 7, 1.49, device=dev)
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=2000,
                                     n_imp=20000)
    cfg = TW.WalkConfig(mwalk=458_752, cap_spawn=262_144, norb=s.norb, nup=7,
                        ndn=7, n_words=1, tau=2e-3, w_abs_target=2e5,
                        spawn_granularity=2.0, min_wt=0.5, r_initiator=0.5,
                        f32_state=True, has_singles=False)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 2e5, trial.e_trial, tables)
    st, _ = TW.walk_block(st, tables, cfg, 200,
                          torch.Generator(device=dev).manual_seed(1))

    def fifty():
        _, stats = TW.walk_block(st, tables, cfg, 50,
                                 torch.Generator(device=dev).manual_seed(2))
        w = stats["w_abs_gen"].cpu().numpy()
        assert np.abs(w / 2e5 - 1).max() < 0.25      # no spawn bursts
        return ratio_stats(stats["e_num_gen"].double().cpu().numpy(),
                           stats["e_den_gen"].double().cpu().numpy())

    hb0, sp0 = hbspawn.launches, slotpar.launches
    kern = fifty()
    assert hbspawn.launches == hb0 + 50 and slotpar.launches == sp0 + 50
    monkeypatch.setattr(hbspawn, "propose",
                        lambda *a: hbspawn.propose_plain(*a[:8]))
    monkeypatch.setattr(slotpar, "slot_parents", slotpar.slot_parents_plain)
    plain = fifty()
    assert hbspawn.launches == hb0 + 50 and slotpar.launches == sp0 + 50
    assert abs(kern.e_mean - plain.e_mean) <= 3 * np.hypot(kern.e_err,
                                                            plain.e_err)


# ---------------------------------------------------------------------------
# K3b: the heat-bath proposal of each slot in one kernel (ops/hbspawn.py)
# ---------------------------------------------------------------------------

SPAWN_CAPS = {"c2_f32_pack": 262_144, "heg14_f32": 262_144,
              "c2_f64_rows": 262_144, "two_words_f32_pack": 65_536,
              "heg54_f32": 262_144, "heg17_f32": 262_144,
              "heg54_f32_tail": 262_099, "norb124_r2_in_l2": 65_536}


def _wide(case, up):
    """Whether K3b takes its wide kernel in a SPAWN_CAPS case: past 16
    electrons at one word a spin."""
    import torch_spawn_emulation as se
    return se.electrons(case) > 16 and up.shape[1] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPAWN_CAPS))
def test_hb_spawn_kernel_matches_plain(case, tmp_path):
    """K3b against its plain version on the same inputs, the tables made
    exact-sum (torch_spawn_emulation.exact_sum_tables: every association
    of the selection's sums gives the same bits, so the plain selection's
    torch.cumsum and matmul give the kernel's draws): one launch; the same
    bits twice; the child's words and the flags bit for bit on every
    slot, a double's factor bit for bit, a single's factor within
    the rounding bound of reordering its two sums over the orbitals,
    2 (norb + 2) u times the magnitude of its terms (u the unit roundoff
    of its rows), plus 8 float64 roundings after them
    (torch_spawn_emulation.compare_with_plain).  Prints the largest
    difference of a single's factor in units of that magnitude's u."""
    import torch_spawn_emulation as se
    from sqmc_tpu_torch.ops import hbspawn
    dev = _device()
    cap = SPAWN_CAPS[case]
    args, _ = se.spawn_inputs(case, dev, tmp_path, cap, seed=21, exact=True)
    ne = se.electrons(case)
    before, wide0 = hbspawn.launches, hbspawn.wide_launches
    got = hbspawn.propose(*args, ne)
    torch.cuda.synchronize()
    assert hbspawn.launches == before + 1
    assert hbspawn.wide_launches == wide0 + _wide(case, args[1])
    again = hbspawn.propose(*args, ne)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    print(f"hb_spawn {case}: cap={cap} "
          + se.compare_with_plain(args, got, hbspawn.propose_plain(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPAWN_CAPS))
def test_hb_spawn_kernel_is_its_documented_arithmetic(case, tmp_path):
    """K3b bit for bit against the numpy emulation of its arithmetic
    (tests/torch_spawn_emulation.py: the selection's sequential sums, then
    each slot's ops in the plain version's order and types, a single's two
    sums in ascending q over the occupied orbitals) on the system's own
    tables, words, flags and every factor.  The synthetic case
    (norb124_r2_in_l2: two words a spin, 2 norb = 248) has an R2 too large
    for shared memory, so the kernel reads it through L1 / L2: the
    k_hb_spawn<0, false, ...> builds."""
    import torch_spawn_emulation as se
    from sqmc_tpu_torch.ops import hbspawn
    dev = _device()
    cap = SPAWN_CAPS[case] // 4
    args, (up, dn, streams) = se.spawn_inputs(case, dev, tmp_path, cap,
                                              seed=23)
    tables, _, _, norb, singles, tau, wdt, _ = args
    ne = se.electrons(case)
    got = hbspawn.propose(*args, ne)
    want = se.emulate_hb_spawn(se.table_arrays(tables), up, dn, norb,
                               hbspawn.singles_source(tables, singles, wdt),
                               wdt == torch.float64, float(tau), streams)
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy()
        if g.dtype == np.float64:
            g, w = g.view(np.int64), w.view(np.int64)
        assert np.array_equal(g, w), f"{k}: {(g != w).sum()} of {cap} differ"
    shape = hbspawn.launch_shape(cap, up.shape[1], norb, ne,
                                 wdt == torch.float64,
                                 hbspawn.singles_source(tables, singles, wdt),
                                 dev)
    print(f"hb_spawn {case} launch: " + " ".join(
        f"{k}={v}" for k, v in shape.items()))
    wide = _wide(case, up)
    assert shape["wide_ne"] == (ne if wide else 0)
    assert shape["reg_ne"] == (16 if up.shape[1] == 1 and not wide else 0)
    assert shape["r2_in_smem"] == (2 * norb < 240)
    assert shape["spill_bytes"] == 0
    from sqmc_tpu_torch.ops import cudabuild
    ptxas = [x for x in cudabuild.ptxas_summary("hbselect.cu")
             if "k_hb_spawn" in x]
    assert len(ptxas) == 16 and all("0 bytes spill stores" in x
                                    for x in ptxas), ptxas


@pytest.mark.cuda
def test_hb_spawn_wrapper_raises_on_bad_input(tmp_path):
    import dataclasses

    import torch_spawn_emulation as se
    from sqmc_tpu_torch.ops import hbspawn
    dev = _device()
    args, _ = se.spawn_inputs("c2_f32_pack", dev, tmp_path, 64, seed=1)
    tables, up, dn, norb, singles, tau, wdt, streams = args
    bad = [
        (tables, up.int(), dn.int(), norb, singles, tau, wdt, streams),
        (tables, up, dn, norb, singles, tau, wdt,
         [u.float() for u in streams]),
        (tables, up, dn.cpu(), norb, singles, tau, wdt, streams),
        (tables, up, dn, norb, singles, float(tau), wdt, streams),
        (tables, up, dn, norb, singles, tau, torch.float64, streams),
        (tables._replace(R2=tables.R2.double()), up, dn, norb, singles, tau,
         wdt, streams),
        (tables._replace(sng_pack=torch.zeros((0, 0), device=dev),
                         table=dataclasses.replace(tables.table,
                                                   sing_dir=None)),
         up, dn, norb, singles, tau, wdt, streams)]
    for a in bad:
        with pytest.raises(ValueError):
            hbspawn.propose(*a, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c2_f32_pack", "c2_f64_rows", "heg14_f32"])
def test_hb_spawn_wide_kernel_takes_any_det(case, tmp_path):
    """K3b's wide kernel (launched for a walk of 17 electrons) on dets of
    8 or 14: every slot's outputs equal the register kernel's bit for bit,
    with singles from sng_pack and from the float64 rows; the electron
    count picks the kernel, not the result."""
    import torch_spawn_emulation as se
    from sqmc_tpu_torch.ops import hbspawn
    dev = _device()
    args, _ = se.spawn_inputs(case, dev, tmp_path, 65_536, seed=29)
    wide0 = hbspawn.wide_launches
    regs = hbspawn.propose(*args, se.electrons(case))
    wide = hbspawn.propose(*args, 17)
    assert hbspawn.wide_launches == wide0 + 1
    for r, w in zip(regs, wide):
        if r.dtype == torch.float64:
            r, w = r.view(torch.int64), w.view(torch.int64)
        assert torch.equal(r, w)


@pytest.mark.cuda
def test_hb_spawn_two_words_at_the_pw81_cell_shape_graphed():
    """K3b at the shape of the benchmark's heg54-pw81.walk cell: 54
    electrons in 81 plane waves, two words a spin, float32, no singles,
    262,144 slots.  It launches the NW = 0 instantiation (no register
    path, no wide kernel: mu summed again each pass) with R2 in shared
    memory; captured in a CUDA graph and replayed, its outputs equal the
    eager launch's bit for bit and the plain version's
    (torch_spawn_emulation.compare_with_plain) on exact-sum tables."""
    import torch_spawn_emulation as se
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.ops import hbspawn
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    dev = _device()
    s = make_heg_system(3, 0.5, 54, 27, 2.5, device=dev)
    trial = build_trial_wavefunction(s, eps_var=5e-2, n_psi_t=5, n_imp=5)
    cfg = TW.WalkConfig(mwalk=8192, cap_spawn=8192, norb=s.norb, nup=27,
                        ndn=27, n_words=s.n_words, tau=2.155e-4,
                        w_abs_target=1e3, has_singles=False, f32_state=True)
    assert (s.norb, s.n_words) == (81, 2)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, 1e3, trial.e_trial, tables)
    n, cap = int(st.nwalk), 262_144
    up, dn, streams = se.slot_inputs(np.random.default_rng(31), cap, 81, 27,
                                     27, (st.up[:n].cpu().numpy(),
                                          st.dn[:n].cpu().numpy()))
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    args = (se.exact_sum_tables(tables), t(up), t(dn), 81, False, st.tau,
            torch.float32, [t(u) for u in streams])
    src = hbspawn.singles_source(args[0], False, torch.float32)
    shape = hbspawn.launch_shape(cap, 2, 81, 54, False, src, dev)
    assert shape["reg_ne"] == 0 and shape["wide_ne"] == 0
    assert shape["r2_in_smem"] == 1 and shape["spill_bytes"] == 0
    eager = hbspawn.propose(*args, 54)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        hbspawn.propose(*args, 54)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = hbspawn.propose(*args, 54)
    before = hbspawn.launches
    graph.replay()
    torch.cuda.synchronize()
    assert hbspawn.launches == before
    for g, e in zip(got, eager):
        if g.dtype == torch.float64:
            g, e = g.view(torch.int64), e.view(torch.int64)
        assert torch.equal(g, e)
    print("hb_spawn heg54pw81 graphed: " + " ".join(
        f"{k}={v}" for k, v in shape.items()) + " "
        + se.compare_with_plain(args, got, hbspawn.propose_plain(*args)))


# ---------------------------------------------------------------------------
# The rows the uniform / Cauchy-Schwarz proposals draw from
# ---------------------------------------------------------------------------

FLAT_CAP = 262_144


@pytest.fixture(scope="module")
def c2_proposal_tables(tmp_path_factory):
    """The synthetic C2-shaped system (26 orbitals, 4 + 4 electrons) on the
    card, with its walk tables under the two proposals that build rows."""
    dev = _device()
    from sqmc_tpu_torch.algo.walk import WalkConfig, build_walk_tables
    from sqmc_tpu_torch.parallel.dryrun import small_c2
    from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump
    path = str(tmp_path_factory.mktemp("proposal_rows") / "FCIDUMP")
    write_c2_fcidump(path)
    s, trial = small_c2(path, dev)
    out = {}
    for proposal in ("uniform", "cauchy_schwarz"):
        cfg = WalkConfig(mwalk=1024, cap_spawn=1024, norb=s.norb, nup=s.nup,
                         ndn=s.ndn, n_words=s.n_words, tau=1e-3,
                         w_abs_target=1e3, has_singles=True, proposal=proposal)
        out[proposal] = (cfg, build_walk_tables(s, trial, cfg))
    return dev, out


def _flat_dets(dev, seed):
    """FLAT_CAP random 4 + 4 electron dets over 26 orbitals on the card."""
    rng = np.random.default_rng(seed)
    up, dn = (torch.as_tensor(_random_dets(rng, FLAT_CAP + 14, 26, 4)[14:],
                              device=dev) for _ in range(2))
    return rng, up, dn


def _row_counts(rows, w, drawn):
    """(draws that landed on a zero weight, nonzero cells at zero weights,
    rows that decrease somewhere) of the running sums `rows` of `w`."""
    cells = torch.diff(rows, dim=1, prepend=torch.zeros_like(rows[:, :1]))
    zero = w == 0
    return (int(zero.gather(1, drawn[:, None]).sum()),
            int((zero & (cells != 0)).sum()),
            int((cells < 0).any(dim=1).sum()))


@pytest.mark.cuda
def test_proposal_singles_rows_are_flat_on_card(c2_proposal_tables):
    """The singles draw of the uniform / Cauchy-Schwarz proposals at 6b's
    chem shape (2n = 52, u_rowsum of the synthetic file): no draw lands on
    an empty spin-orbital, every empty spin-orbital's cell is exactly 0
    and every row is monotone.  Printed beside them: the same counts for
    torch.cumsum rows, the construct flat_cumsum replaced."""
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.ops import hbselect
    dev, t = c2_proposal_tables
    _, tables = t["cauchy_schwarz"]
    rng, up, dn = _flat_dets(dev, 13)
    bits2 = torch.cat([dets.to_bits(up, 26), dets.to_bits(dn, 26)],
                      dim=1).to(torch.float32)
    u_pick = torch.as_tensor(rng.random(FLAT_CAP), device=dev)
    o_s, utot, c_s = hbselect.singles_rows(bits2, tables.u_rowsum, u_pick)
    w = bits2 * tables.u_rowsum.to(torch.float32).repeat(2)[None, :]
    rows = hbselect.flat_cumsum(w)
    assert torch.equal(utot, rows[:, -1])
    assert torch.equal(c_s, hbselect.sel_cell(rows, o_s))
    got = _row_counts(rows, w, o_s)
    tree = torch.cumsum(w, dim=1)
    old = _row_counts(tree, w, hbselect.count_le(
        tree, (u_pick * tree[:, -1]).to(torch.float32), 51))
    print(f"flat rows singles {FLAT_CAP} slots: flat_cumsum {got} "
          f"torch.cumsum {old}")
    assert got == (0, 0, 0), (got, old)


@pytest.mark.cuda
@pytest.mark.parametrize("proposal", ["uniform", "cauchy_schwarz"])
def test_proposal_pair_rows_are_flat_on_card(c2_proposal_tables, proposal):
    """The pair draw of both proposals at the same shape (28 electron pairs
    a det): no draw lands on a zero-weight pair, every zero-weight pair's
    cell is exactly 0 and every row is monotone (printed beside the counts
    of torch.cumsum rows)."""
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.algo.walk import pair_weights
    from sqmc_tpu_torch.ops import hbselect
    dev, t = c2_proposal_tables
    cfg, tables = t[proposal]
    rng, up, dn = _flat_dets(dev, 14)
    _, _, w = pair_weights(cfg, tables, dets.to_bits(up, 26),
                           dets.to_bits(dn, 26), torch.float64)
    w = w.to(torch.float32)
    u = torch.as_tensor(rng.random(FLAT_CAP), device=dev)
    counts = []
    for rows in (hbselect.flat_cumsum(w), torch.cumsum(w, dim=1)):
        drawn = hbselect.count_le(rows, (u * rows[:, -1]).to(torch.float32),
                                  w.shape[1] - 1)
        counts.append(_row_counts(rows, w, drawn))
    print(f"flat rows {proposal} pairs {FLAT_CAP} slots, zero weights "
          f"{int((w == 0).sum())}: flat_cumsum {counts[0]} torch.cumsum "
          f"{counts[1]}")
    assert counts[0] == (0, 0, 0), counts


@pytest.mark.cuda
@pytest.mark.parametrize("width", [52, 260, 1024])
def test_flat_cumsum_on_card_at_widths(width):
    """flat_cumsum of [65,536, width] weights over two decades with zeros
    (30% scattered, runs at both ends) on the card: every zero weight's
    cell exactly 0, every row monotone, and the sums at positive weights
    those of torch.cumsum (printed: torch.cumsum's own counts)."""
    from sqmc_tpu_torch.ops import hbselect
    dev = _device()
    rng = np.random.default_rng(width)
    w = 10.0 ** rng.uniform(-1, 1, (65_536, width))
    w[rng.random(w.shape) < 0.3] = 0.0
    w[:, :3] = w[:, -4:] = 0.0
    w = torch.as_tensor(w.astype(np.float32), device=dev)
    u = torch.as_tensor(rng.random(w.shape[0]), device=dev)
    counts = []
    tree = torch.cumsum(w, dim=1)
    flat = hbselect.flat_cumsum(w)
    for rows in (flat, tree):
        drawn = hbselect.count_le(rows, (u * rows[:, -1]).to(torch.float32),
                                  width - 1)
        counts.append(_row_counts(rows, w, drawn))
    print(f"flat rows width {width}: flat_cumsum {counts[0]} torch.cumsum "
          f"{counts[1]}")
    assert counts[0] == (0, 0, 0), counts
    assert torch.equal(flat[w > 0], tree[w > 0])


@pytest.mark.cuda
def test_entry_runs_a_generation_on_card():
    """entry()'s fn on the card: finite outputs of __graft_entry__'s
    shapes and dtypes, launching K1, K2 (the float64 projector), K3b, K4
    and K6 once a call."""
    from sqmc_tpu_torch.entry import entry
    from sqmc_tpu_torch.ops import (ctchain, hbspawn, segscan, slotpar,
                                    spawnhist, spmv)
    mods = (segscan, spmv, hbspawn, slotpar, spawnhist, ctchain)
    dev = _device()
    fn, (state, tables) = entry()
    before = [m.launches for m in mods]
    for _ in range(3):
        wt, e_num, w_abs = fn(state, tables)
    assert [m.launches - b for m, b in zip(mods, before)] == [3, 3, 3, 3, 3, 0]
    assert wt.device.type == "cuda" and wt.shape == (2048,)
    assert wt.dtype == e_num.dtype == w_abs.dtype == torch.float64
    assert e_num.shape == w_abs.shape == ()
    assert bool(torch.isfinite(wt).all()) and float(w_abs) > 0
    assert bool(torch.isfinite(e_num))


# ---------------------------------------------------------------------------
# The captured walk: on the card walk_block / walk_step replay one CUDA
# graph of the generation (utils/cudagraph.py); _walk_block_eager, the
# eager loop, is the reference, bit for bit
# ---------------------------------------------------------------------------

GRAPH_CELLS = ("bench", "heg14_f32", "heg14_f32_sequential", "entry_f64",
               "ct_hubbardk", "cauchy_schwarz", "uniform", "heg54pw81_f32")


def _graph_cell(name, dev):
    """(system, trial, cfg, w_abs_begin) of a walk the repo runs on the
    card, at its full width: the port's bench (synthetic C2-shaped file,
    heat-bath with singles, f32 state, bf16 dense projector), chip_smoke's
    HEG-14 f32 cell (also under the sequential initiator rule, K5 in the
    merge), entry()'s f64 walk (its D projection through K2),
    phase 7a's continuous-time chain on the 4x4 Hubbard-k cluster,
    phase 11c's two proposals on the bench's file (twice its capacities:
    these walks outgrow the bench's) and the gas of the benchmark's
    heg54-pw81.walk cell (54 electrons in 81 plane waves, two words a
    spin: K3b's NW = 0 path, the merge on four key words) with a smaller
    trial and population, at four times the capacities (its population
    overshoots the start's ~4.7-fold in the first 60 generations)."""
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig
    big = dict(mwalk=458_752, cap_spawn=262_144, w_abs_target=2e5,
               min_wt=0.5, f32_state=True, has_singles=False)
    if name in ("bench", "cauchy_schwarz", "uniform"):
        from sqmc_tpu_torch import bench
        s, trial, _, _ = bench.system_and_trial(dev, bench.WORKDIR,
                                                **bench.TRIAL)
        knobs = dict(bench.WALK)
        if name != "bench":
            knobs.update(proposal=name, mwalk=2 * knobs["mwalk"],
                         cap_spawn=2 * knobs["cap_spawn"])
        return s, trial, WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn,
                                    n_words=s.n_words, **knobs), \
            bench.RUN["w_abs_begin"]
    if name == "heg54pw81_f32":
        from sqmc_tpu_torch.systems.heg.system import make_heg_system
        s = make_heg_system(3, 0.5, 54, 27, 2.5, device=dev)
        trial = build_trial_wavefunction(s, eps_var=1e-2, n_psi_t=500,
                                         n_imp=2000)
        assert s.n_words == 2
        return s, trial, WalkConfig(norb=s.norb, nup=27, ndn=27, n_words=2,
                                    tau=2.155e-4, spawn_granularity=2.0,
                                    r_initiator=0.5, pop_ctrl_exponent=92.8,
                                    **dict(big, mwalk=4 * big["mwalk"],
                                           cap_spawn=4 * big["cap_spawn"])), \
            1.4e5
    if name.startswith("heg14_f32"):
        from sqmc_tpu_torch.systems.heg.system import make_heg_system
        s = make_heg_system(3, 0.5, 14, 7, 1.49, device=dev)
        trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=2000,
                                         n_imp=20000)
        rule = "sequential" if name.endswith("sequential") else "group_max"
        return s, trial, WalkConfig(norb=s.norb, nup=7, ndn=7, n_words=1,
                                    tau=2e-3, spawn_granularity=2.0,
                                    r_initiator=0.5, initiator_rule=rule,
                                    **big), 1.4e5
    if name == "entry_f64":
        import os
        from sqmc_tpu_torch import entry as E
        from sqmc_tpu_torch.parallel.dryrun import FCIDUMP_NAME, small_c2
        from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump
        os.makedirs(E.WORKDIR, exist_ok=True)
        path = os.path.join(E.WORKDIR, FCIDUMP_NAME)
        write_c2_fcidump(path)
        s, trial = small_c2(path, dev)
        return s, trial, WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn,
                                    n_words=s.n_words, **E.WALK), \
            E.W_ABS_BEGIN
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system
    s = make_hubbard_k_system(4, 4, 1.0, 4.0, 5, 5, device=dev)
    trial = build_trial_wavefunction(s, eps_var=1e-2, n_psi_t=2000, n_imp=1)
    return s, trial, WalkConfig(norb=s.norb, nup=5, ndn=5, n_words=1,
                                tau=5e-3, semistochastic=False,
                                use_exponential_projector=True,
                                r_initiator=1.0, **big), 1.6e5


def _assert_same_walk(a, b, sa, sb):
    """Two walk states and their block stats equal bit for bit."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def _kernel_counts():
    from sqmc_tpu_torch.ops import (ctchain, hbspawn, segscan, seqinit,
                                    slotpar, spawnhist, spmv)
    return [m.launches for m in (segscan, spmv, slotpar, seqinit, hbspawn,
                                 spawnhist, ctchain)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_CELLS)
def test_captured_walk_equals_eager_bit_for_bit(name):
    """50 generations, then 25 more from the returned state, through
    walk_block (one captured generation replayed) and through
    _walk_block_eager from one seed: the state arrays, the per-generation
    trace and the spawn histogram equal bit for bit, so do the
    generators' states after each block (replays continue the walk's own
    Philox stream), and the kernel launch counts of the graphed blocks
    equal the eager blocks' (K1, K3b, K4 in every cell but the CT chain and
    the two proposals, which run no K3b; K2 in entry()'s f64 walk; K5 under
    the sequential rule; K6 in every cell; K7 in the CT chain's): K3b, K6
    and K7 once a generation, n in a block of n."""
    from sqmc_tpu_torch.algo import walk as TW
    dev = _device()
    s, trial, cfg, w0 = _graph_cell(name, dev)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, w0, trial.e_trial, tables)
    g_e = torch.Generator(device=dev).manual_seed(17)
    g_g = torch.Generator(device=dev).manual_seed(17)
    a = b = st
    for n in (50, 25):
        c0 = _kernel_counts()
        a, sa = TW._walk_block_eager(a, tables, cfg, n, g_e)
        c1 = _kernel_counts()
        b, sb = TW.walk_block(b, tables, cfg, n, g_g)
        c2 = _kernel_counts()
        _assert_same_walk(a, b, sa, sb)
        assert torch.equal(g_e.get_state(), g_g.get_state())
        eager = [y - x for x, y in zip(c0, c1)]
        assert [y - x for x, y in zip(c1, c2)] == eager
        assert eager[4] in (0, n) and eager[5] == n and eager[6] in (0, n)
    assert not bool(b.overflow) and int(b.nwalk) > 1000
    want = {"bench": [1, 0, 1, 0, 1, 1, 0], "heg14_f32": [1, 0, 1, 0, 1, 1, 0],
            "heg14_f32_sequential": [1, 0, 1, 1, 1, 1, 0],
            "entry_f64": [1, 1, 1, 0, 1, 1, 0],
            "ct_hubbardk": [1, 0, 1, 0, 0, 1, 1],
            "cauchy_schwarz": [1, 0, 1, 0, 0, 1, 0],
            "uniform": [1, 0, 1, 0, 0, 1, 0],
            "heg54pw81_f32": [1, 0, 1, 0, 1, 1, 0]}[name]
    assert [int(d > 0) for d in eager] == want, eager
    g = TW._GRAPH[next(iter(TW._GRAPH))]
    print(f"captured {name}: capture_seconds={g.capture_seconds:.3f} "
          f"pool_MB={g.pool_bytes / 2**20:.1f} replays={g.replays}")
    TW.release_graphs()


@pytest.mark.cuda
def test_wrapped_proposal_doubles_the_captured_spawns(monkeypatch):
    """The seam that the benchmark's planted faults use: algo/walk.py's
    _propose replaced by a wrapper that doubles its factor (and the
    captured generation dropped) makes the captured generation spawn with
    twice the weights.  The kernel runs inside the wrapped function (one
    launch a generation); the graphed generation with the wrapper equals
    the eager one with it bit for bit and differs from the unwrapped one;
    what the wrapper handed on in the replay is twice what it got."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.ops import hbspawn
    dev = _device()
    s, trial, cfg, w0 = _graph_cell("bench", dev)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, w0, trial.e_trial, tables)
    st, _ = TW._walk_block_eager(st, tables, cfg, 20,
                                 torch.Generator(device=dev).manual_seed(3))
    orig = TW._propose
    seen = {}

    def doubled(*a):
        su, sd, fac, ok = orig(*a)
        seen["got"], seen["out"] = fac, 2 * fac
        return su, sd, seen["out"], ok

    def one(block, propose):
        monkeypatch.setattr(TW, "_propose", propose)
        TW.release_graphs()
        out = block(st, tables, cfg, 1,
                    torch.Generator(device=dev).manual_seed(4))
        torch.cuda.synchronize()
        return out

    k0 = hbspawn.launches
    plain, _ = one(TW.walk_block, orig)
    eager, se_ = one(TW._walk_block_eager, doubled)
    graph, sg = one(TW.walk_block, doubled)
    assert hbspawn.launches == k0 + 3
    _assert_same_walk(eager, graph, se_, sg)
    assert torch.equal(seen["out"], 2 * seen["got"])
    assert float(seen["got"].abs().sum()) > 0
    assert not torch.equal(plain.wt, graph.wt)
    TW.release_graphs()


@pytest.mark.cuda
def test_ct_walk_graphed_block_counts_its_chains_and_marks_their_end():
    """Phase 7a's continuous-time walk (4x4 Hubbard-k, tau 5e-3): a
    graphed block equals the eager block from one seed bit for bit, the
    CT chain's two counters included; the chain jumps in every
    generation, about tau rate / (1 - exp(-tau rate)) = 1.18 jumps a
    child; and mark 2, the chain's end, is written in every generation of
    both blocks, in time order inside the spawn piece."""
    from sqmc_tpu_torch.algo import walk as TW
    dev = _device()
    s, trial, cfg, w0 = _graph_cell("ct_hubbardk", dev)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, w0, trial.e_trial, tables)
    n = 20
    a, sa = TW._walk_block_eager(st, tables, cfg, n,
                                 torch.Generator(device=dev).manual_seed(23))
    m_eager = TW._LAST_BLOCK["marks"].read(n)
    b, sb = TW.walk_block(st, tables, cfg, n,
                          torch.Generator(device=dev).manual_seed(23))
    torch.cuda.synchronize()
    _assert_same_walk(a, b, sa, sb)
    rep = TW.block_report()
    m_graph = TW._LAST_BLOCK["marks"].read(n)
    for m in (m_eager, m_graph):
        assert (m > 0).all() and (np.diff(m.reshape(-1)) >= 0).all()
    assert 0 < rep["sub_ns"]["propose"] <= rep["piece_ns"]["spawn"]
    assert bool((sb["n_ct_jumps"] > 0).all())
    assert rep["n_ct_cut"] == float(sb["n_ct_cut"].sum())
    per_child = rep["n_ct_jumps"] / rep["n_spawn_ok"]
    assert 1.0 < per_child < 1.4, per_child
    print(f"ct chain: {per_child:.4f} jumps a child, "
          f"{rep['n_ct_cut']:.0f} chains cut in {n} generations, propose "
          f"{rep['sub_ns']['propose'] * 1e-6:.3f} ms of spawn "
          f"{rep['piece_ns']['spawn'] * 1e-6:.3f} ms a generation")
    TW.release_graphs()


@pytest.mark.cuda
def test_replayed_generations_never_sync():
    """Replayed blocks and steps run under torch's sync debug mode set to
    raise: the only host reads of a graphed block are repair_caches'
    flag before it (outside the replays) and run_walk's overflow flag
    after it."""
    from sqmc_tpu_torch.algo import walk as TW
    dev = _device()
    s, trial, cfg, w0 = _graph_cell("entry_f64", dev)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, w0, trial.e_trial, tables)
    gen = torch.Generator(device=dev).manual_seed(0)
    st, _ = TW.walk_block(st, tables, cfg, 5, gen)          # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, stats = TW._replay_block(st, tables, cfg, 20, gen)
        nxt, one = TW._step_graph(st, tables, cfg, gen, 1).step(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(stats["w_abs_gen"]).all())
    assert int(nxt.step) == 26 and float(one["w_abs_gen"]) > 0
    TW.release_graphs()


def _small_c2(dev):
    import os
    from sqmc_tpu_torch import entry as E
    from sqmc_tpu_torch.parallel.dryrun import FCIDUMP_NAME, small_c2
    from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump
    os.makedirs(E.WORKDIR, exist_ok=True)
    path = os.path.join(E.WORKDIR, FCIDUMP_NAME)
    write_c2_fcidump(path)
    return small_c2(path, dev)


@pytest.mark.cuda
def test_overflowing_block_is_recaptured_at_twice_the_capacity(monkeypatch):
    """entry()'s walk at capacities its population outgrows: run_walk
    grows them and reruns the block, capturing the generation again for
    the grown arrays; the graphed run equals the eager one (walk_block
    replaced by _walk_block_eager) bit for bit, growths included."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.utils import cudagraph
    dev = _device()
    s, trial = _small_c2(dev)
    cfg = TW.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn, n_words=s.n_words,
                        mwalk=256, cap_spawn=512, tau=1e-3,
                        w_abs_target=1000.0, has_singles=True)
    sizes = []

    class Spy(cudagraph.StepGraph):
        def __init__(self, step, state, *a, **k):
            sizes.append(state.up.shape[0])
            super().__init__(step, state, *a, **k)

    def run():
        return TW.run_walk(s, trial, cfg, nstep=20, nblk=2, nblk_eq=2,
                           w_abs_begin=500.0, e_trial_initial=trial.e_trial,
                           verbose=False, max_eq_extensions=0, seed=3)

    monkeypatch.setattr(TW, "StepGraph", Spy)
    graphed = run()
    assert graphed.capacity_grows >= 1
    assert max(sizes) == 256 * 2 ** graphed.capacity_grows, sizes
    assert not TW._GRAPH                    # run_walk freed its graph
    monkeypatch.setattr(TW, "walk_block", TW._walk_block_eager)
    eager = run()
    assert eager.capacity_grows == graphed.capacity_grows
    for k in ("e_blocks", "w_abs_trace", "nwalk_trace", "spawn_hist"):
        np.testing.assert_array_equal(getattr(graphed, k), getattr(eager, k))
    _assert_same_walk(graphed.state, eager.state, {}, {})


@pytest.mark.cuda
def test_checkpoint_after_graphed_blocks_resumes_the_same_walk(
        tmp_path, monkeypatch):
    """run_walk writes a checkpoint (the generator's state included) after
    graphed blocks; a run resumed from it draws what the uninterrupted
    graphed run draws, and both equal the uninterrupted eager run: the
    generator's offset after replays is the eager loop's."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.utils import checkpoint as TC
    dev = _device()
    s, trial = _small_c2(dev)
    cfg = TW.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn, n_words=s.n_words,
                        mwalk=4096, cap_spawn=8192, tau=1e-3,
                        w_abs_target=1000.0, has_singles=True)
    kw = dict(nstep=20, w_abs_begin=500.0, e_trial_initial=trial.e_trial,
              verbose=False, max_eq_extensions=0)
    ck = str(tmp_path / "walk_ck")
    full = TW.run_walk(s, trial, cfg, nblk=2, nblk_eq=1, seed=11, **kw)
    TW.run_walk(s, trial, cfg, nblk=1, nblk_eq=1, seed=11,
                checkpoint_file=ck, **kw)
    mid = TC.load_walker_state(ck, cfg, device=dev)
    assert int(mid.step) == 40 and mid.rng_state is not None
    rest = TW.run_walk(s, trial, cfg, nblk=1, nblk_eq=0, seed=999,
                       resume_state=mid, **kw)
    assert rest.e_blocks[0] == full.e_blocks[1]
    np.testing.assert_array_equal(rest.w_abs_trace, full.w_abs_trace[40:])
    _assert_same_walk(full.state, rest.state, {}, {})
    monkeypatch.setattr(TW, "walk_block", TW._walk_block_eager)
    eager = TW.run_walk(s, trial, cfg, nblk=2, nblk_eq=1, seed=11, **kw)
    np.testing.assert_array_equal(eager.w_abs_trace, full.w_abs_trace)
    _assert_same_walk(full.state, eager.state, {}, {})


# ---------------------------------------------------------------------------
# K5: the sequential initiator combine (ops/seqinit.py, csrc/seqinit.cu)
# ---------------------------------------------------------------------------

SEQ_N = 458_752 + 262_144              # the walk's merge rows: mwalk + cap
SEQ_LONG = 100_000                     # one group this long


def seq_rows(n, seed, wdt, long_group=SEQ_LONG):
    """n merge rows in groups of 1 to ~20 rows (a third single rows), one
    group of `long_group` rows at a random place, weights mixing exact ties
    and zeros with floats whose running sums round, initiators 0-3."""
    rng = np.random.default_rng(seed)
    starts = rng.random(n) < 0.45
    at = int(rng.integers(1, n - long_group))
    starts[at:at + long_group] = False
    starts[at] = True
    starts[at + long_group] = True
    starts[0] = True
    ties = rng.choice([-2.0, -1.0, 1.0, 2.0, 0.0], n)
    floats = rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e3], n)
    wts = np.where(rng.random(n) < 0.5, ties, floats).astype(wdt)
    return starts, wts, rng.integers(0, 4, n).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", [np.float32, np.float64], ids=["f32", "f64"])
def test_seq_init_kernel_matches_plain(wdt):
    """K5 against its plain version (run on the CPU, its home: the rank
    passes number the longest group, 1e5 here), bit for bit, at the walk's
    merge length with one group of 1e5 rows; a second call gives the same
    bits, and each call counts one launch."""
    from sqmc_tpu_torch.ops import seqinit
    dev = _device()
    starts, wts, inits = seq_rows(SEQ_N, 5, wdt)
    args = [torch.as_tensor(x) for x in (starts, wts, inits)]
    before = seqinit.launches
    got = seqinit.sequential_initiator(*[a.to(dev) for a in args])
    again = seqinit.sequential_initiator(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    assert seqinit.launches == before + 2
    assert got.dtype == torch.int32 and got.shape == (SEQ_N,)
    ref = seqinit.sequential_initiator_plain(*args)
    assert torch.equal(got.cpu(), ref) and torch.equal(got, again)


SEQ_TILE = 2048                        # the kernel's tile (csrc/seqinit.cu)
SEQ_EMPTY = 582_030                    # HEG-14's group of empty slots


def seq_zero_rows(case, wdt):
    """Zero-heavy rows for the skip of the zero-weight runs (row 0 starts a
    group):
    walk           the walk's merge rows: 720,896, the first 138,866 of
                   occupied dets in short groups (15% dead walkers' zero
                   rows), then one group of 582,030 empty slots of weight 0;
    tile_crossing  zero runs of 1,000-6,000 rows across every tile boundary,
                   inside groups whose active rows lie on both sides;
    one_active     every weight zero and no start but row 0;
    ragged         N not a multiple of the tile (7 tiles + 1,237 rows),
                   30% zeros in short groups;
    wide_codes     a group of 12,000 rows, 20% zeros, whose initiators
                   leave 0-3 (-2 to 6) in its middle third (the warp
                   walk's maps carry any int32 initiator);
    nan_gaps       groups that start with weight 0 (initiator 1 or 2),
                   then zero rows, then a NaN weight, whose result z at
                   the gap decides; at every tile boundary one such group
                   whose NaN row lies in the next tile (the warp walk's
                   gap);
    n1             one row of weight 0."""
    rng = np.random.default_rng(sum(map(ord, case)))
    ties = [-2.0, -1.0, 1.0, 2.0]
    if case == "walk":
        occ = SEQ_N - SEQ_EMPTY
        starts = np.zeros(SEQ_N, bool)
        starts[:occ] = rng.random(occ) < 0.4
        starts[occ] = True
        w = np.where(rng.random(occ) < 0.5, rng.choice(ties, occ),
                     rng.standard_normal(occ) * rng.choice([1e-3, 1.0, 1e3],
                                                          occ))
        w[rng.random(occ) < 0.15] = 0.0
        wts = np.concatenate([w, np.zeros(SEQ_EMPTY)])
    elif case == "tile_crossing":
        n = 40 * SEQ_TILE + 300
        starts = rng.random(n) < 0.3
        wts = rng.choice(ties, n) * rng.random(n)
        for b in range(SEQ_TILE, n, SEQ_TILE):
            lo, hi = b - int(rng.integers(1, 3000)), b + int(rng.integers(0, 3000))
            starts[lo:min(hi, n)] = False
            wts[lo:min(hi, n)] = 0.0
    elif case == "one_active":
        n = 3 * SEQ_TILE + 5
        starts, wts = np.zeros(n, bool), np.zeros(n)
    elif case == "ragged":
        n = 7 * SEQ_TILE + 1237
        starts = rng.random(n) < 0.45
        wts = rng.choice(ties + [0.0, 0.0], n)
    elif case == "wide_codes":
        n = 20_000
        starts = rng.random(n) < 0.4
        starts[4000:16_000] = False
        starts[4000] = starts[16_000] = True
        wts = rng.choice(ties + [0.5, -0.5], n) * (rng.random(n) > 0.2)
    elif case == "nan_gaps":
        n = 20 * SEQ_TILE
        starts = np.zeros(n, bool)
        wts = np.ones(n)
        for a in range(0, n - 16, 16):        # away from the boundaries
            if 32 <= a % SEQ_TILE < SEQ_TILE - 16:
                starts[a] = True
                wts[a:a + 14] = 0.0
                wts[a + 14] = np.nan
        for b in range(SEQ_TILE, n, SEQ_TILE):   # across them
            starts[b - 8] = True
            wts[b - 8:b + 6] = 0.0
            wts[b + 6] = np.nan
    else:                                      # n1
        starts, wts = np.zeros(1, bool), np.zeros(1)
    starts[0] = True
    inits = rng.integers(0, 4, starts.shape[0]).astype(np.int32)
    if case == "nan_gaps":
        inits[starts] = rng.integers(1, 3, int(starts.sum()))
    if case == "wide_codes":
        inits[8000:12_000] = rng.integers(-2, 7, 4000)
    return starts, wts.astype(wdt), inits


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walk", "tile_crossing", "one_active",
                                  "ragged", "wide_codes", "nan_gaps", "n1"])
@pytest.mark.parametrize("wdt", [np.float32, np.float64], ids=["f32", "f64"])
def test_seq_init_kernel_matches_plain_on_zero_heavy_rows(wdt, case):
    """K5 skips the zero-weight rows that start no group: bit for bit its
    plain version (on the CPU) on the walk's merge rows (one zero group of
    582,030 rows), zero runs across tile boundaries, one active row in
    all, ragged lengths, a long group with initiators outside 0-3, and
    NaN weights after zero runs; each call counts one launch."""
    from sqmc_tpu_torch.ops import seqinit
    dev = _device()
    args = [torch.as_tensor(x) for x in seq_zero_rows(case, wdt)]
    before = seqinit.launches
    got = seqinit.sequential_initiator(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    assert seqinit.launches == before + 1
    stats = {}
    ref = seqinit.sequential_initiator_plain(*args, stats=stats)
    assert torch.equal(got.cpu(), ref)
    if case == "one_active":
        assert stats["active"] == 1
    if case == "walk":
        assert stats["passes"] < 100


@pytest.mark.cuda
def test_seq_init_in_captured_graph_equals_eager():
    """K5 captured in a CUDA graph (its memset, three launches and scratch
    inside the capture), replayed on new rows in the same buffers, equals
    the eager call on those rows bit for bit."""
    from sqmc_tpu_torch.ops import seqinit
    dev = _device()
    first = [torch.as_tensor(x, device=dev)
             for x in seq_zero_rows("walk", np.float32)]
    second = [torch.as_tensor(x, device=dev)
              for x in seq_rows(SEQ_N, 6, np.float32, long_group=30_000)]
    static = [x.clone() for x in first]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        seqinit.sequential_initiator(*static)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = seqinit.sequential_initiator(*static)
    for rows in (first, second):
        for dst, src in zip(static, rows):
            dst.copy_(src)
        g.replay()
        eager = seqinit.sequential_initiator(*rows)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_seq_init_wrapper_raises_on_bad_input():
    from sqmc_tpu_torch.ops import seqinit
    dev = _device()
    neq = torch.ones(4, dtype=torch.bool, device=dev)
    w = torch.ones(4, device=dev)
    ini = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):               # int64 initiators
        seqinit.sequential_initiator(neq, w, ini.long())
    with pytest.raises(ValueError):               # float16 weights
        seqinit.sequential_initiator(neq, w.half(), ini)
    with pytest.raises(ValueError):               # weights on the CPU
        seqinit.sequential_initiator(neq, w.cpu(), ini)


# ---------------------------------------------------------------------------
# The dense engine, VMC and CPMC captured: the eager loops are the
# reference, bit for bit
# ---------------------------------------------------------------------------

DENSE_GRAPH_CASES = {"none": ("none", 0, False),
                     "fixed_node1": ("fixed_node1", 1, False),
                     "release_node": ("release_node", 1, False),
                     "sr": ("sr", 1, False), "vmc": ("vmc", 1, False),
                     "exponential": ("none", 0, True),
                     "exponential_fixed_node2": ("fixed_node2", 1, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DENSE_GRAPH_CASES))
def test_dense_graph_equals_eager_bit_for_bit(case):
    """The dense engine on a fictitious matrix of 2,048 dets: two blocks of
    30 generations (the second equilibrated; release_node's first crosses
    its release step, 12) through dense_walk_block (captured generations
    replayed) and through the eager loop from one seed: w, the sums, the
    trace and the generator's state equal bit for bit (sr's comb adds
    exact 1.0s: its index_add_ sums in any order to the same bits)."""
    from sqmc_tpu_torch.algo import densewalk as dw
    from sqmc_tpu_torch.systems.toy import make_fictitious_system
    dev = _device()
    run_type, imp, expo = DENSE_GRAPH_CASES[case]
    s = make_fictitious_system(2048, 0, 1.0, 0.5, 0.5, 0.5, seed=(1, 2, 3, 4),
                               device=dev)
    psi_t = np.zeros(2048)
    psi_t[:8] = 1.0
    psi_g = np.full(2048, 0.02)
    cfg = dw.DenseWalkConfig(ndet=2048, tau=0.002, w_abs_target=2e4,
                             run_type=run_type, importance_sampling=imp,
                             release_step=12, sr_nwalk=20000, min_wt=0.5,
                             use_exponential_projector=expo,
                             pop_ctrl_exponent=100.0)
    tables = dw.build_dense_tables(s, cfg, psi_t, psi_g)
    st = dw.init_dense_state(cfg, psi_t, psi_g, 1e4, -1.0, seed=3,
                             device=dev)
    a = b = st
    for blk in range(2):
        if blk:
            a, b = (x._replace(equilibrated=True) for x in (a, b))
        a, sa = dw._dense_walk_block_eager(a, tables, cfg, 30)
        b, sb = dw.dense_walk_block(b, tables, cfg, 30)
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), (blk, f)
            else:
                assert x == y, (blk, f)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (blk, k)
        a, b = dw.end_of_dense_block(a), dw.end_of_dense_block(b)
    assert float(b.w_abs_gen) > 1000
    dw.release_graphs()


@pytest.mark.cuda
def test_vmc_graph_equals_eager_bit_for_bit():
    """VMC on the 4x4 cluster (5 + 5, 256 walkers, 10 steps a sweep): 6
    sweeps through vmc_sweep (one replay a sweep) and through the eager
    sweep, the inverses refreshed after the third (outside the graph):
    positions, inverses, local energies and the generator's state equal
    bit for bit."""
    from sqmc_tpu_torch.systems.hubbard import meanfield, vmc
    dev = _device()
    pu, pd, _ = meanfield.hartree_fock(4, 4, 1.0, 4.0, 5, 5, True)
    st = vmc.init_vmc(pu, pd, 4, 4, 256, seed=7, device=dev)
    nbr = torch.as_tensor(vmc.neighbor_table(4, 4, True), dtype=torch.int64,
                          device=dev)
    pu = torch.as_tensor(pu, device=dev)
    pd = torch.as_tensor(pd, device=dev)
    args = (pu, pd, nbr, 0.7, 4.0, 1.0, 10, 16)
    a = b = st
    for sweep in range(6):
        a, ea = vmc._vmc_sweep_eager(a, *args)
        b, eb = vmc.vmc_sweep(b, *args)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (sweep, f)
        assert torch.equal(ea, eb), sweep
        if sweep == 2:
            a, b = (x._replace(minv_up=torch.linalg.inv(pu[x.r_up]),
                               minv_dn=torch.linalg.inv(pd[x.r_dn]))
                    for x in (a, b))
    assert vmc._GRAPH.graphs[None].replays == 6
    vmc.release_graphs()


@pytest.mark.cuda
def test_cpmc_graph_equals_eager_bit_for_bit():
    """CPMC on the 4x4 cluster (5 + 5, 1,024 walkers, tau 0.05): two
    blocks of 10 steps through cpmc_block (one replay a step) and through
    the eager loop, with the host's comb between them: walkers, log
    weights, alive flags, the mixed energies and the generator's state
    equal bit for bit."""
    from sqmc_tpu_torch.systems.hubbard import cpmc
    dev = _device()
    cfg = cpmc.CpmcConfig(4, 4, 1.0, 4.0, 5, 5, tau=0.05, n_walkers=1024)
    setup, st = cpmc.init_cpmc(cfg, seed=1, device=dev)
    a = b = st
    idx = torch.as_tensor(np.random.default_rng(0).integers(0, 1024, 1024),
                          device=dev)
    for blk in range(2):
        a, ea = cpmc._cpmc_block_eager(a, setup, cfg, 10)
        b, eb = cpmc.cpmc_block(b, setup, cfg, 10)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (blk, f)
        assert torch.equal(ea, eb) and bool(torch.isfinite(eb)), blk
        a, b = (x._replace(phi_up=x.phi_up[idx], phi_dn=x.phi_dn[idx])
                for x in (a, b))
    assert cpmc._GRAPH.graphs[None].replays == 20
    cpmc.release_graphs()


@pytest.mark.cuda
def test_captured_paths_replay_without_a_sync():
    """After their captures, a dense block, a VMC sweep and a CPMC block
    (its measurement included) run under torch's sync debug mode set to
    raise: the replays, the copies in and out and the generator's state
    handed back never wait on the card."""
    from sqmc_tpu_torch.algo import densewalk as dw
    from sqmc_tpu_torch.systems.hubbard import cpmc, meanfield, vmc
    from sqmc_tpu_torch.systems.toy import make_fictitious_system
    dev = _device()
    s = make_fictitious_system(512, 0, 1.0, 0.5, 0.5, 0.5, device=dev)
    g = np.full(512, 0.05)
    dcfg = dw.DenseWalkConfig(ndet=512, tau=0.002, w_abs_target=5e3,
                              run_type="sr", importance_sampling=1)
    tables = dw.build_dense_tables(s, dcfg, g, g)
    dst = dw.init_dense_state(dcfg, g, g, 5e3, -1.0, device=dev)
    dst, _ = dw.dense_walk_block(dst, tables, dcfg, 5)
    pu, pd, _ = meanfield.hartree_fock(4, 4, 1.0, 4.0, 5, 5, True)
    vst = vmc.init_vmc(pu, pd, 4, 4, 64, device=dev)
    nbr = torch.as_tensor(vmc.neighbor_table(4, 4, True), dtype=torch.int64,
                          device=dev)
    vargs = (torch.as_tensor(pu, device=dev), torch.as_tensor(pd, device=dev),
             nbr, 0.7, 4.0, 1.0, 10, 16)
    vst, _ = vmc.vmc_sweep(vst, *vargs)
    ccfg = cpmc.CpmcConfig(4, 4, 1.0, 4.0, 5, 5, n_walkers=64)
    setup, cst = cpmc.init_cpmc(ccfg, device=dev)
    cst, _ = cpmc.cpmc_block(cst, setup, ccfg, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dst, dstats = dw.dense_walk_block(dst, tables, dcfg, 5)
        vst, e_loc = vmc.vmc_sweep(vst, *vargs)
        cst, e_mix = cpmc.cpmc_block(cst, setup, ccfg, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(dstats["e_gen"]).all())
    assert bool(torch.isfinite(e_loc).all()) and bool(torch.isfinite(e_mix))
    for mod in (dw, vmc, cpmc):
        mod.release_graphs()


# ---------------------------------------------------------------------------
# K6: the spawn histogram of the walk's finalize (ops/spawnhist.py)
# ---------------------------------------------------------------------------

SPAWN_HIST_CASES = ("boundary_f32", "boundary_f64", "spread_f32",
                    "spread_f64", "one_slot", "misaligned",
                    "heg54_f32", "heg54_f64")


def _spawn_hist_inputs(case):
    """(weights, flags) in numpy of each case: the boundary set alone; the
    boundary set scattered among 1,000,003 random slots (not a multiple of
    the vectors a block takes); one slot; heg54.walk's shape (5,242,880
    slots, ~94% of them undrawn or rejected)."""
    import torch_spawnhist_cases as cases
    rng = np.random.default_rng(22)
    dt = np.float64 if case.endswith("f64") else np.float32
    if case.startswith("boundary"):
        return cases.boundary_weights(dt)
    if case == "one_slot":
        return np.array([3.0], np.float32), np.array([True])
    if case.startswith("heg54"):
        return cases.discard_heavy(rng, 5_242_880, dt)
    n = 1_000_003
    wt = (2.0 ** rng.uniform(-26.0, 24.0, n)
          * rng.choice([-1.0, 1.0], n)).astype(dt)
    wt[rng.random(n) < 0.2] = 0
    ok = rng.random(n) < 0.6
    bw, bo = cases.boundary_weights(dt)
    at = rng.choice(n, len(bw), replace=False)
    wt[at], ok[at] = bw, bo
    return wt, ok


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPAWN_HIST_CASES)
def test_spawn_hist_kernel_matches_plain(case):
    """K6 bit for bit against its plain version on the card, one launch a
    call and the same counts on a second call: the boundary weights
    (tests/torch_spawnhist_cases.py), the same scattered among 1,000,003
    random slots, one slot, a view that starts 4 bytes past an aligned
    address (the wrapper copies it), and heg54.walk's shape with ~94% of
    its slots counting nowhere."""
    from sqmc_tpu_torch.ops import spawnhist
    dev = _device()
    wt, ok = _spawn_hist_inputs(case.replace("misaligned", "spread_f32"))
    w = torch.as_tensor(wt, device=dev)
    f = torch.as_tensor(ok, device=dev)
    if case == "misaligned":
        w, f = w[1:], f[1:]
        assert w.data_ptr() % 16 != 0
    if case.startswith("heg54"):
        assert float((~f | (w == 0)).double().mean()) > 0.93
    before = spawnhist.launches
    got = spawnhist.spawn_histogram(w, f)
    torch.cuda.synchronize()
    assert spawnhist.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (spawnhist.N_HIST_BINS,)
    want = spawnhist.spawn_histogram_plain(w, f)
    assert torch.equal(got, want), (got - want).nonzero().flatten().tolist()
    assert torch.equal(spawnhist.spawn_histogram(w, f), got)
    print(f"spawn_hist {case}: n={w.shape[0]} counted={int(got.sum())} "
          + " ".join(f"{k}={v}" for k, v in spawnhist.launch_shape(
              w.shape[0], w.dtype == torch.float64, dev).items()))


@pytest.mark.cuda
def test_spawn_hist_in_captured_graph_equals_eager():
    """K6 captured in a CUDA graph (the output's zeroing and the launch
    inside the capture), replayed on new weights in the same buffers:
    each replay's counts equal the eager call's on those weights."""
    import torch_spawnhist_cases as cases
    from sqmc_tpu_torch.ops import spawnhist
    dev = _device()
    rng = np.random.default_rng(6)
    n = 262_144
    inputs = [cases.discard_heavy(rng, n, np.float32, drawn=d, accept=a)
              for d, a in ((0.4, 0.85), (0.37, 0.17))]
    w = torch.as_tensor(inputs[0][0], device=dev)
    f = torch.as_tensor(inputs[0][1], device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        spawnhist.spawn_histogram(w, f)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = spawnhist.spawn_histogram(w, f)
    for wt, ok in inputs:
        w.copy_(torch.as_tensor(wt, device=dev))
        f.copy_(torch.as_tensor(ok, device=dev))
        g.replay()
        eager = spawnhist.spawn_histogram(w, f)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert torch.equal(out, spawnhist.spawn_histogram_plain(w, f))


@pytest.mark.cuda
def test_spawn_hist_wrapper_raises_on_bad_input():
    from sqmc_tpu_torch.ops import spawnhist
    dev = _device()
    w = torch.ones(8, device=dev)
    f = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):               # float16 weights
        spawnhist.spawn_histogram(w.half(), f)
    with pytest.raises(ValueError):               # uint8 flags
        spawnhist.spawn_histogram(w, f.to(torch.uint8))
    with pytest.raises(ValueError):               # 2-D weights
        spawnhist.spawn_histogram(w.view(2, 4), f.view(2, 4))
    with pytest.raises(ValueError):               # lengths differ
        spawnhist.spawn_histogram(w, f[:7])
    with pytest.raises(ValueError):               # no slot
        spawnhist.spawn_histogram(w[:0], f[:0])
    with pytest.raises(ValueError):               # flags on the CPU
        spawnhist.spawn_histogram(w, f.cpu())


# ---------------------------------------------------------------------------
# K7: the CT chain of the exponential projector, ct_mode "hubbardk"
# (ops/ctchain.py)
# ---------------------------------------------------------------------------

def _ct_case_on(case, dev):
    """tests/torch_ctchain_cases.py's case on the card: the kernel's inputs
    and the same inputs as the plain version takes them."""
    import torch_ctchain_cases as cases
    from types import SimpleNamespace
    c = cases.make_case(case)
    g = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
         for k, v in c.items()}
    tb = c["table"]
    g["table"] = SimpleNamespace(
        norb=tb.norb, core_energy=tb.core_energy, h=tb.h.to(dev),
        direct=tb.direct.to(dev), exchange=tb.exchange.to(dev))
    return c, g


def _ct_kernel(g):
    from sqmc_tpu_torch.ops import ctchain
    return ctchain.chain(g["u"], g["up_w"], g["dn_w"], g["slot_valid"],
                         g["table"], g["kmap3"], g["rate"], g["tau"],
                         g["e_trial"], g["norb"], g["nup"], g["ndn"])


def _assert_same_chains(got, want):
    """Words, flags and both counters equal; the factor within 1e-12 of
    its size (H_ii's sums in another order)."""
    up, dn, f, ok, nj, nc = got
    assert torch.equal(up, want[0]) and torch.equal(dn, want[1])
    assert torch.equal(ok, want[3])
    assert float(nj) == float(want[4]) and float(nc) == float(want[5])
    assert nj.dtype == nc.dtype == torch.float64 and nj.shape == nc.shape == ()
    assert torch.equal(f != 0, want[2] != 0)
    err = ((f - want[2]).abs() / want[2].abs().clamp(min=1e-300))[f != 0]
    assert float(err.max()) < 1e-12 if err.numel() else True


CT_CHAIN_CASES = ("hubk2x2", "hubk2x4", "hubk4x4", "hubk4x4_cut",
                  "hubk2x4_cut", "wide48", "two_word72", "cell")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CT_CHAIN_CASES)
def test_ct_chain_kernel_matches_plain(case):
    """K7 against its plain version on the card, one launch a call, on
    tests/torch_ctchain_cases.py's chains (2x2, 2x4 and 4x4 Hubbard-k
    clusters with undrawn slots, dead proposals, wrapped first moves and
    chains cut at a small n_moves; 48 orbitals at one word a spin; two
    words a spin) and at hubbardk4x4.walk-ct's shape (262,144
    slots, 40% drawn, 12 moves): child words, flags and both counters
    equal, the factor within 1e-12; a second call gives the same bits."""
    from sqmc_tpu_torch.ops import ctchain
    dev = _device()
    c, g = _ct_case_on(case, dev)
    before = ctchain.launches
    got = _ct_kernel(g)
    torch.cuda.synchronize()
    assert ctchain.launches == before + 1
    import torch_ctchain_cases as cases
    _assert_same_chains(got, cases.plain(c, dev))
    again = _ct_kernel(g)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    S, W = g["up_w"].shape
    print(f"ct_chain {case}: S={S} W={W} norb={g['norb']} "
          f"jumps={float(got[4]):.0f} cut={float(got[5]):.0f} "
          f"ok={int(got[3].sum())} " + " ".join(
              f"{k}={v}" for k, v in ctchain.launch_shape(
                  S, W, g["norb"], dev).items()))


@pytest.mark.cuda
def test_ct_chain_in_captured_graph_equals_eager():
    """K7 captured in a CUDA graph (the counters' zeroing and the launch),
    replayed on new uniforms, drawn parents and E_T written into the same
    buffers: each replay's chains equal the eager call's on those inputs
    bit for bit (rate, tau and E_T are read on the device)."""
    from sqmc_tpu_torch.ops import ctchain
    dev = _device()
    _, g = _ct_case_on("hubk4x4", dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _ct_kernel(g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _ct_kernel(g)
    for k in range(3):
        g["u"].copy_(ctchain.draw_uniforms(gen, g["u"].shape[0],
                                           g["u"].shape[2], dev))
        v = g["slot_valid"]                     # drawn slots: real dets
        g["up_w"][v] = g["up_w"][v].roll(k + 1, 0)
        g["e_trial"].fill_(float(g["e_trial"]) + 0.1 * k)
        graph.replay()
        eager = _ct_kernel(g)
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_ct_walk_graphed_block_matches_the_plain_chain(monkeypatch):
    """hubbardk4x4.walk-ct's walk (phase 7a): a graphed block (K7, one
    launch a generation) against an eager block from one seed whose chain
    is the plain version on the card: the walkers' dets, flags and the
    counters of every generation (jumps, cut chains, accepted spawns,
    fresh dets, walkers) equal, the weights within 1e-6 (the factors
    differ in their last bits only)."""
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.ops import ctchain
    dev = _device()
    s, trial, cfg, w0 = _graph_cell("ct_hubbardk", dev)
    tables = TW.build_walk_tables(s, trial, cfg)
    st = TW.init_walk_state(cfg, trial, w0, trial.e_trial, tables)
    n = 20
    k0 = ctchain.launches
    b, sb = TW.walk_block(st, tables, cfg, n,
                          torch.Generator(device=dev).manual_seed(29))
    torch.cuda.synchronize()
    assert ctchain.launches == k0 + n

    def plain(u, up_w, dn_w, slot_valid, table, kmap3, rate, tau, e_trial,
              norb, nup, ndn):
        return ctchain.chain_plain(u, up_w, dn_w, slot_valid, table, rate,
                                   tau, e_trial, norb,
                                   ctchain.hubbardk_move(kmap3, norb, nup,
                                                         ndn))
    monkeypatch.setattr(ctchain, "chain", plain)
    a, sa = TW._walk_block_eager(st, tables, cfg, n,
                                 torch.Generator(device=dev).manual_seed(29))
    torch.cuda.synchronize()
    assert ctchain.launches == k0 + n
    for k in ("n_ct_jumps", "n_ct_cut", "n_spawn", "n_spawn_ok", "n_fresh",
              "nwalk"):
        assert torch.equal(sa[k], sb[k]), k
    assert bool((sb["n_ct_jumps"] > 0).all())
    for f in ("up", "dn", "imp", "init", "nwalk"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.allclose(a.wt.double(), b.wt.double(), rtol=1e-6, atol=0)
    TW.release_graphs()


@pytest.mark.cuda
def test_ct_chain_wrapper_raises_on_bad_input():
    from sqmc_tpu_torch.ops import ctchain
    dev = _device()
    _, g = _ct_case_on("hubk2x2", dev)
    bad = [dict(up_w=g["up_w"].to(torch.int32)),              # int32 words
           dict(dn_w=g["dn_w"][:-1]),                         # lengths differ
           dict(slot_valid=g["slot_valid"].to(torch.uint8)),  # uint8 flags
           dict(u=g["u"][:, :5]),                             # 5 uniforms
           dict(u=g["u"].float()),                            # float32
           dict(kmap3=g["kmap3"][:-1]),                       # short kmap3
           dict(tau=g["tau"].cpu()),                          # tau on the CPU
           dict(e_trial=g["e_trial"][None]),                  # not 0-d
           dict(up_w=g["up_w"].repeat(1, 3),                  # three words
                dn_w=g["dn_w"].repeat(1, 3))]
    for change in bad:
        with pytest.raises(ValueError):
            _ct_kernel({**g, **change})
    with pytest.raises(ValueError):                           # nup = norb
        _ct_kernel({**g, "nup": g["norb"]})
