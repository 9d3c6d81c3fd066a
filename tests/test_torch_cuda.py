"""Tests that need an NVIDIA card (marked `cuda`; each skips without one).

The card has no jax, and tests/conftest.py imports it, so on the card run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

This file imports only torch, numpy and the port.
"""

import numpy as np
import pytest
import torch

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
        c, v, _, p = tspmv.ell_from_coo(*coo)
        c, v = c.reshape(-1), v.reshape(-1)
    else:
        c, v, _, p = tspmv.blockell_from_coo(*coo, dtype=np.float64)
    cols = torch.as_tensor(c, device=dev)
    vals = torch.as_tensor(v, device=dev).to(dtype)
    ptr = torch.as_tensor(p, device=dev)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((5000, 3)),
                        device=dev).to(dtype)
    before = tspmv.launches
    for xs in (x[:, 0].contiguous(), x):
        got = tspmv.spmv(xs, cols, vals, ptr)
        torch.cuda.synchronize()
        ref = tspmv.spmv_plain(xs, cols, vals, ptr)
        bound = tspmv.spmv_plain(xs.abs().double(), cols, vals.abs().double(),
                                 ptr)
        assert got.dtype == dtype and got.shape == ref.shape
        assert bool(((got.double() - ref.double()).abs() <= rtol * bound).all())
    y = tspmv.spmv(x, cols, vals, ptr)
    for j in range(3):
        assert torch.equal(y[:, j], tspmv.spmv(x[:, j].contiguous(), cols,
                                               vals, ptr))
    assert tspmv.launches == before + 6


@pytest.mark.cuda
def test_spmv_wrapper_raises_on_bad_input():
    dev = _device()
    cols = torch.zeros(128, dtype=torch.int32, device=dev)
    vals = torch.zeros(128, device=dev)
    ptr = torch.tensor([0, 128], device=dev)
    x = torch.zeros(1, device=dev)
    with pytest.raises(ValueError):
        tspmv.spmv(x, cols.long(), vals, ptr)
    with pytest.raises(ValueError):
        tspmv.spmv(x.double(), cols, vals, ptr)
    with pytest.raises(ValueError):
        tspmv.spmv(x, cols.cpu(), vals, ptr)


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
    cpu = run_hci(make_heg_system(3, 0.5, 14, 7, 1.49), **kw)
    assert torch.equal(card.up.cpu(), cpu.up) and torch.equal(card.dn.cpu(),
                                                              cpu.dn)
    np.testing.assert_allclose(card.energies, cpu.energies, rtol=0, atol=1e-6)
