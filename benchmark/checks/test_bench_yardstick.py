"""The frozen byte counts give the smoke's bounds at its phase 2 / 2b
shapes, and the trace arithmetic counts busy time once."""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import registry
from benchmark.yardstick import kernel_bytes, peaks, trace


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(registry.ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_seg_scan_bytes_match_phase_2():
    smoke = _smoke()
    n = 720_896                                  # walk_merge_6field_f32
    ours = kernel_bytes.seg_scan(n, [4] * 6)
    theirs = n + 2 * sum(n * 4 for _ in range(6))
    assert ours == theirs
    assert peaks.bound_us(ours) == smoke._bound_us(theirs)
    assert round(ours / 1e6, 1) == 35.3
    assert round(peaks.bound_us(ours)[0], 1) == 10.5


def test_spmv_bytes_match_phase_2b():
    smoke = _smoke()
    rng = np.random.default_rng(11)            # phase 2b's C2 shape
    lengths = np.clip(np.rint(rng.lognormal(np.log(smoke.C2_MEAN) - 0.5, 1.0,
                                            smoke.C2_ROWS)), 1,
                      smoke.C2_KMAX).astype(np.int64)
    lengths[rng.integers(smoke.C2_ROWS)] = smoke.C2_KMAX
    n, nnz = smoke.C2_ROWS, int(lengths.sum())
    for es, dt in ((4, "float32"), (8, "float64")):
        nbytes, flops = kernel_bytes.spmv(n, nnz, es)
        theirs = nnz * (4 + es) + (n + 1) * 8 + n * 4 + 2 * n * es
        assert nbytes == theirs and flops == 2.0 * nnz
        assert peaks.bound_us(nbytes, flops, dt) == smoke._bound_us(
            theirs, 2.0 * nnz, dt)
    nbytes, flops = kernel_bytes.spmv(n, nnz, 4)
    assert round(nbytes / 1e6, 1) == 78.4
    assert round(peaks.bound_us(nbytes, flops)[0], 1) == 23.4


def _ev(name, a, b, cuda):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if cuda
                           else DeviceType.CPU)


def test_trace_counts_overlap_once_and_names_gaps():
    ev = [_ev(trace.WINDOW, 0, 100, False), _ev(trace.WINDOW, 0, 100, True),
          _ev("k_a", 10, 30, True), _ev("k_b", 20, 40, True),
          _ev("k_a", 70, 80, True), _ev("cudaGraphLaunch", 5, 8, False),
          _ev("host_work", 41, 69, False)]
    s = trace.summarize(ev, 100e-6, 2)
    assert s["busy_s"] == pytest.approx(40e-6)      # [10,40] + [70,80]
    assert s["device_us"] == 50 and s["device_ops"] == 3
    assert s["host_launches"] == 1
    assert s["breakdown"]["idle_gaps"][0] == ["host_work", pytest.approx(30e-6)]
    assert trace.kernel_rows(s, "k_a") == (30, 2)


def _driver(f32: bool, n_imp: int = 0, nnz: int = 0):
    """The parts of a walk driver the kernel metrics read."""
    import torch
    cfg = SimpleNamespace(mwalk=458_752, cap_spawn=262_144, f32_state=f32,
                          full_sort_merge=True, semistochastic=True)
    tables = SimpleNamespace(imp_diag=torch.zeros(n_imp),
                             imp_dense=torch.zeros(0),
                             imp_ell_nnz=torch.tensor([nnz]))
    return SimpleNamespace(cfg=cfg, tables=tables)


def test_rooflines_are_shares_of_the_bound():
    trace = {"rows": {"k_seg_scan_x": (2 * 26.0, 2),
                      "k_spmv_y": (3 * 10.0, 3)}, "units": 2}
    run = {"kind": "walk", "trace": trace, "driver": _driver(True)}
    k1 = registry.metric("seg_scan_roofline").read(run)
    # the merge rows of phase 2: 720,896 rows of six 4-byte fields
    assert k1 == pytest.approx(100 * peaks.bound_us(35_323_904)[0] / 26.0)
    run["driver"] = _driver(False, n_imp=1000, nnz=50_000)
    nb, fl = kernel_bytes.spmv(1000, 50_000, 8)
    k2 = registry.metric("spmv_roofline.walk").read(run)
    assert k2 == pytest.approx(100 * peaks.bound_us(nb, fl, "float64")[0] / 10)
    run["trace"]["rows"] = {}
    assert registry.metric("seg_scan_roofline").read(run) is None
    assert registry.metric("spmv_roofline.walk").read(run) is None
    assert registry.metric("seg_scan_roofline").read({"kind": "walk"}) is None
