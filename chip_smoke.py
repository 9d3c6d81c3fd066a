#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sqmc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py             # every phase (one card)
    python3 chip_smoke.py --kernels   # phases 0-2c only, then exit 1
    python3 chip_smoke.py --hubbard   # phases 0, 1 and 7 only, then exit 1

Phases, each reported on its own line; any failure exits nonzero:

  0. device check: a CUDA card must be present (the script never falls
     back to the CPU); prints the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them, and the torch / CUDA versions;
  1. build both kernels from sqmc_tpu_torch/csrc (segscan.cu, spmv.cu),
     one nvcc each, started together;
  2. the seg-scan kernel vs its plain PyTorch version on the card, at the
     walk's merge shape (720,896 rows x 6 fields), an f64 variant, one
     segment spanning everything, all segment starts, n = 1 and n = 127;
  2b. the SpMV kernel vs its plain version: ELL and block-ELL, float32
     and float64, m = 1 and 4 right-hand sides, at HEG-14's variational H
     (9,475 rows), at the C2 CAS(8e,26o) shape made from a seed (88k rows,
     ~9.6M nonzeros, row lengths mean ~110, max 1,347) and at one row.
     Each case of 2 and 2b prints wrapper_ms (median of CUDA events around
     the wrapper call, its host path included), device_us (CUDA events
     around a CUDA graph of 50 calls, per call), bound_us (the bytes the function must move
     over 3.35 TB/s, or its operations over the peak rate, whichever is
     larger), share = bound_us / device_us, plain_ms, and library_ms, the
     one PyTorch call that computes the same function where there is one
     (torch.sparse_csr_tensor(...) @ x for SpMV; torch.cumsum / cummax /
     cummin per field for the one-segment scan), timed only here;
  2c. the kernels' own time per call (kernel_us) at the walk and C2
     shapes, from one torch.profiler session;
  3. the walk's main path on the 14-electron electron gas (3D HEG,
     r_s = 0.5, 19 plane waves): HCI at eps_var = 1e-3 against its golden
     (9475 dets, E_var = 58.276906085), the trial wavefunction with D = the
     whole HCI space, and the semistochastic initiator walk at the bench's
     knobs, gated against E_var + PT = 58.275966889 Ha;
  4. the SHCI path on HEG-14: run_hci(device_davidson=True) (Davidson on
     the SpMV kernel), deterministic PT at eps_pt 2e-7 (-0.000939196,
     501,881 connected dets, 48.051813420 with Madelung) and do_pt
     semistochastic (eps_pt_big 1e-5, target 1e-5, n_mc 200);
  5. a short float64-state walk, whose D-space projection is the block-ELL
     SpMV kernel;
  6. the card-input entry point, ``python -m sqmc_tpu_torch -i deck`` in a
     subprocess on the card (its exit code becomes the smoke's): 6a the
     HEG-14 HCI+PT deck against the goldens of tests/test_cli.py:16-28;
     6b a synthetic FCIDUMP at C2 CAS(8e,26o)'s shape (26 orbitals with
     the C2 decks' d2h irreps, 8 electrons, made from a seed) run as a
     C2-curve deck (time_sym z = +1, hf_symmetry 1, two states, eps_var
     2e-3, 2e-3 -> 1e-3, deterministic PT at eps_pt 1e-7), then in this
     process run_hci(device_davidson=True) on the same system (K2 with
     m = 2) within 1e-6 of the CLI's E_var and K2 against its plain
     version on the symmetrized H, then a time-symmetrized walk deck at
     the bench's population (2e5, min_wt 0.5, f64 state, auto MWALK, 4 + 4
     blocks of 100 generations) gated on capacity, population and
     e_mixed within max(5 sigma, 2 mHa) of E_var + PT; 6c the 6-orbital
     time-symmetrized oracle (D = the whole space) at the exact e0 to
     1e-8 for z = +1 and, from an open-shell start, z = -1.  Decks, logs
     and the FCIDUMP go to build/smoke_phase6/;
  7. the Hubbard determinant systems and the walk's other projectors
     (decks and logs in build/smoke_phase7/):
     7a momentum-space Hubbard at full width, the 4x4 periodic cluster at
     U/t = 4 with 5 + 5 electrons (16 k-points, 19.1M dets): the HCI + PT
     deck through the CLI (eps_var 2e-3, 2e-3 -> 1e-3), the device
     Davidson (K2) on the same system within 1e-6 of it, then in f32 state
     at population 2e5 the linear semistochastic heat-bath walk (tau 5e-4)
     and the continuous-time projector (tau 5e-3, semistochastic off),
     each gated on capacity, population within 10% and |e_mixed - (E_var +
     PT)| < max(5 sigma, 2 mHa);
     7b real-space Hubbard on the same cluster (one Hamiltonian, another
     basis): fixed_node1 with importance sampling by a Gutzwiller
     function (g = 0.6; orbitals of the hopping matrix plus a small random
     site potential, so that no det sits exactly on a node; the walk
     starts from the no-double-occupancy det where |psi_g| is largest),
     semistochastic with D = the HCI space at eps_var 0.03, f64 state, so
     each generation projects through K2 on the non-symmetric fixed-node
     matrix; tau is the linear projector's stability bound 1 / (largest
     diagonal of that matrix - E_T), at most 1e-3: a det next to a node of
     psi_g carries an unbounded diagonal dump, and past the bound its
     weight alternates and grows; K2 against its plain version on that
     matrix (f32 and f64, m = 1); gates: no overflow, population within 10% of its target,
     e_mixed >= E0 - 5 sigma with E0 = 7a's E_var + PT;
     7c small oracles on the card: on the 1x8 open chain (784 dets, no
     sign violator: fixed-node is exact) importance sampling and
     fixed_node1 (also as a deck through the CLI), and on the 2x3 open
     lattice (225 dets, 240 violators)
     fixed_node1, partial_node eps 0.6 and release_node, each against the
     dense fixed-node effective Hamiltonian; the CT projector in its
     three modes (2x2 Hubbard-k, HEG-4, a 5-orbital chem system) against
     FCI; the uniform proposal on HEG-14 at reduced depth against phase
     3's oracle and the Cauchy-Schwarz proposal on a 4-orbital chem system
     against FCI (the electron gas has (pr|pr) = 0, so that proposal has no
     support there); the sequential initiator rule and the two-level merge
     in the deterministic limit against the full-sort group-max trace
     (1e-10); save, load and resume of a walker state giving the same
     next block as the uninterrupted run.

Each path's kernel counts are set to 0 just before it and read just after.
The last two lines are a JSON object describing the kernels (seg_scan's
launches from phases 3 and 7, spmv's from phases 4 and 7, each path
counted from 0; errors and times measured
here: seg_scan at the walk's merge shape, spmv at the C2 block-ELL float32
m = 1 shape) and ``{"ok": true, "device": {...}}``.
"""

import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# main-path workload and gates
HEG = (3, 0.5, 14, 7, 1.49)           # n_dim, r_s, nelec, nup, cutoff
EPS_VAR = 1e-3
GOLD_NDET, GOLD_EVAR = 9475, 58.276906085
ORACLE = 58.275966889                 # E_var + deterministic PT (eps_pt 2e-7)
W_TARGET, W_BEGIN = 200_000.0, 140_000.0
NSTEP, NBLK_EQ, NBLK = 100, 12, 15    # 1,200 equilibration + 1,500 measured
MERGE_N = 458_752 + 262_144           # walk merge rows: mwalk + cap_spawn


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def _fields(rng, n, f64):
    """The walk merge's field mix: priority u (i32 min), initiator (i32
    max), weight and D-spawn weight (sums), diagonal (min), C(T) index
    (i32 max)."""
    import numpy as np
    fdt = np.float64 if f64 else np.float32
    return [
        rng.integers(0, 131, n).astype(np.int32),
        rng.integers(0, 4, n).astype(np.int32),
        rng.standard_normal(n).astype(fdt),
        (rng.standard_normal(n) * (rng.random(n) < 0.2)).astype(fdt),
        rng.standard_normal(n).astype(fdt),
        rng.integers(-2, 100_000, n).astype(np.int32),
    ], ["min", "max", "sum", "sum", "min", "max"]


def _cases():
    import numpy as np
    rng = np.random.default_rng(7)
    out = []

    def starts(n, frac):
        s = rng.random(n) < frac
        if n:
            s[0] = True
        return s

    f, o = _fields(rng, MERGE_N, False)
    out.append(("walk_merge_6field_f32", f, o, starts(MERGE_N, 0.4)))
    f, o = _fields(rng, MERGE_N, True)
    out.append(("walk_merge_6field_f64", f, o, starts(MERGE_N, 0.4)))
    u32 = rng.integers(0, 2**32, MERGE_N, dtype=np.uint64).astype(np.uint32)
    one = np.zeros(MERGE_N, bool)
    one[0] = True
    out.append(("one_segment", [rng.standard_normal(MERGE_N).astype(np.float32),
                                u32, u32.copy(),
                                rng.integers(-9, 9, MERGE_N).astype(np.int32)],
                ["sum", "max", "min", "sum"], one))
    f, o = _fields(rng, MERGE_N, False)
    out.append(("all_starts", f, o, np.ones(MERGE_N, bool)))
    for n in (1, 127):
        f, o = _fields(rng, n, False)
        out.append((f"n{n}", f, o, starts(n, 0.3)))
    return out


def _median_ms(fn, reps=20, warm=3):
    """Median of CUDA-event times around fn(): the call's host path and its
    device work (the wrapper time)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_us(fn, calls=50, reps=5):
    """Device time per call, in us: the median of CUDA events around a
    replay of a CUDA graph that holds `calls` calls (their host path is not
    in the graph; the gaps between its nodes are).  Events, not
    torch.profiler: repeated profiler sessions in one process can come
    back without device rows."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture stream
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del g
    times.sort()
    return times[len(times) // 2] * 1e3 / calls


PROFILED = []                          # (label, fn): phase 2c's cases


def phase_kernel_rows(calls=20):
    """Phase 2c: the kernels' own rows per call, from one torch.profiler
    session over the PROFILED cases (the first session of the process:
    later ones can come back without device rows).  Device rows are
    bucketed by the record_function range they start in; each range ends
    with a synchronize.  Returns {label: kernel us per call}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for _, fn in PROFILED:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in PROFILED:
            with record_function("case:" + label):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
    events = prof.events()
    ranges = [(e.name[5:], e.time_range.start, e.time_range.end)
              for e in events if e.name.startswith("case:")]
    rows = {label: {} for label, _ in PROFILED}     # (name, start) -> us
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith("case:"):
            continue
        for label, a, b in ranges:
            if a <= e.time_range.start <= b:
                rows[label][(e.name, e.time_range.start)] = \
                    e.time_range.elapsed_us()
    out = {}
    for label, found in rows.items():
        own = [us for (name, _), us in found.items()
               if "k_seg_scan" in name or "k_spmv" in name]
        other = sorted({name[:24] for name, _ in found} - {
            name[:24] for name, _ in found
            if "k_seg_scan" in name or "k_spmv" in name})
        out[label] = sum(own) / calls
        log(f"phase 2c profile {label}: kernel_us={out[label]:.1f} "
            f"kernel_rows={len(own)} calls={calls} other_device_us="
            f"{(sum(found.values()) - sum(own)) / calls:.1f} other_rows="
            f"{len(found) - len(own)} {other[:3]}")
    return out


HBM_BYTES_PER_S = 3.35e12              # NVIDIA H100 SXM data sheet
FLOPS = {"float32": 67e12,             # the same, outside the tensor cores
         "float64": 34e12}


def _bound_us(nbytes, flops=0.0, dt="float32"):
    """The least time for the work: the larger of bytes / HBM rate and
    operations / peak rate (us), and which of the two bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e6, flops / FLOPS[dt] * 1e6
    return max(tb, to), ("bytes" if tb >= to else "operations")


def phase_kernel_vs_plain(dev):
    """Every case must match: integers and min/max exactly; sums within
    atol + rtol * (running sum of |x| over the segment), because the
    kernel (sequential within a thread, then a tree) and the plain
    Hillis-Steele sweep associate float sums differently.  The walk-shape
    cases (a start in every tile) must give the same bits on a second call.
    Prints each case's wrapper time (CUDA events), device time (graph),
    bound (one read of flags and fields, one write of the fields) and, for
    one_segment, the per-field torch.cumsum / cummax / cummin calls.
    Returns the walk-shape case's numbers."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.ops import segscan

    tol = {torch.float32: (1e-5, 4e-6), torch.float64: (1e-12, 1e-14)}
    lib_fn = {"sum": lambda v: torch.cumsum(v, 0, dtype=v.dtype),
              "max": lambda v: torch.cummax(v, 0).values,
              "min": lambda v: torch.cummin(v, 0).values}
    summary = None
    for name, fields, ops, start in _cases():
        tf = [torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x,
                              device=dev) for x in fields]
        tf = [t.view(torch.uint32) if x.dtype == np.uint32 else t
              for t, x in zip(tf, fields)]
        ts = torch.as_tensor(start, device=dev)
        got = segscan.seg_scan(tf, ops, ts)
        torch.cuda.synchronize()
        ref = segscan.seg_scan_plain(tf, ops, ts)
        max_err = 0.0
        for k, (g, r, o) in enumerate(zip(got, ref, ops)):
            if g.dtype != r.dtype or g.shape != r.shape:
                raise AssertionError(f"{name} field {k}: dtype/shape mismatch")
            if g.dtype.is_floating_point and o == "sum":
                absum = segscan.seg_scan_plain([tf[k].abs().double()], ["sum"],
                                               ts)[0]
                atol, rtol = tol[g.dtype]
                err = (g.double() - r.double()).abs()
                bad = err > atol + rtol * absum
                max_err = max(max_err, float(err.max()))
                if bool(bad.any()):
                    raise AssertionError(
                        f"{name} field {k} ({o}): max |err| {float(err.max())}")
            else:
                same = torch.equal(g.view(torch.int32) if g.dtype == torch.uint32
                                   else g,
                                   r.view(torch.int32) if r.dtype == torch.uint32
                                   else r)
                if not same:
                    raise AssertionError(f"{name} field {k} ({o}) differs")
        if name.startswith("walk_merge"):
            again = segscan.seg_scan(tf, ops, ts)
            if not all(torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                                   else a, b.view(torch.int32)
                                   if b.dtype == torch.uint32 else b)
                       for a, b in zip(got, again)):
                raise AssertionError(f"{name}: a second call gave other bits")
        ms = _median_ms(lambda: segscan.seg_scan(tf, ops, ts))
        dev_us = _device_us(lambda: segscan.seg_scan(tf, ops, ts))
        plain_ms = _median_ms(lambda: segscan.seg_scan_plain(tf, ops, ts),
                              reps=5, warm=1)
        n = len(start)
        nbytes = n + 2 * sum(n * t.element_size() for t in tf)
        bound_us, bound_by = _bound_us(nbytes)
        lib = "none"
        if name == "one_segment":
            # torch has no uint32 cummax / cummin: those fields go as int64
            lf = [t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                  if t.dtype == torch.uint32 else t for t in tf]
            lib_ms = _median_ms(lambda: [lib_fn[o](v) for v, o in zip(lf, ops)])
            lib_dev_us = _device_us(
                lambda: [lib_fn[o](v) for v, o in zip(lf, ops)])
            lib = f"{lib_ms:.4f} library_device_us={lib_dev_us:.1f}"
        log(f"phase 2 {name}: n={n} fields={len(fields)} "
            f"match max_abs_err={max_err:.3e} wrapper_ms={ms:.4f} "
            f"device_us={dev_us:.1f} bound_us={bound_us:.1f} bound_MB={nbytes / 1e6:.1f} "
            f"share={bound_us / dev_us:.3f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib}")
        if name in ("walk_merge_6field_f32", "walk_merge_6field_f64",
                    "one_segment", "n1"):
            PROFILED.append((f"seg_scan {name}",
                             lambda tf=tf, ops=ops, ts=ts:
                             segscan.seg_scan(tf, ops, ts)))
        if name == "walk_merge_6field_f32":
            summary = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                           device_us=dev_us, bound_us=bound_us,
                           bound_by=bound_by, library_ms=None)
    return summary


# ---------------------------------------------------------------------------
# Phase 2b: SpMV kernel vs plain
# ---------------------------------------------------------------------------

C2_ROWS, C2_MEAN, C2_KMAX = 88_000, 110, 1347   # C2 CAS(8e,26o) variational H


def _layouts_from_rows(lengths, rng):
    """ELL and block-ELL layouts of a matrix with the given row lengths,
    uniform random columns and normal values (the row-pointer form both
    layouts share; padding slots hold column 0, value 0), with the row
    counts."""
    import numpy as np
    from sqmc_tpu_torch.ops.spmv import SLOTS
    n = len(lengths)
    nnz = int(lengths.sum())
    row = np.repeat(np.arange(n), lengths)
    rank = np.arange(nnz) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz)
    K = int(lengths.max())
    nb = np.maximum(1, -(-lengths // SLOTS))
    out = {}
    for name, ptr in (("ell", np.arange(n + 1, dtype=np.int64) * K),
                      ("blockell", np.concatenate([[0], np.cumsum(nb)]).astype(np.int64) * SLOTS)):
        c = np.zeros(int(ptr[-1]), np.int32)
        v = np.zeros(int(ptr[-1]))
        c[ptr[:-1][row] + rank] = cols
        v[ptr[:-1][row] + rank] = vals
        out[name] = (c, v, ptr, lengths.astype(np.int32))
    return out, nnz


def _spmv_shapes(dev):
    """HEG-14's variational H (HCI at eps_var 1e-3, 9,475 rows), the
    synthetic C2 shape (88k rows, lengths drawn from a seed: mean ~110,
    max 1,347, about 9.6M nonzeros) and a one-row matrix."""
    import numpy as np
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
    from sqmc_tpu_torch.ops.spmv import blockell_from_coo, ell_from_coo
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    rng = np.random.default_rng(11)
    s = make_heg_system(*HEG, device=dev)
    res = run_hci(s, eps_var=EPS_VAR, eps_var_sched=[EPS_VAR] * 10,
                  verbose=False)
    H = build_sparse_ham(s.table, res.up, res.dn, s.nup, s.ndn, s.norb)
    args = (H.n, H.rows, H.cols, H.vals, H.diag)
    ec, ev, _, ep, en = ell_from_coo(*args)
    bc, bv, _, bp, bn = blockell_from_coo(*args, dtype=np.float64)
    heg = {"ell": (ec.reshape(-1), ev.reshape(-1), ep, en),
           "blockell": (bc, bv, bp, bn)}
    shapes = [("heg14", H.n, heg, int(bn.sum()))]
    lengths = np.clip(np.rint(rng.lognormal(np.log(C2_MEAN) - 0.5, 1.0,
                                            C2_ROWS)), 1, C2_KMAX).astype(np.int64)
    lengths[rng.integers(C2_ROWS)] = C2_KMAX
    c2, nnz = _layouts_from_rows(lengths, rng)
    shapes.append(("c2_synthetic", C2_ROWS, c2, nnz))
    one, nnz1 = _layouts_from_rows(np.array([1]), rng)
    shapes.append(("n1", 1, one, nnz1))
    return shapes


def phase_spmv_vs_plain(dev):
    """ELL and block-ELL, float32 and float64, m = 1 and 4, at each shape:
    every row within |err| <= rtol * sum_k |v_k x_k| of the plain version
    (the kernel sums lane-strided partials by a shuffle tree, the plain
    version with index_add_: other orders; rtol 1e-5 in float32, 1e-13 in
    float64), and a second call gives the same bits.  Prints each case's
    wrapper time (CUDA events), device time (graph), bound (each nonzero
    read once with its column, the row pointers and counts, x and y) and
    the yardstick: cuSPARSE through torch.sparse_csr_tensor(...) @ x on the
    same nonzeros (the port never calls it).  Returns the C2-shape
    block-ELL float32 m = 1 case's numbers (Davidson's call), with the
    max |err| over all cases."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.ops import spmv as S
    rtol = {torch.float32: 1e-5, torch.float64: 1e-13}
    rng = np.random.default_rng(12)
    summary, max_err_all = None, 0.0
    for shape, n, layouts, nnz in _spmv_shapes(dev):
        library = {}               # (dtype, m) -> (ms, device us, max |err|)
        for layout, (c, v, ptr, cnt) in layouts.items():
            cols = torch.as_tensor(c, device=dev)
            ptr_t = torch.as_tensor(ptr, device=dev)
            cnt_t = torch.as_tensor(cnt, device=dev)
            for dt in (torch.float32, torch.float64):
                vals = torch.as_tensor(v, device=dev).to(dt)
                for m in (1, 4):
                    xs = rng.standard_normal((n, m))
                    x = torch.as_tensor(xs[:, 0] if m == 1 else xs,
                                        device=dev).to(dt)
                    got = S.spmv(x, cols, vals, ptr_t, cnt_t)
                    torch.cuda.synchronize()
                    ref = S.spmv_plain(x, cols, vals, ptr_t, cnt_t)
                    absum = S.spmv_plain(x.abs().double(), cols,
                                         vals.abs().double(), ptr_t, cnt_t)
                    if got.shape != ref.shape or got.dtype != dt:
                        raise AssertionError(f"spmv {shape}/{layout}: shape "
                                             "or dtype differs")
                    err = (got.double() - ref.double()).abs()
                    max_err = float(err.max())
                    max_err_all = max(max_err_all, max_err)
                    if bool((err > rtol[dt] * absum).any()):
                        raise AssertionError(
                            f"spmv {shape}/{layout}/{dt}/m={m}: max |err| "
                            f"{max_err}")
                    if not torch.equal(got, S.spmv(x, cols, vals, ptr_t, cnt_t)):
                        raise AssertionError(f"spmv {shape}/{layout}/{dt}/"
                                             f"m={m}: a second call gave "
                                             "other bits")
                    call = functools.partial(S.spmv, x, cols, vals, ptr_t,
                                             cnt_t)
                    ms = _median_ms(call)
                    dev_us = _device_us(call)
                    plain_ms = _median_ms(
                        lambda: S.spmv_plain(x, cols, vals, ptr_t, cnt_t),
                        reps=5, warm=1)
                    if (dt, m) not in library:
                        library[(dt, m)] = _library_spmv(
                            x, cols, vals, ptr_t, cnt_t, ref)
                    lib_ms, lib_us, lib_err = library[(dt, m)]
                    es = torch.finfo(dt).bits // 8
                    nbytes = nnz * (4 + es) + (n + 1) * 8 + n * 4 + 2 * n * m * es
                    dname = str(dt).split('.')[-1]
                    bound_us, bound_by = _bound_us(nbytes, 2.0 * nnz * m, dname)
                    log(f"phase 2b spmv {shape} {layout} {dname} m={m}: "
                        f"rows={n} nnz={nnz} slots={len(c)} match "
                        f"max_abs_err={max_err:.3e} wrapper_ms={ms:.4f} "
                        f"device_us={dev_us:.1f} bound_us={bound_us:.1f} "
                        f"bound_MB={nbytes / 1e6:.1f} "
                        f"share={bound_us / dev_us:.3f} plain_ms={plain_ms:.4f} "
                        f"library_ms={lib_ms:.4f} library_device_us={lib_us:.1f} "
                        f"library_max_abs_err={lib_err:.3e}")
                    if shape == "c2_synthetic" and m == 1:
                        PROFILED.append((f"spmv {shape} {layout} {dname} m=1",
                                         call))
                    if (shape, layout, dt, m) == ("c2_synthetic", "blockell",
                                                  torch.float32, 1):
                        summary = dict(ms=ms, plain_ms=plain_ms,
                                       device_us=dev_us, bound_us=bound_us,
                                       bound_by=bound_by, library_ms=lib_ms)
            del cols, ptr_t, cnt_t
        torch.cuda.empty_cache()
    summary["max_abs_err"] = max_err_all
    return summary


def _library_spmv(x, cols, vals, row_ptr, row_nnz, ref):
    """The same product as one PyTorch call: a CSR tensor of the layout's
    nonzeros times x (cuSPARSE).  Returns (wrapper ms, device us, max |err|
    against the plain version)."""
    import torch
    from sqmc_tpu_torch.ops.spmv import entry_slots
    n = row_nnz.numel()
    crow = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
    crow[1:] = torch.cumsum(row_nnz, 0)
    _, slot = entry_slots(row_ptr, row_nnz)
    A = torch.sparse_csr_tensor(crow, cols[slot].to(torch.int64), vals[slot],
                                size=(n, x.shape[0]))
    call = lambda: A @ x                                  # noqa: E731
    y = call()
    torch.cuda.synchronize()
    return (_median_ms(call), _device_us(call),
            float((y.double() - ref.double()).abs().max()))


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def phase_main_path(dev, nblk=NBLK, nblk_eq=NBLK_EQ):
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import (WalkConfig, build_walk_tables,
                                          init_walk_state, run_walk)
    from sqmc_tpu_torch.ops import segscan
    from sqmc_tpu_torch.systems.heg.system import make_heg_system

    t0 = time.time()
    system = make_heg_system(*HEG, device=dev)
    res = run_hci(system, eps_var=EPS_VAR, eps_var_sched=[EPS_VAR] * 10,
                  verbose=False)
    torch.cuda.synchronize()
    t_hci = time.time() - t0
    e_var = float(res.energies[0])
    log(f"phase 3 hci: ndets={len(res.up)} e_var={e_var:.9f} "
        f"seconds={t_hci:.2f}")
    if len(res.up) != GOLD_NDET or abs(e_var - GOLD_EVAR) > 1e-7:
        raise AssertionError(f"HCI golden missed: {len(res.up)} dets, "
                             f"E_var {e_var:.10f}")

    t1 = time.time()
    trial = build_trial_wavefunction(system, eps_var=EPS_VAR, n_psi_t=2000,
                                     n_imp=20000)
    torch.cuda.synchronize()
    t_trial = time.time() - t1
    log(f"phase 3 trial: n_imp={len(trial.imp_up)} "
        f"n_psit={len(trial.psit_up)} n_ct={len(trial.ct_up)} "
        f"e_trial={trial.e_trial:.9f} seconds={t_trial:.2f}")

    cfg = WalkConfig(mwalk=458_752, cap_spawn=262_144, norb=system.norb,
                     nup=system.nup, ndn=system.ndn, n_words=system.n_words,
                     tau=2e-3, w_abs_target=W_TARGET, spawn_granularity=2.0,
                     min_wt=0.5, r_initiator=0.5, f32_state=True,
                     proj_bf16=False, has_singles=False)
    t2 = time.time()
    tables = build_walk_tables(system, trial, cfg)
    state = init_walk_state(cfg, trial, W_BEGIN, trial.e_trial, tables)
    torch.cuda.synchronize()
    t_tables = time.time() - t2
    log(f"phase 3 tables: dense_projector_MB="
        f"{tables.imp_dense.numel() * 4 / 1e6:.1f} seconds={t_tables:.2f}")

    segscan.reset_launches()
    t3 = time.time()
    out = run_walk(system, trial, cfg, nstep=NSTEP, nblk=nblk,
                   nblk_eq=nblk_eq, w_abs_begin=W_BEGIN,
                   e_trial_initial=trial.e_trial, verbose=True,
                   max_eq_extensions=2, tables=tables, state=state, seed=1)
    torch.cuda.synchronize()
    t_walk = time.time() - t3
    launches = segscan.launches

    ntail = min(1000, out.n_measured)
    pop = float(np.mean(out.w_abs_trace[-ntail:]))
    nwalk = float(np.mean(out.nwalk_trace[-ntail:]))
    gens = out.steps_per_sec
    bias = out.e_mixed - ORACLE
    gate = max(5 * out.e_err, 3e-4)
    log(f"phase 3 walk: setup_seconds hci={t_hci:.2f} trial={t_trial:.2f} "
        f"tables={t_tables:.2f}; walk_seconds={t_walk:.1f} "
        f"measured_gens={out.n_measured} gen_per_s={gens:.3f} "
        f"occupied_det_walker_steps_per_s={nwalk * gens:.6g} "
        f"pop={pop:.1f} nwalk={nwalk:.1f} capacity_grows={out.capacity_grows}")
    log(f"phase 3 energy: e_mixed={out.e_mixed:.9f} +- {out.e_err:.9f} "
        f"t_corr={out.t_corr:.1f} bias_vs_oracle_mHa={1e3 * bias:.4f} "
        f"gate_mHa={1e3 * gate:.4f} seg_scan_launches={launches}")

    if bool(out.state.overflow):
        raise AssertionError("unresolved capacity overflow")
    if not (np.all(np.isfinite(out.w_abs_trace)) and np.isfinite(out.e_mixed)
            and np.isfinite(out.e_err)):
        raise AssertionError("non-finite walk output")
    if abs(pop - W_TARGET) > 0.1 * W_TARGET:
        raise AssertionError(f"population {pop:.0f} not within 10% of target")
    if launches <= 0:
        raise AssertionError("the main path never launched the seg-scan kernel")
    if abs(bias) >= gate:
        raise AssertionError(f"|e_mixed - oracle| = {abs(bias):.6f} >= "
                             f"{gate:.6f}")
    return launches, system, res, trial


# ---------------------------------------------------------------------------
# Phase 4: SHCI (device Davidson, deterministic and semistochastic PT)
# ---------------------------------------------------------------------------

GOLD_PT, GOLD_NCONN, GOLD_TOTAL = -0.000939196, 501_881, 48.051813420
EPS_PT, EPS_PT_BIG, PT_TARGET, N_MC = 2e-7, 1e-5, 1e-5, 200


def phase_shci(dev, system, res):
    """run_hci(device_davidson=True) -> deterministic PT -> do_pt
    semistochastic on HEG-14, against the goldens of tests/test_hci.py and
    tests/test_pt.py; PT runs on phase 3's float64-Davidson wavefunction.
    Returns the SpMV launches of this run."""
    import torch
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.pt import do_pt, second_order_pt
    from sqmc_tpu_torch.ops import segscan, spmv

    spmv.reset_launches()
    segscan.reset_launches()
    t0 = time.time()
    dd = run_hci(system, eps_var=EPS_VAR, eps_var_sched=[EPS_VAR] * 10,
                 verbose=False, device_davidson=True)
    torch.cuda.synchronize()
    t_hci = time.time() - t0
    e_dd = float(dd.energies[0])
    same = (torch.equal(dd.up, res.up) and torch.equal(dd.dn, res.dn))
    log(f"phase 4 hci device_davidson: ndets={len(dd.up)} e_var={e_dd:.9f} "
        f"same_dets_as_phase3={same} seconds={t_hci:.2f} "
        f"spmv_launches={spmv.launches}")
    if not same or abs(e_dd - GOLD_EVAR) > 1e-6:
        raise AssertionError(f"device-Davidson HCI missed: {len(dd.up)} "
                             f"dets, E_var {e_dd:.10f}")

    e_var = float(res.energies[0])
    t1 = time.time()
    pt, nconn = second_order_pt(system, res.up, res.dn, res.wts[:, 0], e_var,
                                EPS_PT, verbose=False)
    torch.cuda.synchronize()
    t_pt = time.time() - t1
    total = e_var + pt + system.extra["energy_madelung"]
    log(f"phase 4 deterministic pt: eps_pt={EPS_PT:g} pt={pt:.12f} "
        f"n_connected={nconn} total_with_madelung={total:.9f} "
        f"seconds={t_pt:.2f}")
    if abs(pt - GOLD_PT) > 1e-8 or nconn != GOLD_NCONN \
            or abs(total - GOLD_TOTAL) > 1e-7:
        raise AssertionError("deterministic PT golden missed")

    t2 = time.time()
    out = do_pt(system, res.up, res.dn, res.wts[:, 0], res.diag, e_var,
                EPS_VAR, EPS_PT, eps_pt_big=EPS_PT_BIG,
                target_error=PT_TARGET, n_mc=N_MC, verbose=False)
    torch.cuda.synchronize()
    t_ss = time.time() - t2
    gate = 5 * out["pt_err"] + 1e-5
    log(f"phase 4 semistochastic pt: eps_pt_big={EPS_PT_BIG:g} "
        f"n_mc={N_MC} mode={out['mode']} pt={out['pt']:.9f} "
        f"+- {out['pt_err']:.9f} pt_big={out['pt_big']:.9f} "
        f"samples={out['n_samples']} dev_from_golden={out['pt'] - GOLD_PT:.3e} "
        f"gate={gate:.3e} seconds={t_ss:.2f}")
    if out["mode"] != "semistochastic" or not abs(out["pt"] - GOLD_PT) < gate:
        raise AssertionError("semistochastic PT outside 5 sigma + 1e-5")
    launches = spmv.launches
    log(f"phase 4 stages: hci_seconds={t_hci:.2f} det_pt_seconds={t_pt:.2f} "
        f"stoch_pt_seconds={t_ss:.2f} spmv_launches={launches} "
        f"seg_scan_launches={segscan.launches}")
    if launches <= 0:
        raise AssertionError("the SHCI path never launched the SpMV kernel")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: float64-state walk through the block-ELL projection
# ---------------------------------------------------------------------------

def phase_f64_walk(dev, system, trial):
    """A few blocks of the walk in float64 state on phase 3's trial: every
    generation's D-space projection is the block-ELL SpMV kernel."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.ops import segscan, spmv

    cfg = WalkConfig(mwalk=458_752, cap_spawn=262_144, norb=system.norb,
                     nup=system.nup, ndn=system.ndn, n_words=system.n_words,
                     tau=2e-3, w_abs_target=W_TARGET, spawn_granularity=2.0,
                     min_wt=0.5, r_initiator=0.5, f32_state=False,
                     proj_bf16=False, has_singles=False)
    spmv.reset_launches()
    segscan.reset_launches()
    t0 = time.time()
    out = run_walk(system, trial, cfg, nstep=100, nblk=2, nblk_eq=2,
                   w_abs_begin=W_TARGET, e_trial_initial=trial.e_trial,
                   verbose=False, max_eq_extensions=0, seed=2)
    torch.cuda.synchronize()
    t_walk = time.time() - t0
    launches = spmv.launches
    pop = float(np.mean(out.w_abs_trace[-100:]))
    log(f"phase 5 f64 walk: gens={len(out.w_abs_trace)} "
        f"gen_per_s={out.steps_per_sec:.3f} pop={pop:.1f} "
        f"e_mixed={out.e_mixed:.9f} +- {out.e_err:.9f} "
        f"spmv_launches={launches} seg_scan_launches={segscan.launches} "
        f"seconds={t_walk:.1f}")
    if launches <= 0:
        raise AssertionError("the f64 walk never launched the SpMV kernel")
    if bool(out.state.overflow) or not (
            np.all(np.isfinite(out.w_abs_trace)) and np.isfinite(out.e_mixed)):
        raise AssertionError("non-finite or overflowing f64 walk")
    if abs(pop - W_TARGET) > 0.1 * W_TARGET:
        raise AssertionError(f"population {pop:.0f} not within 10% of target")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the card-input entry point, python -m sqmc_tpu_torch
# ---------------------------------------------------------------------------

HEG_DECK = """\
1 1                                irand_seed
hci                                run_type
1e-3 2e-7 1e-5 1                   eps_var, eps_pt, target_error, n_states
f                                  dump_wf_var
'heg' 0                            hamiltonian_type,ipr
3                                  n_dim
0.5                                r_s
14 7                               nelec, nup
1.49                               cutoff_radius
"""

# The C2_v2z_curve decks' orbital irreps (d2h, 26 orbitals), schedule and
# sector; the integrals are synthetic (the C2 FCIDUMP is not in the repo).
C2_SYMS = [1, 5, 3, 2, 1, 7, 6, 5, 1, 2, 3, 1, 6, 7, 5, 4, 1, 5, 3, 2, 8, 5,
           1, 7, 6, 5]
C2_SCALE, C2_SEED, C2_CORE = 0.02, 26, -75.0
C2_SYM_CARD = ",".join(map(str, C2_SYMS)) + ","
C2_CHEM_CARDS = f"""\
'chem' 0                           hamiltonian_type,ipr
8 4                                nelec, nup
d2h                                point_group
t                                  time_sym
1                                  z
26                                 norb
"""
C2_HCI_DECK = f"""\
1 1                                irand_seed
hci                                run_type
1e-3 1e-7 1e-4 2                   eps_var, eps_pt, target_error, n_states
f                                  dump_wf_var
{C2_CHEM_CARDS}{C2_SYM_CARD} orbital_symmetries(1:norb)
1                                  spatial_symmetry_wf
&selected_ci eps_var_sched=2*2e-3 /
&hf_det hf_symmetry=1 /
"""
C2_W_TARGET = 200_000.0
C2_WALK_DECK = f"""\
11 7                               irand_seed
100 4 4 0                          nstep,nblk,nblk_eq,ipr
140000 {C2_W_TARGET:.0f} 0                w_abs_gen_begin, w_abs_gen_target, MWALK
0.1 0.                             tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
heat_bath2 0 0.5 0 1.              proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
none                               run_type
.true. f                           semistochastic, use_exponential_projector
f                                  diff_from_psi_t
2000                               size_deterministic
f f 0.5                            hf_to_psit, c_t_initiator, always_spawn_cutoff
{C2_CHEM_CARDS}0                                  n_core_spatial_orb
2                                  trial_wf_iterations
26 26                              norb_trial_wf
1 20                               trial_wf_initiators
50 80                              n_sym_uniq_det_trial_wf
{C2_SYM_CARD} orbital_symmetries(1:norb)
1                                  spatial_symmetry_wf
0                                  diagonalize_ham
&hf_det hf_symmetry=1 /
"""


def _sym_mask(syms, norb):
    """Bool over the compact 8-fold two-body array: the irrep product of
    the four orbitals is not totally symmetric (d2h labels, XOR product)."""
    import numpy as np
    from sqmc_tpu_torch.systems.chem.integrals import pair_index, quad_index
    s0 = np.asarray(syms) - 1
    npair = norb * (norb + 1) // 2
    hi, lo = np.tril_indices(norb)
    ph, pl = np.empty(npair, int), np.empty(npair, int)
    ph[pair_index(hi, lo)], pl[pair_index(hi, lo)] = hi, lo
    qa, qb = np.tril_indices(npair)
    bad = np.zeros(npair * (npair + 1) // 2, bool)
    bad[quad_index(qa, qb)] = (s0[ph[qa]] ^ s0[pl[qa]] ^ s0[ph[qb]]
                               ^ s0[pl[qb]]) != 0
    return bad


def write_c2_fcidump(path, scale=C2_SCALE, seed=C2_SEED):
    """A synthetic FCIDUMP at C2 CAS(8e,26o)'s shape from a seed: 26
    orbitals with the C2 decks' d2h irreps, 8 electrons (MS2 0); every
    integral whose irrep product is not totally symmetric is zero; the
    diagonal h ascends (4 occupied orbitals in [-2.5, -0.8], 22 virtual in
    [0, 3]); direct integrals (ii|jj) in [0.4, 0.5]; every other one-
    and two-body integral normal with standard deviation `scale`, so the
    HF det dominates."""
    import numpy as np
    from sqmc_tpu_torch.systems.chem.fcidump import n_eri, write_fcidump
    from sqmc_tpu_torch.systems.chem.integrals import pair_index, quad_index
    rng = np.random.default_rng(seed)
    norb = len(C2_SYMS)
    s0 = np.asarray(C2_SYMS) - 1
    h = rng.normal(size=(norb, norb)) * scale
    h = 0.5 * (h + h.T)
    h[s0[:, None] != s0[None, :]] = 0.0
    h[np.diag_indices(norb)] = np.sort(np.concatenate(
        [rng.uniform(-2.5, -0.8, 4), rng.uniform(0.0, 3.0, norb - 4)]))
    eri = rng.normal(size=n_eri(norb)) * scale
    eri[_sym_mask(C2_SYMS, norb)] = 0.0
    d = pair_index(np.arange(norb), np.arange(norb))
    J = 0.4 + 0.1 * rng.random((norb, norb))
    eri[quad_index(d[:, None], d[None, :])] = 0.5 * (J + J.T)
    write_fcidump(path, h, eri, C2_CORE, C2_SYMS, nelec=8, ms2=0)
    return h, eri


def _run_cli(tag, deck, workdir, *extra):
    """python -m sqmc_tpu_torch -i deck on the card, in a subprocess whose
    exit code becomes the smoke's.  The whole output goes to
    <workdir>/<tag>.log; returns (stdout, seconds, {kernel: launches})."""
    import re
    deck_path = os.path.join(workdir, f"{tag}.deck")
    with open(deck_path, "w") as f:
        f.write(deck)
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "sqmc_tpu_torch", "-i",
                          deck_path, *extra], capture_output=True, text=True,
                         cwd=workdir, timeout=600,
                         env=dict(os.environ, PYTHONPATH=HERE))
    sec = time.time() - t0
    with open(os.path.join(workdir, f"{tag}.log"), "w") as f:
        f.write(out.stdout + out.stderr)
    if out.returncode != 0:
        log(out.stdout[-3000:] + out.stderr[-3000:])
        log(f"cli deck {tag}: python -m sqmc_tpu_torch exited "
            f"{out.returncode}")
        sys.exit(out.returncode)
    m = re.search(r"Kernel launches: seg_scan=(\d+) spmv=(\d+)", out.stdout)
    counts = dict(seg_scan=int(m.group(1)), spmv=int(m.group(2)))
    log(f"cli deck {tag}: seconds={sec:.2f} seg_scan_launches="
        f"{counts['seg_scan']} spmv_launches={counts['spmv']}")
    return out.stdout, sec, counts


def _grab(text, pattern, every=False):
    import re
    found = [float(x) for x in re.findall(pattern + r"\s*([-+0-9.eE]+)", text)]
    if not found:
        raise AssertionError(f"no line matching {pattern!r}")
    return found if every else found[0]


def phase_cli_heg(workdir):
    """6a: the HEG-14 HCI+PT deck through the CLI, against the goldens of
    tests/test_cli.py:16-28."""
    text, sec, counts = _run_cli("6a_heg14", HEG_DECK, workdir)
    e_var = _grab(text, r"Variational energy=")
    pt = _grab(text, r"Second-order PT energy lowering=")
    tot = _grab(text, r"Total energy \(includ. Madelung\)=")
    log(f"phase 6a heg14 cli: e_var={e_var:.9f} pt={pt:.9f} "
        f"total_with_madelung={tot:.9f} seconds={sec:.2f}")
    if abs(e_var - GOLD_EVAR) > 1e-6 or abs(pt - GOLD_PT) > 1e-8 \
            or abs(tot - GOLD_TOTAL) > 1e-7:
        raise AssertionError("the HEG-14 deck missed its goldens")
    return counts


def phase_cli_c2(dev, workdir):
    """6b: the C2-shaped time-symmetrized decks.  HCI + PT through the CLI
    (z = +1, d2h, hf_symmetry 1, two states, deterministic PT at eps_pt
    1e-7); run_hci(device_davidson=True) in this process on the same
    system (K2 with m = 2) within 1e-6 of the CLI's E_var, and K2 against
    its plain version on the final symmetrized H at m = 2; then a walk
    deck at the bench's population through the CLI (f64 state, so each
    generation projects through K2 and merges through K1)."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
    from sqmc_tpu_torch.ops import spmv as S
    from sqmc_tpu_torch.systems.base import make_chem_system

    fcidump = os.path.join(workdir, "FCIDUMP_c2_synthetic")
    t0 = time.time()
    write_c2_fcidump(fcidump)
    t_write = time.time() - t0
    text, sec_hci, c_hci = _run_cli("6b_c2_hci", C2_HCI_DECK, workdir, "-f",
                                    fcidump)
    e_var = _grab(text, r"Variational energy=")
    e_states = _grab(text, r"State \d: variational energy=", every=True)
    pts = _grab(text, r"Second-order PT energy lowering=", every=True)
    tots = _grab(text, r"Total energy\(\d\)=", every=True)
    ndet = int(_grab(text, r"Final Iteration\s+\d+"))
    log(f"phase 6b c2 hci cli: ndets={ndet} e_var={e_states} pt={pts} "
        f"e_tot={tots} fcidump_seconds={t_write:.2f} seconds={sec_hci:.2f}")
    if not 5_000 <= ndet <= 50_000 or len(pts) != 2 or not (
            e_states[1] > e_states[0] and all(p < 0 for p in pts)):
        raise AssertionError("the C2-shaped HCI deck is off its shape")

    S.reset_launches()
    t1 = time.time()
    system = make_chem_system(fcidump, time_sym=True, z=1, point_group="d2h",
                              hf_symmetry=1, device=dev)
    dd = run_hci(system, eps_var=1e-3, eps_var_sched=[2e-3, 2e-3, 1e-3],
                 n_states=2, verbose=False, device_davidson=True)
    torch.cuda.synchronize()
    t_dd = time.time() - t1
    dd_launches = S.launches
    log(f"phase 6b c2 device_davidson: ndets={len(dd.up)} "
        f"e_var={dd.energies.tolist()} dev_from_cli={dd.energies[0] - e_var:.3e} "
        f"spmv_launches={dd_launches} seconds={t_dd:.2f}")
    if len(dd.up) != ndet or abs(dd.energies[0] - e_var) > 1e-6 \
            or dd_launches <= 0:
        raise AssertionError("device-Davidson HCI disagrees with the CLI")

    H = build_sparse_ham(system.table, dd.up, dd.dn, system.nup, system.ndn,
                         system.norb, time_sym=True, z=1)
    c, v, _, p, k = S.blockell_from_coo(H.n, H.rows, H.cols, H.vals, H.diag,
                                        dtype=np.float64)
    cols, ptr, cnt = (torch.as_tensor(a, device=dev) for a in (c, p, k))
    rng = np.random.default_rng(13)
    for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        vals = torch.as_tensor(v, device=dev).to(dt)
        x = torch.as_tensor(rng.standard_normal((H.n, 2)), device=dev).to(dt)
        got = S.spmv(x, cols, vals, ptr, cnt)
        torch.cuda.synchronize()
        ref = S.spmv_plain(x, cols, vals, ptr, cnt)
        bound = S.spmv_plain(x.abs().double(), cols, vals.abs().double(), ptr,
                             cnt)
        err = (got.double() - ref.double()).abs()
        log(f"phase 6b spmv on the symmetrized H: rows={H.n} nnz="
            f"{int(cnt.sum())} {str(dt).split('.')[-1]} m=2 match "
            f"max_abs_err={float(err.max()):.3e}")
        if bool((err > rtol * bound).any()):
            raise AssertionError("K2 disagrees with its plain version on the "
                                 "time-symmetrized H")

    text, sec_walk, c_walk = _run_cli("6b_c2_walk", C2_WALK_DECK, workdir,
                                      "-f", fcidump)
    e_mix = _grab(text, r"e_mixed=")
    e_err = _grab(text, r"e_mixed=\s*[-+0-9.eE]+\s*\+-")
    w_blocks = _grab(text, r"w_abs=", every=True)
    rates = _grab(text, r"steps/s=", every=True)
    gens = _grab(text, r"gen_per_s=")
    mwalk = int(_grab(text, r"Setting MWALK=[^=]*="))
    oracle = tots[0]
    gate = max(5 * e_err, 2e-3)
    log(f"phase 6b c2 walk cli: mwalk={mwalk} w_abs_blocks="
        f"{[round(w, 1) for w in w_blocks]} block_steps_per_s="
        f"{[round(r, 1) for r in rates]} gen_per_s={gens:.3f} "
        f"e_mixed={e_mix:.9f} +- {e_err:.9f} vs_e_var_plus_pt_mHa="
        f"{1e3 * (e_mix - oracle):.4f} gate_mHa={1e3 * gate:.4f} "
        f"seconds={sec_walk:.2f}")
    if "capacity overflow" in text:
        raise AssertionError("the walk overflowed its capacity")
    if abs(w_blocks[-1] - C2_W_TARGET) > 0.1 * C2_W_TARGET:
        raise AssertionError(f"population {w_blocks[-1]:.0f} missed the "
                             "target")
    if not (np.isfinite(e_mix) and np.isfinite(e_err)) \
            or abs(e_mix - oracle) > gate:
        raise AssertionError("e_mixed is not within max(5 sigma, 2 mHa) of "
                             "E_var + PT")
    if c_walk["seg_scan"] <= 0 or c_walk["spmv"] <= 0:
        raise AssertionError("the walk deck did not run both kernels")
    log(f"phase 6b stages: fcidump={t_write:.2f} cli_hci_pt={sec_hci:.2f} "
        f"device_davidson={t_dd:.2f} cli_walk={sec_walk:.2f}")
    return dict(hci=c_hci, device_davidson=dd_launches, walk=c_walk)


def phase_ts_oracle(dev):
    """6c: the small time-symmetrized oracle (the random 6-orbital chem
    system of tests/test_time_sym_walk.py, 2 + 2 electrons, integrals made
    here with numpy) on the card with D = the whole symmetrized space: the
    deterministic-limit walk in f64 state reaches the exact e0 of the
    sector (dense symmetrized H) to 1e-8, for z = +1 and for z = -1 from
    an open-shell start."""
    import numpy as np
    import torch
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.ops import segscan, spmv
    from sqmc_tpu_torch.systems.base import make_system_from_arrays
    from sqmc_tpu_torch.systems.chem import slater
    from sqmc_tpu_torch.systems.chem.fcidump import n_eri

    rng = np.random.default_rng(3)
    h = rng.normal(size=(6, 6))
    h = 0.5 * (h + h.T)
    eri = rng.normal(size=n_eri(6))
    core = float(rng.normal())
    counts = {}
    for z in (1, -1):
        t0 = time.time()
        s = make_system_from_arrays(h, eri, core, 2, 2, device=dev)
        s.time_sym, s.z = True, z
        if z < 0:
            s.hf_dn = dets.det_from_orbs((0, 2), 6)
        trial = build_trial_wavefunction(s, eps_var=1e-9, n_psi_t=400,
                                         n_imp=400)
        bu, bd = (dets.to_bits(w, 6) for w in (trial.imp_up, trial.imp_dn))
        n = len(bu)
        i, j = (a.reshape(-1) for a in torch.meshgrid(
            torch.arange(n, device=dev), torch.arange(n, device=dev),
            indexing="ij"))
        e0 = float(torch.linalg.eigvalsh(slater.pair_matrix_elements_time_sym(
            s.table, bu[i], bd[i], bu[j], bd[j], z).reshape(n, n))[0])
        cfg = WalkConfig(mwalk=1024, cap_spawn=4096, norb=6, nup=2, ndn=2,
                         n_words=1, tau=5e-3, w_abs_target=500.0,
                         has_singles=True, time_sym=True, z=z, cap_fresh=512)
        segscan.reset_launches()
        spmv.reset_launches()
        out = run_walk(s, trial, cfg, nstep=30, nblk=2, nblk_eq=1,
                       w_abs_begin=500.0, e_trial_initial=e0, verbose=False)
        torch.cuda.synchronize()
        counts[z] = dict(seg_scan=segscan.launches, spmv=spmv.launches)
        err = out.e_mixed - e0
        log(f"phase 6c ts oracle z={z:+d}: dim={n} e0={e0:.12f} "
            f"e_mixed={out.e_mixed:.12f} err={err:.3e} "
            f"seg_scan_launches={segscan.launches} "
            f"spmv_launches={spmv.launches} seconds={time.time() - t0:.2f}")
        if abs(err) > 1e-8 or segscan.launches <= 0 or spmv.launches <= 0:
            raise AssertionError(f"the z={z} oracle missed e0 by {err:.3e}")
    return counts


def phase_cli(dev):
    """Phase 6: 6a, 6b and 6c, each path's kernel counts set to 0 just
    before it (in the CLI's process or this one) and read just after."""
    workdir = os.path.join(HERE, "build", "smoke_phase6")
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        os.remove(os.path.join(workdir, name))
    t0 = time.time()
    heg = phase_cli_heg(workdir)
    t1 = time.time()
    c2 = phase_cli_c2(dev, workdir)
    t2 = time.time()
    oracle = phase_ts_oracle(dev)
    log(f"phase 6 launches: 6a_heg14_cli={heg} 6b_c2_hci_cli={c2['hci']} "
        f"6b_c2_device_davidson_spmv={c2['device_davidson']} "
        f"6b_c2_walk_cli={c2['walk']} 6c_oracle={oracle}")
    log(f"phase 6 stages: 6a={t1 - t0:.2f} 6b={t2 - t1:.2f} "
        f"6c={time.time() - t2:.2f} seconds")


# ---------------------------------------------------------------------------
# Phase 7: Hubbard determinant systems, the other projectors
# ---------------------------------------------------------------------------

HUB = (4, 4, 1.0, 4.0, 5, 5)          # l_x, l_y, t, U, nup, ndn
HUBK_HCI_DECK = """\
1 1                                irand_seed
hci                                run_type
1e-3 2e-6 1e-5 1                   eps_var, eps_pt, target_error, n_states
f                                  dump_wf_var
'hubbardk' 0                       hamiltonian_type,ipr
4 4                                l_x, l_y
t f                                pbc, neel_up_only
1. 4.                              t, U
5 5                                n_alpha, n_beta
&selected_ci eps_var_sched=2*2e-3 /
"""
HUB2_FN_DECK = """\
13 5                               irand_seed
100 4 2 0                          nstep,nblk,nblk_eq,ipr
1500 3000 4096                     w_abs_gen_begin, w_abs_gen_target, MWALK
0.3 0.02                           tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
fast_heatbath 1 0. 0 1.            proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
fixed_node1                        run_type
.false. f                          semistochastic, use_exponential_projector
0. 0.                              psi_g_energy, psi_g_epsilon
'hubbard2' 0                       hamiltonian_type,ipr
1 8                                l_x, l_y
f f                                pbc, neel_up_only
1. 4.                              t, U
2 2                                n_alpha, n_beta
gutz                               wf_type
0.7                                g
0                                  diagonalize_ham
"""
HUB_W = 200_000.0                     # 7a walks' population
HUB_TAU, HUB_CT_TAU = 5e-4, 5e-3      # linear projector; CT at ten times it
HUB2_W, HUB2_TAU_MAX, HUB2_G, HUB2_EPS = 100_000.0, 1e-3, 0.6, 0.03
COUNTS7 = dict(seg_scan=0, spmv=0)    # phase 7's launches, path by path


def _counted(fn):
    """Run fn() with both kernel counts set to 0 just before and read just
    after; adds them to COUNTS7 and returns (result, counts)."""
    from sqmc_tpu_torch.ops import segscan, spmv
    segscan.reset_launches()
    spmv.reset_launches()
    out = fn()
    c = dict(seg_scan=segscan.launches, spmv=spmv.launches)
    for k in c:
        COUNTS7[k] += c[k]
    return out, c


def _gate_walk(tag, out, target_pop, oracle, floor, lower_bound_only=False):
    """The walk gates: finite output, no capacity growth or overflow,
    population within 10% of its target, and e_mixed within max(5 sigma,
    floor) of the oracle (or, for a variational bound, not below it)."""
    import numpy as np
    pop = float(np.mean(out.w_abs_trace[-min(200, out.n_measured):]))
    dev_ = out.e_mixed - oracle
    gate = max(5 * out.e_err, floor)
    if not (np.all(np.isfinite(out.w_abs_trace)) and np.isfinite(out.e_mixed)
            and np.isfinite(out.e_err)):
        raise AssertionError(f"{tag}: non-finite walk output")
    if bool(out.state.overflow) or out.capacity_grows:
        raise AssertionError(f"{tag}: capacity overflow")
    if abs(pop - target_pop) > 0.1 * target_pop:
        raise AssertionError(f"{tag}: population {pop:.0f} not within 10% "
                             f"of {target_pop:.0f}")
    if lower_bound_only:
        if dev_ < -5 * out.e_err:
            raise AssertionError(f"{tag}: e_mixed {out.e_mixed:.6f} below "
                                 f"E0 {oracle:.6f} by more than 5 sigma")
    elif abs(dev_) >= gate:
        raise AssertionError(f"{tag}: |e_mixed - oracle| = {abs(dev_):.6f} "
                             f">= {gate:.6f}")
    return pop, dev_, gate


def phase_hubbard_k(dev, workdir, smi):
    """7a: the 4x4 momentum-space Hubbard cluster at full width.  Returns
    E_var + PT of the CLI deck (the energy the other cells are held to)."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system

    text, sec, c_cli = _run_cli("7a_hubbardk_hci", HUBK_HCI_DECK, workdir)
    e_var = _grab(text, r"Variational energy=")
    pt = _grab(text, r"Second-order PT energy lowering=")
    e_tot = _grab(text, r"Total energy=")
    ndet = int(_grab(text, r"Final Iteration\s+\d+"))
    log(f"phase 7a hubbardk hci cli: ndets={ndet} e_var={e_var:.9f} "
        f"pt={pt:.9f} e_tot={e_tot:.9f} seconds={sec:.2f}")
    if not 10_000 <= ndet <= 100_000 or not pt < 0:
        raise AssertionError("the Hubbard-k HCI deck is off its shape")

    def dd():
        system = make_hubbard_k_system(*HUB, device=dev)
        res = run_hci(system, eps_var=1e-3, eps_var_sched=[2e-3, 2e-3, 1e-3],
                      verbose=False, device_davidson=True)
        torch.cuda.synchronize()
        return system, res
    t0 = time.time()
    (system, res), c_dd = _counted(dd)
    log(f"phase 7a hubbardk device_davidson: ndets={len(res.up)} "
        f"e_var={res.energies[0]:.9f} dev_from_cli="
        f"{res.energies[0] - e_var:.3e} spmv_launches={c_dd['spmv']} "
        f"seconds={time.time() - t0:.2f}")
    if len(res.up) != ndet or abs(res.energies[0] - e_var) > 1e-6 \
            or c_dd["spmv"] <= 0:
        raise AssertionError("device-Davidson HCI disagrees with the CLI")

    t0 = time.time()
    trial = build_trial_wavefunction(system, eps_var=1e-3, n_psi_t=2000,
                                     n_imp=10_000)
    torch.cuda.synchronize()
    log(f"phase 7a hubbardk trial: n_imp={len(trial.imp_up)} "
        f"n_psit={len(trial.psit_up)} n_ct={len(trial.ct_up)} "
        f"seconds={time.time() - t0:.2f}")
    base = dict(mwalk=458_752, cap_spawn=262_144, norb=system.norb,
                nup=system.nup, ndn=system.ndn, n_words=1,
                w_abs_target=HUB_W, min_wt=0.5, f32_state=True,
                has_singles=False)
    # A CT child carries at least always_spawn_cutoff x granularity x
    # exp(tau x rate) = 0.5 x 1.41 here, so the initiator threshold must lie
    # above that (1.0, granularity 1): at the linear walk's 0.5 every child
    # would found an initiator and the approximation would be void.
    # The population (an L1 norm) more than doubles while Psi_T's 2,000 dets
    # spread over ~2.4e5, so the walks start well below the target.
    runs = (("linear", dict(tau=HUB_TAU, spawn_granularity=2.0,
                            r_initiator=0.5), 14, 8, 100, 0.5 * HUB_W),
            ("ct", dict(tau=HUB_CT_TAU, semistochastic=False,
                        use_exponential_projector=True, r_initiator=1.0),
             4, 6, 50, 0.8 * HUB_W))
    for name, kw, nblk_eq, nblk, nstep, w0 in runs:
        cfg = WalkConfig(**base, **kw)
        t0 = time.time()
        out, c = _counted(lambda: run_walk(
            system, trial, cfg, nstep=nstep, nblk=nblk, nblk_eq=nblk_eq,
            w_abs_begin=w0, e_trial_initial=e_var, verbose=False,
            max_eq_extensions=1, seed=1))
        torch.cuda.synchronize()
        pop, dev_, gate = _gate_walk(f"7a {name}", out, HUB_W, e_tot, 2e-3)
        nwalk = float(np.mean(out.nwalk_trace[-out.n_measured:]))
        log(f"phase 7a hubbardk walk {name}: tau={cfg.tau:g} "
            f"measured_gens={out.n_measured} gen_per_s={out.steps_per_sec:.3f} "
            f"occupied_det_walker_steps_per_s={nwalk * out.steps_per_sec:.6g} "
            f"pop={pop:.1f} nwalk={nwalk:.1f} e_mixed={out.e_mixed:.9f} +- "
            f"{out.e_err:.9f} vs_e_var_plus_pt_mHa={1e3 * dev_:.4f} "
            f"gate_mHa={1e3 * gate:.4f} seg_scan_launches={c['seg_scan']} "
            f"spmv_launches={c['spmv']} seconds={time.time() - t0:.1f} [{smi}]")
        if c["seg_scan"] <= 0:
            raise AssertionError(f"7a {name}: the walk never launched K1")
    return e_tot


def _best_open_det(guide, norb, nup, ndn, dev):
    """The det without double occupancy on which |psi_g| is largest: the
    up and dn Slater parts are evaluated once per spin string."""
    import itertools
    import numpy as np
    import torch
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.algo.guiding import _batched_det
    strings = {k: np.array(list(itertools.combinations(range(norb), k)))
               for k in {nup, ndn}}
    su, sd = strings[nup], strings[ndn]
    du = _batched_det(guide.phi_up[torch.as_tensor(su, device=dev)]).abs()
    dd = _batched_det(guide.phi_dn[torch.as_tensor(sd, device=dev)]).abs()
    mu = torch.zeros((len(su), norb), device=dev)
    mu.scatter_(1, torch.as_tensor(su, device=dev), 1.0)
    md = torch.zeros((len(sd), norb), device=dev)
    md.scatter_(1, torch.as_tensor(sd, device=dev), 1.0)
    amp = du[:, None] * dd[None, :] * ((mu @ md.T) == 0)
    k = int(torch.argmax(amp))
    iu, idn = divmod(k, len(sd))
    return (dets.det_from_orbs(su[iu].tolist(), norb),
            dets.det_from_orbs(sd[idn].tolist(), norb), float(amp.max()))


def phase_hubbard_real(dev, e0, smi):
    """7b: fixed_node1 with Gutzwiller importance sampling on the 4x4
    real-space cluster in f64 state (K2 on the fixed-node matrix each
    generation), held to the variational bound against 7a's energy."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.guiding import make_gutzwiller_guiding
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import (WalkConfig, build_walk_tables,
                                          run_walk)
    from sqmc_tpu_torch.ops import spmv as S
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_real_system

    t0 = time.time()
    l_x, l_y, t_hop, U, nup, ndn = HUB
    system = make_hubbard_real_system(l_x, l_y, t_hop, U, nup, ndn, pbc=True,
                                      device=dev)
    norb = system.norb
    pot = 0.3 * np.random.default_rng(4).normal(size=norb)
    _, phi = np.linalg.eigh(system.table.h.cpu().numpy() + np.diag(pot))
    guide = make_gutzwiller_guiding(system, g=HUB2_G, phi_up=phi[:, :nup],
                                    phi_dn=phi[:, :ndn])
    system.hf_up, system.hf_dn, amp = _best_open_det(guide, norb, nup, ndn, dev)
    trial = build_trial_wavefunction(system, eps_var=HUB2_EPS, n_psi_t=2000,
                                     n_imp=4000)
    torch.cuda.synchronize()
    log(f"phase 7b hubbard2 setup: start_det_psi_g={amp:.3e} "
        f"n_imp={len(trial.imp_up)} n_ct={len(trial.ct_up)} "
        f"e_trial={trial.e_trial:.6f} seconds={time.time() - t0:.2f}")
    if not 1000 <= len(trial.imp_up) <= 10_000:
        raise AssertionError("7b: the D space is not a few thousand dets")

    kw = dict(mwalk=458_752, cap_spawn=262_144, norb=norb, nup=nup, ndn=ndn,
              n_words=1, w_abs_target=HUB2_W, tau=HUB2_TAU_MAX, min_wt=0.5,
              r_initiator=0.0, has_singles=True, run_type="fixed_node1",
              guiding="gutzwiller")
    rng = np.random.default_rng(14)
    for f32, rtol in ((True, 1e-5), (False, 1e-13)):
        tab = build_walk_tables(system, trial, WalkConfig(
            f32_state=f32, dense_proj_max=0, **kw), guide=guide)
        n = len(trial.imp_up)
        A = torch.zeros((n, n), dtype=torch.float64, device=dev)
        A[tab.imp_rows, tab.imp_cols] = tab.imp_vals.double()
        asym = float((A - A.T).abs().max())
        x = torch.as_tensor(rng.standard_normal(n), device=dev).to(
            tab.imp_ell_vals.dtype)
        args = (tab.imp_ell_cols, tab.imp_ell_vals, tab.imp_ell_ptr,
                tab.imp_ell_nnz)
        got = S.spmv(x, *args)
        torch.cuda.synchronize()
        ref = S.spmv_plain(x, *args)
        bound = S.spmv_plain(x.abs().double(), args[0], args[1].abs().double(),
                             *args[2:])
        err = (got.double() - ref.double()).abs()
        off = A - torch.diag(torch.diagonal(A))
        log(f"phase 7b spmv on the fixed-node matrix: rows={n} nnz="
            f"{int(tab.imp_ell_nnz.sum())} "
            f"{str(x.dtype).split('.')[-1]} m=1 match max_abs_err="
            f"{float(err.max()):.3e} max_asymmetry={asym:.3e} "
            f"empty_rows={int((tab.imp_ell_nnz == 0).sum())} "
            f"max_offdiag={float(off.max()):.3e}")
        if bool((err > rtol * bound).any()) or asym < 1e-6 \
                or float(off.max()) > 1e-12:
            raise AssertionError("K2 disagrees with its plain version on the "
                                 "fixed-node matrix (or the matrix is not "
                                 "the fixed-node one)")
        del A, off

    # 1 + tau (E_T - H_fn,ii) must stay above -1 on every D det
    top = float(tab.imp_diag.max()) - trial.e_trial
    cfg = WalkConfig(f32_state=False, **dict(kw, tau=min(HUB2_TAU_MAX,
                                                         1.0 / top)))
    log(f"phase 7b stability: largest_fixed_node_diagonal_above_e_trial="
        f"{top:.3e} tau={cfg.tau:.3e}")
    t0 = time.time()
    out, c = _counted(lambda: run_walk(
        system, trial, cfg, nstep=100, nblk=4, nblk_eq=4,
        w_abs_begin=HUB2_W, e_trial_initial=trial.e_trial,
        verbose=False, max_eq_extensions=1, seed=1, guide=guide))
    torch.cuda.synchronize()
    pop, dev_, _ = _gate_walk("7b fixed_node1", out, HUB2_W, e0, 0.0,
                              lower_bound_only=True)
    nwalk = float(np.mean(out.nwalk_trace[-out.n_measured:]))
    log(f"phase 7b hubbard2 fixed_node1 walk: tau={cfg.tau:g} g={HUB2_G} "
        f"measured_gens={out.n_measured} gen_per_s={out.steps_per_sec:.3f} "
        f"occupied_det_walker_steps_per_s={nwalk * out.steps_per_sec:.6g} "
        f"pop={pop:.1f} nwalk={nwalk:.1f} e_mixed={out.e_mixed:.6f} +- "
        f"{out.e_err:.6f} above_e0={dev_:.6f} seg_scan_launches="
        f"{c['seg_scan']} spmv_launches={c['spmv']} "
        f"seconds={time.time() - t0:.1f} [{smi}]")
    if c["seg_scan"] <= 0 or c["spmv"] <= 0:
        raise AssertionError("7b: the walk did not run both kernels")


def _dense_space(system, dev):
    """Every det of a small system's (nup, ndn) space, the dense H on it."""
    import itertools
    import numpy as np
    import torch
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
    norb, nup, ndn = system.norb, system.nup, system.ndn
    cu = [dets.det_from_orbs(c, norb) for c in itertools.combinations(range(norb), nup)]
    cd = [dets.det_from_orbs(c, norb) for c in itertools.combinations(range(norb), ndn)]
    up = torch.as_tensor(np.repeat(np.stack(cu), len(cd), axis=0), device=dev)
    dn = torch.as_tensor(np.tile(np.stack(cd), (len(cu), 1)), device=dev)
    sp = build_sparse_ham(system.table, up, dn, nup, ndn, norb)
    n = len(up)
    H = np.zeros((n, n))
    H[sp.rows.cpu().numpy(), sp.cols.cpu().numpy()] = sp.vals.cpu().numpy()
    return up, dn, H + H.T + np.diag(sp.diag.cpu().numpy())


def _fn_mixed_oracle(H, g, vec, eps):
    """Mixed energy <psi_T|H|phi> / <psi_T|phi> of the ground state phi of
    the exact fixed-node(eps) effective Hamiltonian: violating transformed
    elements Ht_ij = g_i H_ij / g_j > 0 scaled by 1 - eps, eps times their
    column sums on the diagonal."""
    import numpy as np
    ht = H * (g[:, None] / g[None, :])
    viol = ~np.eye(len(H), dtype=bool) & (ht > 0)
    hfn = np.where(viol, (1 - eps) * H, H)
    np.fill_diagonal(hfn, np.diag(H) + eps * np.where(viol, ht, 0.0).sum(axis=0))
    w, v = np.linalg.eig(hfn)
    phi = v[:, np.argmin(w.real)].real
    return float((vec @ H @ phi) / (vec @ phi)), int(viol.sum())


def phase_fixed_node_oracles(dev, workdir):
    """7c, first part: guided walks on enumerable lattices against the
    dense fixed-node oracle, within 6 max(sigma, 1e-4) + 1e-3; the chain
    also as a fixed_node1 deck through the CLI (Gutzwiller guiding set up
    from the wf_type and g cards), within max(6 sigma, 5e-3) of e0."""
    import re
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.guiding import eval_guiding, make_gutzwiller_guiding
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.ops import setalg
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_real_system

    cases = (("chain_1x8", (1, 8), 0.0,
              (("none", {}, None), ("fixed_node1", {}, 1.0))),
             ("lattice_2x3", (2, 3), 0.3,
              (("fixed_node1", {}, 1.0),
               ("partial_node", dict(partial_node_eps=0.6), 0.6),
               ("release_node", dict(release_step=150), None))))
    for name, (l_x, l_y), pot_size, runs in cases:
        s = make_hubbard_real_system(l_x, l_y, 1.0, 4.0, 2, 2, pbc=False,
                                     device=dev)
        pot = pot_size * np.random.default_rng(4).normal(size=s.norb)
        _, phi = np.linalg.eigh(s.table.h.cpu().numpy() + np.diag(pot))
        guide = make_gutzwiller_guiding(s, g=0.7, phi_up=phi[:, :2],
                                        phi_dn=phi[:, :2])
        up, dn, H = _dense_space(s, dev)
        g = eval_guiding(guide, "gutzwiller", up, dn, s.norb, 2, 2).cpu().numpy()
        e0 = float(np.linalg.eigvalsh(H)[0])
        trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=40, n_imp=1)
        order = setalg.lexsort_dets(up, dn)
        pos = setalg.search_dets(up[order], dn[order], trial.psit_up,
                                 trial.psit_dn)
        vec = np.zeros(len(up))
        vec[order[pos].cpu().numpy()] = trial.psit_coef.cpu().numpy()
        if name == "chain_1x8":
            text, sec, c = _run_cli("7c_hubbard2_fixed_node", HUB2_FN_DECK,
                                    workdir)
            for k in c:
                COUNTS7[k] += c[k]
            e_cli, err_cli = map(float, re.search(
                r"e_mixed=\s*([-+0-9.]+)\s*\+-\s*([0-9.eE-]+)", text).groups())
            log(f"phase 7c chain_1x8 fixed_node1 cli: e0={e0:.6f} "
                f"e_mixed={e_cli:.6f} +- {err_cli:.6f} seconds={sec:.2f}")
            if "trial_wf_type=gutz" not in text or c["seg_scan"] <= 0 \
                    or not abs(e_cli - e0) < max(6 * err_cli, 5e-3):
                raise AssertionError("7c: the hubbard2 fixed_node1 deck "
                                     "missed the chain's e0")
        for run_type, opts, eps in runs:
            target, nviol = (e0, _fn_mixed_oracle(H, g, vec, 1.0)[1]) \
                if eps is None else _fn_mixed_oracle(H, g, vec, eps)
            cfg = WalkConfig(mwalk=4096, cap_spawn=8192, cap_fresh=2048,
                             norb=s.norb, nup=2, ndn=2, n_words=1, tau=2e-2,
                             w_abs_target=2000.0, has_singles=True,
                             r_initiator=0.0, run_type=run_type,
                             guiding="gutzwiller", **opts)
            t0 = time.time()
            out, c = _counted(lambda: run_walk(
                s, trial, cfg, nstep=100, nblk=4, nblk_eq=3,
                w_abs_begin=1500.0, e_trial_initial=target, verbose=False,
                guide=guide, seed=2))
            gate = 6 * max(out.e_err, 1e-4) + 1e-3
            log(f"phase 7c {name} {run_type}: dets={len(up)} violators={nviol} "
                f"e0={e0:.6f} oracle={target:.6f} e_mixed={out.e_mixed:.6f} "
                f"+- {out.e_err:.6f} gate={gate:.6f} seg_scan_launches="
                f"{c['seg_scan']} seconds={time.time() - t0:.1f}")
            if not abs(out.e_mixed - target) < gate or out.capacity_grows:
                raise AssertionError(f"7c {name} {run_type} missed its oracle")


def phase_ct_and_proposal_oracles(dev, heg14, heg14_trial):
    """7c, second part: the CT projector in its three modes and the
    Cauchy-Schwarz proposal against FCI on small systems; the uniform
    proposal on HEG-14 at reduced depth against phase 3's oracle."""
    import numpy as np
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.systems.base import make_system_from_arrays
    from sqmc_tpu_torch.systems.chem.integrals import n_eri
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system

    rng = np.random.default_rng(3)
    h = rng.normal(size=(5, 5)) * 0.3
    h = 0.5 * (h + h.T) + np.diag(np.arange(5) * 1.0)
    chem5 = make_system_from_arrays(h, rng.normal(size=n_eri(5)) * 0.1, 0.0,
                                    2, 2, name="toy", device=dev)
    rng = np.random.default_rng(5)
    h4 = rng.normal(size=(4, 4)) * 0.3
    chem4 = make_system_from_arrays(
        0.5 * (h4 + h4.T) + np.diag(np.arange(4) * 1.0),
        rng.normal(size=n_eri(4)) * 0.1, 0.0, 2, 2, device=dev)
    exact = dict(eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                 verbose=False)
    small = (
        ("ct hubbardk 2x2", make_hubbard_k_system(2, 2, 1.0, 4.0, 2, 2, device=dev),
         1e-6, 36, dict(tau=0.05, semistochastic=False,
                        use_exponential_projector=True), 1e-4, 50),
        ("ct heg-4", make_heg_system(3, 1.0, 4, 2, 1.6, device=dev),
         1e-4, 30, dict(tau=0.02, semistochastic=False,
                        use_exponential_projector=True, ct_mode="heg"), 2e-4, 50),
        ("ct generic chem-5", chem5, 1e-6, 30,
         dict(tau=0.05, semistochastic=False, use_exponential_projector=True,
              ct_mode="generic"), 2e-4, 50),
        ("cauchy_schwarz chem-4", chem4, 1e-4, 10,
         dict(tau=2e-3, proposal="cauchy_schwarz"), 1e-4, 100))
    for name, s, eps, n_psi_t, kw, floor, nstep in small:
        e0 = float(run_hci(s, **exact).energies[0])
        trial = build_trial_wavefunction(s, eps_var=eps, n_psi_t=n_psi_t, n_imp=1)
        cfg = WalkConfig(mwalk=2048, cap_spawn=8192, cap_fresh=2048,
                         norb=s.norb, nup=2, ndn=2, n_words=1,
                         w_abs_target=2000.0, has_singles=s.has_singles,
                         r_initiator=0.0, **kw)
        t0 = time.time()
        out, c = _counted(lambda: run_walk(
            s, trial, cfg, nstep=nstep, nblk=5, nblk_eq=2, w_abs_begin=1500.0,
            e_trial_initial=e0, verbose=False, max_eq_extensions=0, seed=1))
        gate = 6 * max(out.e_err, 5e-6) + floor
        log(f"phase 7c {name}: tau={cfg.tau:g} e0={e0:.9f} "
            f"e_mixed={out.e_mixed:.9f} +- {out.e_err:.9f} gate={gate:.3e} "
            f"seg_scan_launches={c['seg_scan']} seconds={time.time() - t0:.1f}")
        if not abs(out.e_mixed - e0) < gate or out.capacity_grows:
            raise AssertionError(f"7c {name} missed FCI")

    cfg = WalkConfig(mwalk=458_752, cap_spawn=262_144, norb=heg14.norb,
                     nup=heg14.nup, ndn=heg14.ndn, n_words=heg14.n_words,
                     tau=2e-3, w_abs_target=W_TARGET, spawn_granularity=2.0,
                     min_wt=0.5, r_initiator=0.5, f32_state=True,
                     has_singles=False, proposal="uniform")
    t0 = time.time()
    out, c = _counted(lambda: run_walk(
        heg14, heg14_trial, cfg, nstep=100, nblk=4, nblk_eq=4,
        w_abs_begin=W_TARGET, e_trial_initial=heg14_trial.e_trial,
        verbose=False, max_eq_extensions=1, seed=3))
    pop, dev_, gate = _gate_walk("7c uniform heg-14", out, W_TARGET, ORACLE,
                                 2e-3)
    log(f"phase 7c uniform proposal heg-14: measured_gens={out.n_measured} "
        f"gen_per_s={out.steps_per_sec:.3f} pop={pop:.1f} "
        f"e_mixed={out.e_mixed:.9f} +- {out.e_err:.9f} "
        f"bias_vs_oracle_mHa={1e3 * dev_:.4f} gate_mHa={1e3 * gate:.4f} "
        f"seg_scan_launches={c['seg_scan']} seconds={time.time() - t0:.1f}")


def phase_merge_and_checkpoint_oracles(dev, workdir):
    """7c, third part, on HEG-4 with D = the whole space (every spawn is
    discarded, so a generation does not depend on the random stream): the
    sequential initiator rule and the two-level merge give the full-sort
    group-max trace to 1e-10; then, on the stochastic walk, a state saved
    after two blocks and loaded again continues exactly as the
    uninterrupted run."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    from sqmc_tpu_torch.utils.checkpoint import load_walker_state

    s = make_heg_system(3, 1.0, 4, 2, 1.6, device=dev)
    res = run_hci(s, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                  verbose=False)
    full = build_trial_wavefunction(s, eps_var=1e-9, n_psi_t=len(res.up),
                                    n_imp=len(res.up))
    kw = dict(mwalk=2048, cap_spawn=4096, cap_fresh=1024, norb=s.norb, nup=2,
              ndn=2, n_words=1, tau=5e-3, w_abs_target=500.0,
              has_singles=False)
    keys = ("e_num_gen", "e_den_gen", "w_abs_gen", "nwalk")
    traces = {}
    for name, opts in (("full_sort_group_max", {}),
                       ("sequential", dict(initiator_rule="sequential")),
                       ("two_level", dict(full_sort_merge=False, cap_new=512))):
        cfg = TW.WalkConfig(**kw, **opts)
        tab = TW.build_walk_tables(s, full, cfg)
        st = TW.init_walk_state(cfg, full, 500.0, float(res.energies[0]), tab)
        (st, stats), c = _counted(lambda: TW.walk_block(
            st, tab, cfg, 10, torch.Generator(device=dev).manual_seed(0)))
        traces[name] = torch.stack([stats[k] for k in keys]).cpu().numpy()
        dev_ = np.abs(traces[name] / traces["full_sort_group_max"] - 1).max()
        log(f"phase 7c deterministic limit {name}: gens=10 "
            f"max_rel_dev_from_full_sort={dev_:.3e} "
            f"seg_scan_launches={c['seg_scan']} spmv_launches={c['spmv']}")
        if not dev_ < 1e-10:
            raise AssertionError(f"7c: the {name} trace left the full-sort one")

    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=10)
    cfg = TW.WalkConfig(**dict(kw, r_initiator=0.0))
    ck = os.path.join(workdir, "7c_walker_state")
    run = dict(nstep=20, w_abs_begin=400.0, e_trial_initial=float(res.energies[0]),
               verbose=False, max_eq_extensions=0)
    (whole, part, rest), c = _counted(lambda: (
        TW.run_walk(s, trial, cfg, nblk=2, nblk_eq=1, seed=11, **run),
        TW.run_walk(s, trial, cfg, nblk=1, nblk_eq=1, seed=11,
                    checkpoint_file=ck, **run),
        TW.run_walk(s, trial, cfg, nblk=1, nblk_eq=0, seed=99,
                    resume_state=load_walker_state(ck, cfg, device=dev), **run)))
    same = (rest.e_blocks[0] == whole.e_blocks[1]
            and torch.equal(rest.state.wt, whole.state.wt)
            and torch.equal(rest.state.up, whole.state.up))
    log(f"phase 7c checkpoint resume: block3_uninterrupted="
        f"{whole.e_blocks[1]:.12f} block3_resumed={rest.e_blocks[0]:.12f} "
        f"same_state={same} seg_scan_launches={c['seg_scan']}")
    if not same:
        raise AssertionError("7c: the resumed walk left the uninterrupted one")


def phase_hubbard(dev, smi, heg14=None, heg14_trial=None):
    """Phase 7: 7a, 7b, 7c; every path's kernel counts set to 0 just before
    it and read just after, summed into COUNTS7."""
    workdir = os.path.join(HERE, "build", "smoke_phase7")
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        os.remove(os.path.join(workdir, name))
    t0 = time.time()
    e0 = phase_hubbard_k(dev, workdir, smi)
    t1 = time.time()
    phase_hubbard_real(dev, e0, smi)
    t2 = time.time()
    phase_fixed_node_oracles(dev, workdir)
    if heg14 is None:
        from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
        from sqmc_tpu_torch.systems.heg.system import make_heg_system
        heg14 = make_heg_system(*HEG, device=dev)
        heg14_trial = build_trial_wavefunction(heg14, eps_var=EPS_VAR,
                                               n_psi_t=2000, n_imp=20000)
    phase_ct_and_proposal_oracles(dev, heg14, heg14_trial)
    phase_merge_and_checkpoint_oracles(dev, workdir)
    log(f"phase 7 launches: {COUNTS7}")
    log(f"phase 7 stages: 7a={t1 - t0:.2f} 7b={t2 - t1:.2f} "
        f"7c={time.time() - t2:.2f} seconds")


def phase_build():
    """Both kernels, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from sqmc_tpu_torch.ops import segscan, spmv
    t0 = time.time()
    with ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(mod.build) for mod in (segscan, spmv)]
        libs = [f.result() for f in futs]
    log(f"phase 1 build: {' '.join(os.path.relpath(p, HERE) for p in libs)} "
        f"seconds={time.time() - t0:.2f}")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script runs only "
                         "on the card)")
    if not os.path.isdir(os.path.join(HERE, "sqmc_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(smi)
    log(f"phase 0 device: {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} python={sys.version.split()[0]}")

    phase_build()
    if "--hubbard" in sys.argv[1:]:
        phase_hubbard(dev, smi)
        raise SystemExit("chip_smoke: --hubbard ran phases 0, 1 and 7 only; "
                         "no result")
    seg = phase_kernel_vs_plain(dev)
    sp = phase_spmv_vs_plain(dev)
    kernel_us = phase_kernel_rows()
    seg["kernel_us"] = kernel_us["seg_scan walk_merge_6field_f32"]
    sp["kernel_us"] = kernel_us["spmv c2_synthetic blockell float32 m=1"]
    PROFILED.clear()
    if "--kernels" in sys.argv[1:]:
        raise SystemExit("chip_smoke: --kernels ran phases 0-2c only; no "
                         "result")
    launches, system, res, trial = phase_main_path(dev)
    sp_launches = phase_shci(dev, system, res)
    phase_f64_walk(dev, system, trial)
    phase_cli(dev)
    phase_hubbard(dev, smi, system, trial)
    launches += COUNTS7["seg_scan"]
    sp_launches += COUNTS7["spmv"]

    def entry(name, source, replaces, n_launches, m):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_us"] / 1e3,
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                "device_us": m["device_us"], "kernel_us": m["kernel_us"],
                "bound_us": m["bound_us"]}

    log(nvidia_smi_line())
    log(json.dumps({"kernels": [
        entry("seg_scan", "sqmc_tpu_torch/csrc/segscan.cu",
              "sqmc_tpu/ops/pscan.py:163", launches, seg),
        entry("spmv", "sqmc_tpu_torch/csrc/spmv.cu",
              "sqmc_tpu/ops/spmv_pallas.py:83", sp_launches, sp)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception as exc:          # report, then fail the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", flush=True)
        sys.exit(1)
