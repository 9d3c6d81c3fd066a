#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sqmc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py             # every phase (one card)
    python3 chip_smoke.py --kernels   # phases 0-2 (2-2e, 2c), then exit 1
    python3 chip_smoke.py --hubbard   # phases 0, 1 and 7 only, then exit 1
    python3 chip_smoke.py --dense     # phases 0, 1 and 8 only, then exit 1
    python3 chip_smoke.py --legacy    # phases 0, 1 and 9 only, then exit 1
    python3 chip_smoke.py --mesh      # phases 0, 1 and 10 only, then exit 1
    python3 chip_smoke.py --bench     # phases 0, 1 and 11 only, then exit 1
    python3 chip_smoke.py --graph     # phases 0, 1 and 12 only, then exit 1

Every walk below runs as the package runs it on the card: each block
replays one captured generation (a CUDA graph, sqmc_tpu_torch/utils/
cudagraph.py; the eager loop only on a mesh), and so do the dense
engine's blocks, VMC's sweeps and CPMC's steps; the launch counts it
reports are the eager loop's (the graph's recorded launches times its
replays).

Phases, each reported on its own line; any failure exits nonzero:

  0. device check: a CUDA card must be present (the script never falls
     back to the CPU); prints the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them, and the torch / CUDA versions;
  1. build the five kernels from sqmc_tpu_torch/csrc (segscan.cu,
     spmv.cu, hbselect.cu, slotpar.cu, seqinit.cu), one nvcc each,
     started together;
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
  2d. the walk's spawn kernels vs their plain versions: the heat-bath
     selection (K3) at the walk's shape (262,144 slots of HEG-14 dets,
     2n = 38, HEG-14's R2; once more with the last 30% of the slots the
     walk's empty-slot sentinel, as the walk hands them), at 6b's chem
     shape with singles (26 orbitals, 4 + 4) and with integer R2 (same
     bits), the heat-bath proposal (K3b, the kernel every heat-bath walk
     launches) against its plain version at 262,144 slots of the four
     shapes of tests/torch_spawn_emulation.py (the C2-shaped walk's f32
     sng_pack, HEG-14 without singles, C2 with the float64 rows, a
     70-orbital two-word system) with the card tests' criteria, the
     slot -> parent expand
     (K4) at the walk's shape (458,752 walkers, 262,144 slots) below and
     above the capacity; printed as 2 and 2b print, the library calls
     being torch.cumsum of one [262,144, 2n] row set and its
     triangular-matmul form (K3; K3b has none) and torch.searchsorted
     (K4), with what
     ptxas reported of each kernel (registers, shared memory, spills)
     and each launch's blocks, threads and resident blocks per SM;
  2e. the sequential initiator combine (K5) vs its plain version, bit
     for bit: 720,896 merge rows in groups of 1 to ~30 rows, float32 and
     float64 (plain on the card), with one group of 30,000 rows (plain on
     the CPU), and the walk's shape: 138,866 rows of occupied dets in
     short groups, then one group of 582,030 zero-weight empty slots
     (plain on the card); prints what 2 prints, the longest group and
     the longest group of active rows (a start or a nonzero weight: the
     serial chain runs over those alone) and the active rows (no library
     call computes the rule);
  2c. the kernels' own time per call (kernel_us) at the walk and C2
     shapes, from one torch.profiler session (after 2d and 2e, whose
     cases it profiles too);
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
     the bench's population (2e5, min_wt 0.5, f64 state, auto MWALK, 3 + 3
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
     (1e-10), with K5 then held on that walk's own merge rows bit for bit
     against its plain version on the card and timed; save, load and resume of a walker state giving the same
     next block as the uninterrupted run;
  8. the small-model family (decks and logs in build/smoke_phase8/):
     8a the dense `hubbard` deck through the CLI at full width, the 3x3
     periodic cluster at U/t = 4 with 4 + 4 electrons (15,876 dets, a
     2.02 GB float64 matrix on the card), run_type none and fixed_node1
     with importance sampling, Psi_T = the 1,000 largest dets of the
     ground state through the cards; oracle: Davidson on the SpMV kernel
     over the whole determinant space of the real-space system; gates:
     |e_mixed - e0| < max(5 sigma, 2 mHa) for none, e_mixed >= e0 - 5
     sigma for fixed_node1, population within 10% of its target; prints
     gen/s, the device ms per generation and the matvec's bytes bound;
     8b the `fictitious` system at ndet 16,384 (2.15 GB): bosonic 1 with
     the plain projector and bosonic 0 with partial_node (eps 0.5)
     through the CLI, each deck's own torch.linalg.eigh on the card as
     the exact oracle and the deterministic limit of the partial-node
     projector as its oracle; release_node and sr on the same matrix in
     this process; prints the seconds the matrix and the eigh took;
     8c the 1x8 chain through both walk engines (dense-vector and
     determinant), fixed_node1, one guiding function, tau and population:
     within 5 combined sigma of each other and within 4 seed scatters of
     the exact energy;
     8d Gutzwiller VMC on the 4x4 cluster (5 + 5, U/t = 4): g = 1 against
     the Slater determinant's energy from Wick's theorem (5 sigma), the
     `hubbard2` deck with run_type vmc at g = 0.7 between e0 and that
     energy; CPMC on the same cluster (1,024 walkers, tau 0.05) within 1%
     of e0 = -19.58094, with its orthonormalization timed as Cholesky-QR
     and as torch.linalg.qr; the density-matrix block basis on the 4x2
     cluster at 4 + 4 (4,900 dets): spectrum of the exact rotation equal
     to the real-space one to 1e-9, a truncated basis variational;
     8e restart artifacts on HEG-14: the HCI deck with dump_wf_var run
     twice in a fresh directory (the second run reads the cache, skips
     the variational stage and prints the same energies), the
     reference-format files written and read back, a 200-generation walk
     writing its walkalize trace;
  9. the legacy CI and the SHCI observables (decks and logs in
     build/smoke_phase9/; the seven CLI decks of 9a and 9c run beside
     each other and beside 9a's in-process work, none beside 9b):
     9a on 6b's synthetic FCIDUMP, 6b's deck through the CLI with
     &natorb (use_pt .false., and .true. with eps_pt_big 3e-5) and
     &greens_function (n_w = 50), each FCIDUMP.natorb then run as the
     same HCI + PT deck (within max(5 sigma, 2 mHa) of the deck's E_var +
     PT), and with &active_space (3, 3, 20) (E_var not below the
     unrestricted one); in this process on the same system the active
     space's frozen orbitals (0 occupied, 21-25 empty in every det),
     run_hci(diagonalizer="arpack") on K2 in float64 (E_var within 1e-8 of
     the Davidson's), the seconds and peak memory of the 1-RDM, the PT
     vector, the RDM with PT, the rotation and the write (trace 8 and
     occupations in [0, 2] within 1e-10), the Green's function sum rules
     at w = 1e8 (1e-5); the CAS(4e,12o) fold of the file (n_core 2,
     n_act 12, 4,356 dets), whose HCI at eps_var -> 0 selects the whole HF
     symmetry sector and equals torch.linalg.eigh of it on the card
     (1e-8); MP2 of the 26-orbital system;
     9b hubbard_lanczos_full on the 4x4 periodic real-space cluster (5 +
     5, U/t = 4, 19,079,424 dets) matrix-free on the card from a seeded
     random start: within 1e-4 of -19.58094 (the oracle of 7a and 8d) and
     not above 7a's HCI E_var; prints the iterations, the seconds per H
     application, the residual and the peak memory;
     9c on 7a's cluster (momentum space) the matrix-free Lanczos over the
     29,850 HCI dets against the float64 COO Davidson (1e-8), then the
     selected_ci (4 iterations) and trunc_lanc (8) decks through the CLI
     with n_truncate_det 10,000: both not below 9b's energy, selected CI
     below its first iteration, truncated Lanczos below the HF energy;
 10. the mesh (sqmc_tpu_torch/parallel/dist.py; decks in
     build/smoke_phase10/): 10a phase 3's HEG-14 cell through
     make_sharded_walk on a world of one NCCL rank at full width, gated
     as phase 3; 10c run_hci(mesh=) and PT over that rank against the
     serial port (the same 9,475 dets, E_var within 1e-10 of serial and
     1e-6 of the golden, deterministic PT within 1e-12 relative with the
     same connection count, the semistochastic difference within 1e-12
     with the same sample count); then two gloo ranks on this card
     (NCCL refuses two ranks on one device; collectives staged through
     the host, transport=gloo-host), started by parallel.dist.spawn
     after phase 1 built both kernels: 10b the sharded walk at the same
     global population, per-rank capacities phase 3's halved, warm-
     started from 10a's walkers (sharded by owner), f32 (dense row
     slices) and f64 (K2 block-ELL rows, local rows and global columns),
     each gated as phase 3, printing the per-rank nwalk, the bytes routed
     a generation and the ms of one exchange; 10c at two ranks; 10e
     sharded_unique_dets on 2M candidates with duplicates equal to
     setalg.unique_dets; 10d the dry run (parallel/dryrun.py) within 4
     combined sigma of its serial golden;
 11. the port's top-level entry points (FCIDUMP and trial cache in
     build/bench/ and build/entry/): 11a ``sqmc_tpu_torch.bench.run`` at
     bench.py's knobs on the synthetic C2-shaped file (plain dets, HCI
     trial at eps_var 1e-3, heat-bath with singles, population 2e5, 12 + 30
     blocks of 100 generations), its JSON record logged, gated on no
     capacity growth, the population within 10% of 2e5 and e_mixed within
     max(5 sigma, 2 mHa) of bench.ORACLE_E0 (HCI at eps_var 1e-4 + PT at
     eps_pt 1e-7 on the same file); 11b ``sqmc_tpu_torch.entry.entry()``'s
     fn called 10 times (finite outputs), then once under torch.cuda's
     sync debug mode, printing where it waits for the card; 11c the
     Cauchy-Schwarz and uniform proposals with singles on the same file
     and trial at the bench's knobs (but twice its capacities and
     pop_ctrl_exponent 100: PROPOSAL_KNOBS says why), cut to 4 + 4 blocks
     of 100 generations (the card cell of their rows): no capacity
     growth, no
     measured block more than 20% off the population target, e_mixed
     within max(5 sigma, 2 mHa) of the oracle, the largest |spawn weight|
     printed beside 11a's heat-bath walk's;
 12. every captured path against its eager loop, one block each from
     one state and seed (the capture made first, outside the timed
     block): the state arrays, the trace and the generators' states equal
     bit for bit and the launch counts equal; each cell prints both
     paths' rates, device ms a step (CUDA events around the block) and,
     from a profiled window of 10 steps, kernel ms and host launches a
     step: the bench's walk (11a's file, trial and knobs) and phase 3's
     HEG-14 f32 cell, 100 generations through ``walk._walk_block_eager``
     and ``walk.walk_block`` (also the capture's seconds and pool); 12b
     the dense engine, 100 generations through
     ``densewalk._dense_walk_block_eager`` and ``dense_walk_block``: 8b's
     fictitious system (ndet 16,384) as release_node released at
     generation 50 (two graphs), and 8c's 1x8 chain as fixed_node1; 12c
     VMC on the 4x4 cluster (5 + 5, 256 walkers, g = 0.7), 50 sweeps;
     12d CPMC on it (1,024 walkers), 20 steps and the mixed energy, with
     the factorization kernels one step runs (which library); 12e phase
     3's HEG-14 f32 cell under the sequential initiator rule (K5 in the
     merge), then three more generations: their longest merge group and
     longest active group, K5 on the last one's rows bit for bit against
     its plain version on the card, its time against its bound, and the
     graphed gen/s beside the group-max cell's.

Each path's kernel counts are set to 0 just before it and read just after.
The last two lines are a JSON object describing the kernels (the launches
of seg_scan, hb_select, hb_spawn and slot_parents from phases 3, 7, 8,
10, 11 and 12, spmv's from phases 4, 7, 8, 9, 10 and 11 (every rank's
counts in phase 10), seq_init's from phases 7c and 12e,
each path counted from 0; errors and times measured here: seg_scan at the
walk's merge shape, spmv at the C2 block-ELL float32 m = 1 shape,
hb_select and slot_parents at the walk's spawn shape, hb_spawn at 2d's
C2-shaped f32 case, seq_init at the
walk's merge length, 2e's float32 case) and ``{"ok": true, "device":
{...}}``.
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
NSTEP, NBLK_EQ, NBLK = 100, 12, 5     # 1,200 equilibration + 500 measured
MERGE_N = 458_752 + 262_144           # walk merge rows: mwalk + cap_spawn
GUIDED_NSTEP = 50                     # 7c's guided walks: 2 + 2 blocks of it


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


KERNELS = ("seg_scan", "spmv", "hb_select", "hb_spawn", "slot_parents",
           "seq_init")
# an f64 heat-bath walk's kernels
F64_WALK = ("seg_scan", "spmv", "hb_spawn", "slot_parents")


def _kernel_modules():
    from sqmc_tpu_torch.ops import (hbselect, hbspawn, segscan, seqinit,
                                    slotpar, spmv)
    return dict(zip(KERNELS, (segscan, spmv, hbselect, hbspawn, slotpar,
                              seqinit)))


def _reset_counts():
    """Every kernel's launch count set to 0."""
    for mod in _kernel_modules().values():
        mod.reset_launches()


def _read_counts():
    return {k: mod.launches for k, mod in _kernel_modules().items()}


def _need(tag, counts, *kernels):
    """Fail unless each named kernel was launched in `counts`."""
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: never launched {missing} ({counts})")


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
        own = [us for (name, _), us in found.items() if _own_kernel(name)]
        other = sorted({name[:24] for name, _ in found} - {
            name[:24] for name, _ in found if _own_kernel(name)})
        out[label] = sum(own) / calls
        log(f"phase 2c profile {label}: kernel_us={out[label]:.1f} "
            f"kernel_rows={len(own)} calls={calls} other_device_us="
            f"{(sum(found.values()) - sum(own)) / calls:.1f} other_rows="
            f"{len(found) - len(own)} {other[:3]}")
    return out


def _own_kernel(name):
    return any(k in name for k in ("k_seg_scan", "k_spmv", "k_hb_select",
                                   "k_hb_spawn", "k_slot_parents",
                                   "k_seq_init"))


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
# Phase 2d: the spawn kernels K3 (heat-bath selection) and K4 (slot ->
# parent) vs their plain versions
# ---------------------------------------------------------------------------

SPAWN_M, SPAWN_CAP = 458_752, 262_144  # the walk's mwalk and cap_spawn
# (norb, nup, ndn, R2 kind, singles): the walk's selection (HEG-14's walk
# tables), the same with the last 30% of the slots the walk's empty-slot
# sentinel (every bit set), as the walk hands them past a spawn total of
# 0.7 CAP, 6b's chem shape with singles (26 orbitals, 4 + 4 electrons) and
# integer R2 at the walk's width (every running sum exact: same bits)
HB_CASES = {"walk_heg14": (19, 7, 7, "heg14", False),
            "walk_heg14_sentinel30": (19, 7, 7, "heg14_sentinel", False),
            "chem26_singles": (26, 4, 4, "float", True),
            "integer_norb19_singles": (19, 7, 7, "int", True)}


def _random_dets(rng, cap, norb, nel):
    """[cap, W] int64 words, nel random orbitals occupied per row; the
    first 7 rows empty (slots past the spawn total)."""
    import numpy as np
    W = (norb + 63) // 64
    occ = np.argsort(rng.random((cap, norb)), axis=1)[:, :nel]
    words = np.zeros((cap, W), np.uint64)
    for w in range(W):
        sh = np.clip(occ - 64 * w, 0, 63).astype(np.uint64)
        hit = (occ >= 64 * w) & (occ < 64 * (w + 1))
        words[:, w] = np.bitwise_or.reduce(
            np.where(hit, np.left_shift(np.uint64(1), sh), np.uint64(0)),
            axis=1)
    words[:7] = 0
    return words.view(np.int64)


def _heg14_r2(dev):
    """R2 of HEG-14's walk tables (it does not depend on the trial)."""
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, build_walk_tables
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    s = make_heg_system(*HEG, device=dev)
    trial = build_trial_wavefunction(s, eps_var=5e-2, n_psi_t=5, n_imp=5)
    cfg = WalkConfig(mwalk=1024, cap_spawn=1024, norb=s.norb, nup=s.nup,
                     ndn=s.ndn, n_words=1, tau=2e-3, w_abs_target=1e3,
                     has_singles=False)
    return build_walk_tables(s, trial, cfg).R2


def _hb_compare(name, got, ref, exact):
    """Raise unless the kernel meets the criteria against the plain
    version; returns the largest |difference| of a float output on the
    slots whose draws agree.  Integer R2: the same bits everywhere.  Float
    R2 (the running sums associate differently): the draws agree on >=
    99.99% of slots, and there the totals agree to 1e-5 relative, the
    singles cell to 1e-6 of its row's total and p_pair_q to 4e-6 + 3e-5 p
    (the bound that follows from each of its four cells agreeing to 1e-6 of
    its row's total)."""
    import torch
    fields = [k for k, v in got._asdict().items() if v is not None]
    if exact:
        for k in fields:
            g, r = getattr(got, k), getattr(ref, k)
            if g.dtype == torch.float32:
                g, r = g.view(torch.int32), r.view(torch.int32)
            if not torch.equal(g, r):
                raise AssertionError(f"2d {name}: {k} differs")
        return 0.0
    same = (got.o1 == ref.o1) & (got.o2 == ref.o2)
    if got.o_s is not None:
        same &= got.o_s == ref.o_s
    agree = float(same.double().mean())
    err = 0.0
    for k in fields:
        if getattr(got, k).dtype != torch.float32:
            continue
        g, r = getattr(got, k)[same].double(), getattr(ref, k)[same].double()
        d = (g - r).abs()
        err = max(err, float(d.max()))
        if k == "p_pair_q":
            bad = d > 4e-6 + 3e-5 * r.abs()
        elif k == "c_s":
            bad = d > 1e-6 * ref.utot[same].double()
        else:
            bad = d > 1e-5 * r.abs()
        if bool(bad.any()):
            raise AssertionError(f"2d {name}: {k} off by {float(d.max())}")
    if agree < 0.9999:
        raise AssertionError(f"2d {name}: draws agree on {agree:.6f} only")
    return err


def _spawn_case_line(name, fn, plain, nbytes, ops, err, lib):
    """Times of one case: wrapper_ms, device_us, bound_us, plain_ms and
    the library calls; logs them and returns the summary dict."""
    ms = _median_ms(fn)
    dev_us = _device_us(fn)
    plain_ms = _median_ms(plain, reps=5, warm=1)
    bound_us, bound_by = _bound_us(nbytes, ops)
    libs = {k: (_median_ms(f), _device_us(f)) for k, f in lib.items()}
    log(f"phase 2d {name}: match max_abs_err={err:.3e} wrapper_ms={ms:.4f} "
        f"device_us={dev_us:.1f} bound_us={bound_us:.2f} bound_by={bound_by} "
        f"bound_MB={nbytes / 1e6:.2f} share={bound_us / dev_us:.3f} "
        f"plain_ms={plain_ms:.4f} " + " ".join(
            f"library_{k}_ms={a:.4f} library_{k}_device_us={b:.1f}"
            for k, (a, b) in libs.items()))
    first = next(iter(libs.values()), (None, None))[0]
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, device_us=dev_us,
                bound_us=bound_us, bound_by=bound_by, library_ms=first)


def _spawn_bytes(args, single):
    """The least bytes of K3b on these inputs: each slot reads its words
    and five uniforms and writes the child's words, its factor and flag
    (32 W + 49 B); a double reads six cells of the heat-bath tables
    (32 B); a single its alias cells and row total (20 B) and, of its
    row, h_pr, U[p, r] and the terms at the occupied orbitals (4 B each
    from sng_pack, 8 from the float64 rows); R2 and u_rowsum once."""
    import torch
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.ops import hbselect
    tables, up, dn, norb, singles, _, _, streams = args
    cap, W = up.shape
    nbytes = cap * (32 * W + 49) + 32 * int((~single).sum())
    nbytes += tables.R2.numel() * 4 + (norb * 8 if singles else 0)
    if singles:
        n_up = dets.to_bits(up, norb).sum(1)
        n_dn = dets.to_bits(dn, norb).sum(1)
        o_s = hbselect.hb_select(up, dn, norb, tables.R2, tables.u_rowsum,
                                 streams[1], streams[2]).o_s
        same = torch.where(o_s < norb, n_up, n_dn)
        e = 4 if tables.sng_pack.numel() else 8
        nbytes += int((((n_up + n_dn + same + 2) * e + 20)[single]).sum())
    return nbytes


def _hb_spawn_cases(dev):
    """2d's K3b cases: hbspawn.propose against propose_plain at 262,144
    slots of each shape of tests/torch_spawn_emulation.py (a third random
    dets, the rest the walk's own), by that module's compare_with_plain
    (the card tests' criteria); the same bits on a second call; one launch
    a call and no K3.  Returns {"spawn_<shape>": summary}."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_spawn_emulation as se
    from sqmc_tpu_torch.ops import hbselect, hbspawn
    workdir = os.path.join(HERE, "build", "smoke_phase2d")
    os.makedirs(workdir, exist_ok=True)
    out = {}
    for name in se.SPAWN_CASES:
        args, _ = se.spawn_inputs(name, dev, workdir, SPAWN_CAP, seed=21)
        tables, up, _, norb, singles, _, wdt, _ = args
        before, sel0 = hbspawn.launches, hbselect.launches
        got = hbspawn.propose(*args)
        torch.cuda.synchronize()
        if hbspawn.launches != before + 1 or hbselect.launches != sel0:
            raise AssertionError(f"2d hb_spawn {name}: launches "
                                 f"{hbspawn.launches - before} K3b, "
                                 f"{hbselect.launches - sel0} K3")
        again = hbspawn.propose(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"2d hb_spawn {name}: a second call gave "
                                 "other bits")
        ref = hbspawn.propose_plain(*args)
        match = se.compare_with_plain(args, got, ref)
        single = se.singles_taken(args)
        err = float((got[2] - ref[2]).abs().max())
        src = hbspawn.singles_source(tables, singles, wdt)
        shape = hbspawn.launch_shape(SPAWN_CAP, up.shape[1], norb,
                                     wdt == torch.float64, src, dev)
        log(f"phase 2d hb_spawn {name} launch: " + " ".join(
            f"{k}={v}" for k, v in shape.items()))
        log(f"phase 2d hb_spawn {name}: {match}")
        fn = (lambda a=args: hbspawn.propose(*a))
        out[f"spawn_{name}"] = _spawn_case_line(
            f"hb_spawn {name} cap={SPAWN_CAP} norb={norb} "
            f"words={up.shape[1]}", fn,
            lambda a=args: hbspawn.propose_plain(*a),
            _spawn_bytes(args, single), 0.0, err, {})
        PROFILED.append((f"hb_spawn {name}", fn))
        del got, again, ref
    return out


def phase_spawn_vs_plain(dev):
    """Phase 2d: K3 at the walk's spawn shape (CAP 262,144 slots of HEG-14
    dets, 2n = 38, HEG-14's R2), at 6b's chem shape with singles and with
    integer R2; K4 at the walk's shape (M 458,752 walkers, CAP 262,144
    slots) with a spawn total below CAP and one above it.  Each case
    prints what phase 2 prints; the library calls are, for K3, the
    torch.cumsum of one [CAP, 2n] float32 row set (three of them ran per
    generation before K3) and the JAX package's form of it, x @ triu(ones)
    in full float32 (TF32 off); for K4, torch.searchsorted(cum, slots,
    right=True).  Before them it prints what ptxas reported of each
    kernel (registers, shared memory, spills) and each launch's shape
    (blocks, threads, shared bytes, resident blocks per SM).  Returns the
    summaries of the walk-shape cases."""
    import numpy as np
    import torch
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.ops import hbselect, slotpar

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    from sqmc_tpu_torch.ops import cudabuild
    for mod in (hbselect, slotpar):       # registers, shared memory, spills
        for line in cudabuild.ptxas_summary(mod._SOURCE):
            log(f"phase 2d ptxas {mod._SOURCE}: {line}")
    rng = np.random.default_rng(9)
    out = {}
    for name, (norb, nup, ndn, kind, singles) in HB_CASES.items():
        n2, cap = 2 * norb, SPAWN_CAP
        if kind.startswith("heg14"):
            R2 = _heg14_r2(dev)
        else:
            R2 = (rng.integers(0, 16, (n2, n2)) if kind == "int"
                  else rng.exponential(1.0, (n2, n2))).astype(np.float32)
            np.fill_diagonal(R2, 0.0)
            R2 = torch.as_tensor(R2, device=dev)
        u_rowsum = None
        if singles:
            u_rowsum = torch.as_tensor(
                rng.integers(1, 9, norb).astype(np.float64) if kind == "int"
                else rng.exponential(1.0, norb), device=dev)
        up = torch.as_tensor(_random_dets(rng, cap, norb, nup), device=dev)
        dn = torch.as_tensor(_random_dets(rng, cap, norb, ndn), device=dev)
        if kind == "heg14_sentinel":
            up[int(0.7 * cap):] = -1
            dn[int(0.7 * cap):] = -1
        u1 = torch.as_tensor(rng.random(cap), device=dev)
        u2 = torch.as_tensor(rng.random(cap), device=dev)
        args = (up, dn, norb, R2, u_rowsum, u1, u2)
        got = hbselect.hb_select(*args)
        torch.cuda.synchronize()
        ref = hbselect.hb_select_plain(*args)
        err = _hb_compare(name, got, ref, exact=kind == "int")
        again = hbselect.hb_select(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None):
            raise AssertionError(f"2d {name}: a second call gave other bits")
        # bytes: det words, two uniforms, R2 and u_rowsum read once; two
        # int64 and four float32 written (singles: one int64, two float32)
        W = up.shape[1]
        nbytes = (cap * (2 * W * 8 + 16) + R2.numel() * 4
                  + (norb * 8 if singles else 0)
                  + cap * (32 + (16 if singles else 0)))
        # float ops this input needs: mu at the occupied spin-orbitals (ne
        # adds each), an add per occupied entry of each running sum, an
        # add and a compare per occupied entry of each draw, the adds of
        # the two cells found apart (3 ne at most)
        ne = (dets.to_bits(up, norb).sum(1)
              + dets.to_bits(dn, norb).sum(1)).double()
        nrow, ndraw = (4, 3) if singles else (3, 2)
        ops = float((ne * ne + ne * (nrow + 2 * ndraw + 3)).sum())
        shape = hbselect.launch_shape(cap, up.shape[1], norb, dev)
        log(f"phase 2d hb_select {name} launch: " + " ".join(
            f"{k}={v}" for k, v in shape.items()))
        x = torch.rand((cap, n2), device=dev)
        tri = torch.triu(torch.ones((n2, n2), device=dev))
        fn = (lambda a=args: hbselect.hb_select(*a))
        out[name] = _spawn_case_line(
            f"hb_select {name} cap={cap} 2n={n2}", fn,
            lambda a=args: hbselect.hb_select_plain(*a), nbytes, ops, err,
            {"cumsum_rows": lambda x=x: torch.cumsum(x, dim=1),
             "triu_matmul": lambda x=x, tri=tri: x @ tri})
        PROFILED.append((f"hb_select {name}", fn))
        del x, tri, got, ref, again

    out.update(_hb_spawn_cases(dev))

    log("phase 2d slot_parents launch: " + " ".join(
        f"{k}={v}" for k, v in
        slotpar.launch_shape(SPAWN_M, SPAWN_CAP, dev).items()))
    for name, goal in (("walk", int(0.7 * SPAWN_CAP)),
                       ("overflow", 2 * SPAWN_CAP)):
        nchild = rng.poisson(3.0, SPAWN_M) * (rng.random(SPAWN_M) < 0.5)
        nchild[500] = 5000
        cum = np.cumsum(nchild)
        i = int(np.searchsorted(cum, goal))
        nchild[i] -= cum[i] - goal
        nchild[i + 1:] = 0
        cum = torch.cumsum(torch.as_tensor(nchild, device=dev), 0)
        got = slotpar.slot_parents(cum, SPAWN_CAP)
        torch.cuda.synchronize()
        if not torch.equal(got, slotpar.slot_parents_plain(cum, SPAWN_CAP)):
            raise AssertionError(f"2d slot_parents {name}: differs")
        slots = torch.arange(SPAWN_CAP, device=dev)
        fn = (lambda c=cum: slotpar.slot_parents(c, SPAWN_CAP))
        out[f"slot_{name}"] = _spawn_case_line(
            f"slot_parents {name} M={SPAWN_M} cap={SPAWN_CAP} "
            f"total={goal}", fn,
            lambda c=cum: slotpar.slot_parents_plain(c, SPAWN_CAP),
            (SPAWN_M + SPAWN_CAP) * 8,
            SPAWN_CAP * int(np.ceil(np.log2(SPAWN_M))), 0.0,
            {"searchsorted": lambda c=cum, s=slots:
             torch.searchsorted(c, s, right=True)})
        PROFILED.append((f"slot_parents {name}", fn))
    log(f"phase 2d seconds={time.time() - t_start:.2f}")
    return out["walk_heg14"], out["spawn_c2_f32_pack"], out["slot_walk"]


# ---------------------------------------------------------------------------
# Phase 2e: the sequential initiator combine K5 vs its plain version
# ---------------------------------------------------------------------------

SEQ_LONG = 30_000                      # 2e's long group (the plain
# version's passes number its active rows, on the CPU: ~80 us a pass)


def _seq_rows(n, seed, wdt, long_group=0):
    """n merge rows in groups of 1 to ~30 rows (p_start 0.45), with one
    group of `long_group` rows at a random place if asked; weights mixing
    exact ties and zeros with floats whose running sums round, initiators
    0-3 (3 permanent)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    starts = rng.random(n) < 0.45
    if long_group:
        at = int(rng.integers(1, n - long_group))
        starts[at:at + long_group] = False
        starts[at] = starts[at + long_group] = True
    starts[0] = True
    ties = rng.choice([-2.0, -1.0, 1.0, 2.0, 0.0], n)
    floats = rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e3], n)
    wts = np.where(rng.random(n) < 0.5, ties, floats).astype(wdt)
    return starts, wts, rng.integers(0, 4, n).astype(np.int32)


SEQ_EMPTY = 582_030                    # HEG-14's group of empty slots


def _seq_walk_rows(seed, wdt):
    """The walk's merge rows (MERGE_N): the first rows those of occupied
    dets in groups of 1 to ~20 (15% zero weights: dead walkers), then one
    group of SEQ_EMPTY empty slots, all of weight 0 (as phase 12e finds
    them at HEG-14)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    occ = MERGE_N - SEQ_EMPTY
    starts = np.zeros(MERGE_N, bool)
    starts[:occ] = rng.random(occ) < 0.4
    starts[0] = starts[occ] = True
    ties = rng.choice([-2.0, -1.0, 1.0, 2.0], occ)
    floats = rng.standard_normal(occ) * rng.choice([1e-3, 1.0, 1e3], occ)
    w = np.where(rng.random(occ) < 0.5, ties, floats)
    w[rng.random(occ) < 0.15] = 0.0
    wts = np.concatenate([w, np.zeros(SEQ_EMPTY)]).astype(wdt)
    return starts, wts, rng.integers(0, 4, MERGE_N).astype(np.int32)


def _longest_group(neq):
    """The most rows of one group of the merge rows (a device scalar)."""
    import torch
    idx = torch.arange(neq.shape[0], device=neq.device)
    first = torch.cummax(torch.where(neq, idx, 0), 0).values
    return (idx - first).max() + 1


def _seq_bytes(n, wdt_bytes, n_active):
    """K5's bytes: neq and the weights read once, the row initiators of the
    n_active active rows read once (an inactive row's result depends only
    on the carry of the last active row before it), the running
    initiators written once."""
    return n * (1 + wdt_bytes + 4) + 4 * n_active


def phase_seq_init_vs_plain(dev):
    """Phase 2e: K5 at the walk's merge length (720,896 rows) in groups of
    1 to ~30 rows, float32 and float64, against its plain version on the
    card, bit for bit (a second call the same bits); then with one group
    of 30,000 rows, against the plain version on the CPU (its passes
    number the longest active group); then the walk's shape (one group of
    582,030 zero-weight rows), plain on the card.  Prints what phase 2
    prints, the longest group, the longest active group and the active
    rows; no PyTorch call computes this non-associative rule (library
    none).  Returns the float32 merge case's numbers."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.ops import cudabuild, seqinit
    t_start = time.time()
    for line in cudabuild.ptxas_summary(seqinit._SOURCE):
        log(f"phase 2e ptxas {seqinit._SOURCE}: {line}")
    out = {}
    for name, rows, on_cpu in (
            ("merge_f32", _seq_rows(MERGE_N, 25, np.float32), False),
            ("merge_f64", _seq_rows(MERGE_N, 25, np.float64), False),
            ("long_group_f32", _seq_rows(MERGE_N, 25, np.float32, SEQ_LONG),
             True),
            ("walk_f32", _seq_walk_rows(25, np.float32), False)):
        host = [torch.as_tensor(x) for x in rows]
        args = [x.to(dev) for x in host]
        got = seqinit.sequential_initiator(*args)
        again = seqinit.sequential_initiator(*args)
        torch.cuda.synchronize()
        stats = {}
        t0 = time.perf_counter()
        if on_cpu:
            ref = seqinit.sequential_initiator_plain(*host, stats=stats)
            plain_ms = (time.perf_counter() - t0) * 1e3
            where = "cpu"
        else:
            ref = seqinit.sequential_initiator_plain(*args,
                                                     stats=stats).cpu()
            plain_ms = _median_ms(
                lambda a=args: seqinit.sequential_initiator_plain(*a),
                reps=3, warm=1)
            where = "card"
        if not (torch.equal(got.cpu(), ref) and torch.equal(got, again)):
            raise AssertionError(f"2e seq_init {name}: differs from the "
                                 "plain version or from its second call")
        fn = (lambda a=args: seqinit.sequential_initiator(*a))
        ms = _median_ms(fn)
        dev_us = _device_us(fn)
        nbytes = _seq_bytes(MERGE_N, rows[1].itemsize, stats["active"])
        bound_us, bound_by = _bound_us(nbytes)
        longest = int(_longest_group(args[0]))
        log(f"phase 2e seq_init {name}: n={MERGE_N} longest_group={longest} "
            f"longest_active_group={stats['passes'] + 1} "
            f"active_rows={stats['active']} "
            f"match max_abs_err=0 wrapper_ms={ms:.4f} device_us={dev_us:.1f} "
            f"bound_us={bound_us:.2f} bound_by={bound_by} bound_MB="
            f"{nbytes / 1e6:.2f} share={bound_us / dev_us:.4f} "
            f"plain_{where}_ms={plain_ms:.4f} library_ms=none")
        PROFILED.append((f"seq_init {name}", fn))
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         device_us=dev_us, bound_us=bound_us,
                         bound_by=bound_by, library_ms=None)
    log(f"phase 2e seconds={time.time() - t_start:.2f}")
    return out["merge_f32"]


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

    _reset_counts()
    t3 = time.time()
    out = run_walk(system, trial, cfg, nstep=NSTEP, nblk=nblk,
                   nblk_eq=nblk_eq, w_abs_begin=W_BEGIN,
                   e_trial_initial=trial.e_trial, verbose=True,
                   max_eq_extensions=2, tables=tables, state=state, seed=1)
    torch.cuda.synchronize()
    t_walk = time.time() - t3
    launches = _read_counts()

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
        f"gate_mHa={1e3 * gate:.4f} launches={launches}")

    if bool(out.state.overflow):
        raise AssertionError("unresolved capacity overflow")
    if not (np.all(np.isfinite(out.w_abs_trace)) and np.isfinite(out.e_mixed)
            and np.isfinite(out.e_err)):
        raise AssertionError("non-finite walk output")
    if abs(pop - W_TARGET) > 0.1 * W_TARGET:
        raise AssertionError(f"population {pop:.0f} not within 10% of target")
    # a spawn with a runaway weight shows as a block far off the target
    # and as a capacity overflow
    blocks = out.w_abs_trace[-out.n_measured:].reshape(-1, NSTEP).mean(axis=1)
    if out.capacity_grows or np.abs(blocks / W_TARGET - 1).max() > 0.2:
        raise AssertionError(f"population bursts: block w_abs {blocks}, "
                             f"{out.capacity_grows} capacity growths")
    _need("phase 3 main path", launches, "seg_scan", "hb_spawn",
          "slot_parents")
    if abs(bias) >= gate:
        raise AssertionError(f"|e_mixed - oracle| = {abs(bias):.6f} >= "
                             f"{gate:.6f}")
    return launches, system, res, trial, _walkers(out.state)


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

    _reset_counts()
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

    cfg = WalkConfig(mwalk=458_752, cap_spawn=262_144, norb=system.norb,
                     nup=system.nup, ndn=system.ndn, n_words=system.n_words,
                     tau=2e-3, w_abs_target=W_TARGET, spawn_granularity=2.0,
                     min_wt=0.5, r_initiator=0.5, f32_state=False,
                     proj_bf16=False, has_singles=False)
    _reset_counts()
    t0 = time.time()
    out = run_walk(system, trial, cfg, nstep=100, nblk=2, nblk_eq=2,
                   w_abs_begin=W_TARGET, e_trial_initial=trial.e_trial,
                   verbose=False, max_eq_extensions=0, seed=2)
    torch.cuda.synchronize()
    t_walk = time.time() - t0
    counts = _read_counts()
    launches = counts["spmv"]
    pop = float(np.mean(out.w_abs_trace[-100:]))
    log(f"phase 5 f64 walk: gens={len(out.w_abs_trace)} "
        f"gen_per_s={out.steps_per_sec:.3f} pop={pop:.1f} "
        f"e_mixed={out.e_mixed:.9f} +- {out.e_err:.9f} "
        f"launches={counts} seconds={t_walk:.1f}")
    _need("phase 5 f64 walk", counts, *F64_WALK)
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
# sector; the integrals are synthetic (the C2 FCIDUMP is not in the repo;
# sqmc_tpu_torch/systems/chem/synthetic.py writes the file).
C2_SYMS = [1, 5, 3, 2, 1, 7, 6, 5, 1, 2, 3, 1, 6, 7, 5, 4, 1, 5, 3, 2, 8, 5,
           1, 7, 6, 5]
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
100 3 3 0                          nstep,nblk,nblk_eq,ipr
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


def write_c2_fcidump(path):
    """The synthetic C2-shaped FCIDUMP (seed 26) at `path`."""
    from sqmc_tpu_torch.systems.chem.synthetic import C2_SYMS as syms
    from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump as w
    assert syms == C2_SYMS
    return w(path)


CLI_JOBS = []                         # decks started and not yet finished


def _start_cli(tag, deck, workdir, *extra):
    """Start python -m sqmc_tpu_torch -i deck on the card in a subprocess
    (stdout and stderr to files, so that several can run at once); returns
    the job for :func:`_finish_cli`."""
    deck_path = os.path.join(workdir, f"{tag}.deck")
    with open(deck_path, "w") as f:
        f.write(deck)
    out = [open(os.path.join(workdir, f"{tag}.{s}"), "w+")
           for s in ("stdout", "stderr")]
    proc = subprocess.Popen([sys.executable, "-m", "sqmc_tpu_torch", "-i",
                             deck_path, *extra], stdout=out[0], stderr=out[1],
                            text=True, cwd=workdir,
                            env=dict(os.environ, PYTHONPATH=HERE))
    job = (tag, proc, out, workdir, time.time())
    CLI_JOBS.append(job)
    return job


def _finish_cli(job):
    """Wait for a deck started by :func:`_start_cli`, whose exit code becomes
    the smoke's.  The whole output goes to <workdir>/<tag>.log; returns
    (stdout, seconds from its start, {kernel: launches})."""
    import re
    tag, proc, files, workdir, t0 = job
    try:
        rc = proc.wait(timeout=max(1.0, 600 - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    sec = time.time() - t0
    CLI_JOBS.remove(job)
    stdout, stderr = [], []
    for f, text in zip(files, (stdout, stderr)):
        f.seek(0)
        text.append(f.read())
        f.close()
        os.remove(f.name)
    stdout, stderr = stdout[0], stderr[0]
    with open(os.path.join(workdir, f"{tag}.log"), "w") as f:
        f.write(stdout + stderr)
    if rc != 0:
        log(stdout[-3000:] + stderr[-3000:])
        log(f"cli deck {tag}: python -m sqmc_tpu_torch exited {rc}")
        sys.exit(rc if rc > 0 else 1)
    m = re.search(r"Kernel launches: " + " ".join(
        rf"{k}=(\d+)" for k in KERNELS), stdout)
    counts = {k: int(v) for k, v in zip(KERNELS, m.groups())}
    log(f"cli deck {tag}: seconds={sec:.2f} launches={counts}")
    return stdout, sec, counts


def _stop_cli_jobs():
    """Kill every deck still running (a phase failed before waiting)."""
    while CLI_JOBS:
        _, proc, files, _, _ = CLI_JOBS.pop()
        proc.kill()
        proc.wait()
        for f in files:
            f.close()


def _run_cli(tag, deck, workdir, *extra):
    """python -m sqmc_tpu_torch -i deck on the card, alone; see
    :func:`_finish_cli`."""
    return _finish_cli(_start_cli(tag, deck, workdir, *extra))


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
    _need("phase 6b walk deck", c_walk, *F64_WALK)
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
        _reset_counts()
        out = run_walk(s, trial, cfg, nstep=30, nblk=2, nblk_eq=1,
                       w_abs_begin=500.0, e_trial_initial=e0, verbose=False)
        torch.cuda.synchronize()
        counts[z] = c = _read_counts()
        err = out.e_mixed - e0
        log(f"phase 6c ts oracle z={z:+d}: dim={n} e0={e0:.12f} "
            f"e_mixed={out.e_mixed:.12f} err={err:.3e} launches={c} "
            f"seconds={time.time() - t0:.2f}")
        if abs(err) > 1e-8:
            raise AssertionError(f"the z={z} oracle missed e0 by {err:.3e}")
        _need(f"phase 6c z={z}", c, *F64_WALK)
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
COUNTS7 = dict.fromkeys(KERNELS, 0)   # phase 7's launches, path by path


def _counted(fn, total=None):
    """Run fn() with every kernel count set to 0 just before and read just
    after; adds them to `total` (COUNTS7 unless given) and returns (result,
    counts)."""
    _reset_counts()
    out = fn()
    c = _read_counts()
    total = COUNTS7 if total is None else total
    for k in c:
        total[k] += c[k]
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
                            r_initiator=0.5), 14, 6, 100, 0.5 * HUB_W),
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
            f"gate_mHa={1e3 * gate:.4f} launches={c} "
            f"seconds={time.time() - t0:.1f} [{smi}]")
        _need(f"7a {name}", c, "seg_scan", "slot_parents",
              *(("hb_spawn",) if name == "linear" else ()))
    HUB_RESULTS.update(e_var=e_var, e_tot=e_tot)
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
    from the wf_type and g cards), within 4 seed scatters of e0 (the
    deck's e_mixed scatters by 3.1e-3 over seeds, 1.3 times its blocking
    error bar: tools/chain_seed_scatter.py)."""
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
                    or not abs(e_cli - e0) < 4 * CHAIN_SCATTER_DET:
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
                s, trial, cfg, nstep=GUIDED_NSTEP, nblk=2, nblk_eq=2,
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
        # the CT walks run 1 + 2 blocks (the smoke's time limit)
        nblk, nblk_eq = (2, 1) if name.startswith("ct ") else (3, 2)
        e0 = float(run_hci(s, **exact).energies[0])
        trial = build_trial_wavefunction(s, eps_var=eps, n_psi_t=n_psi_t, n_imp=1)
        cfg = WalkConfig(mwalk=2048, cap_spawn=8192, cap_fresh=2048,
                         norb=s.norb, nup=2, ndn=2, n_words=1,
                         w_abs_target=2000.0, has_singles=s.has_singles,
                         r_initiator=0.0, **kw)
        t0 = time.time()
        out, c = _counted(lambda: run_walk(
            s, trial, cfg, nstep=nstep, nblk=nblk, nblk_eq=nblk_eq,
            w_abs_begin=1500.0,
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
        heg14, heg14_trial, cfg, nstep=100, nblk=3, nblk_eq=3,
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
    group-max trace to 1e-10 (and K5 on the sequential walk's own rows,
    one more generation, against its plain version: _seq_on_walk_rows);
    then, on the stochastic walk, a state saved
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
        if name == "sequential" and st.wt.is_cuda:
            log(f"phase 7c deterministic limit sequential seq_init on the "
                f"walk's rows: {_seq_on_walk_rows(st, tab, cfg, 1)}")

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


# ---------------------------------------------------------------------------
# Phase 8: the small-model family (dense-vector walk, VMC / CPMC, restart
# artifacts)
# ---------------------------------------------------------------------------

# Seed scatter of e_mixed on the 1x8 chain deck's configuration (standard
# deviation over 8 seeds on the CPU, tools/chain_seed_scatter.py): the
# blocking error bar of one run is 1.2-1.3 times too small there, so the
# chain gates are a multiple of the scatter, not of the run's own sigma.
CHAIN_SCATTER_DET, CHAIN_SCATTER_DENSE = 3.124e-3, 1.042e-3
COUNTS8 = dict.fromkeys(KERNELS, 0)   # phase 8's launches, path by path

DENSE_WALK_CARDS = """\
{seed} 7                               irand_seed
100 {nblk} {nblk_eq} 0                 nstep,nblk,nblk_eq,ipr
200000 200000 0                    w_abs_gen_begin, w_abs_gen_target, MWALK
0.5 {tau}                          tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
{pop_ctrl} {e_trial} 0.5           population_control_expon, e_trial_initial, min_wt
heat_bath2 {imp} 0. 0 1.           proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
{run_type}
.false. f                          semistochastic, use_exponential_projector
{psi_g}"""
HUBBARD_DENSE_CARDS = """\
'hubbard' 0                        hamiltonian_type,ipr
3 3                                l_x, l_y
t f                                pbc, neel_up_only
1. 4.                              t, U
4 4                                n_alpha, n_beta
0                                  diagonalize_ham
{ndet_psi_t}                       ndet_psi_t
{iwdet} iwdet_psi_t
{cdet} cdet_psi_t
"""
HUB_DENSE_NPSIT = 1000                # Psi_T dets of the 8a decks
FICT_NDET = 16384
FICTITIOUS_CARDS = """\
'fictitious' 0                     hamiltonian_type,ipr
{bosonic} 1. 0.5 0.5 0.5           bosonic, spectrum_coef, spectrum_power, ham_diag_fluc, ham_offdiag_fluc
{ndet}                             ndet
1                                  diagonalize_ham
1                                  ndet_psi_t
1                                  iwdet_psi_t
0.0078125                          cdet_psi_t
"""
HUB2_VMC_DECK = """\
7 3                                irand_seed
100 4 2 0                          nstep,nblk,nblk_eq,ipr
1500 3000 4096                     w_abs_gen_begin, w_abs_gen_target, MWALK
0.3 0.02                           tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
fast_heatbath 0 0. 0 1.            proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
vmc                                run_type
.false. f                          semistochastic, use_exponential_projector
'hubbard2' 0                       hamiltonian_type,ipr
4 4                                l_x, l_y
t f                                pbc, neel_up_only
1. 4.                              t, U
5 5                                n_alpha, n_beta
gutz                               wf_type
{g}                                g
0                                  diagonalize_ham
"""


def _dense_deck(system_cards, run_type, imp, seed, tau="0.", nblk=25,
                nblk_eq=15, eps=None, e_trial="0.", pop_ctrl="10."):
    """A dense-engine walk deck: the walk cards, then the system's.  The
    dense engine's run_dense_walk counts nblk as all blocks, the first nblk_eq of them
    equilibration."""
    rt = f"{run_type:<34} run_type"
    if eps is not None:
        rt += f"\n{eps:<34} partial_node_eps"
    psi_g = "0. 0.                              psi_g_energy, psi_g_epsilon\n" \
        if imp else ""
    return DENSE_WALK_CARDS.format(seed=seed, nblk=nblk, nblk_eq=nblk_eq,
                                   tau=tau, imp=imp, run_type=rt,
                                   psi_g=psi_g, e_trial=e_trial,
                                   pop_ctrl=pop_ctrl) + system_cards


def _dense_cli(tag, deck, workdir):
    """Run a dense-engine deck through the CLI on the card.  Returns a dict
    of what it printed: e_mixed, e_err, the walk's rate, the population,
    the set-up seconds."""
    import re
    text, sec, c = _run_cli(tag, deck, workdir)
    if any(c.values()):
        raise AssertionError(f"{tag}: the dense engine launched a det-walk "
                             "kernel")
    me = re.search(r"e_mixed=\s*([-+0-9.]+)\s*\+-\s*([0-9.eE-]+)", text)
    m = re.search(r"dense walk: measured_gens=(\d+) gen_per_s=([0-9.]+) "
                  r"device_ms_per_gen=([0-9.]+) w_abs=([0-9.]+)", text)
    if not (me and m):
        log(text[-3000:])
        raise AssertionError(f"{tag}: the deck printed no finite e_mixed")
    e, err = map(float, me.groups())
    out = dict(e=e, err=err, gens=int(m.group(1)), gen_per_s=float(m.group(2)),
               ms_per_gen=float(m.group(3)), pop=float(m.group(4)),
               seconds=sec, text=text)
    for key, tag_ in (("t_matrix", "fictitious matrix"),
                      ("t_eigh", "diagonalize")):
        mm = re.search(rf"END OF {tag_} CP, REAL TIME\s+[0-9.]+\s+([0-9.]+)",
                       text)
        out[key] = float(mm.group(1)) if mm else float("nan")
    if "energy_exact=" in text:
        out["e_exact"] = _grab(text, r"Setting e_trial \(from diagonalizing "
                                     r"Hamiltonian\) =")
        out["tau"] = float(re.search(r"tau_multiplier, tau=\s*[0-9.]+\s*"
                                     r"([0-9.]+)", text).group(1))
    return out


def _gate_dense(tag, r, oracle, target_pop=200_000.0, lower_bound_only=False,
                floor=2e-3):
    import math
    d = r["e"] - oracle
    gate = max(5 * r["err"], floor)
    log(f"{tag}: e_mixed={r['e']:.9f} +- {r['err']:.9f} oracle={oracle:.9f} "
        f"diff_mHa={1e3 * d:.4f} gate_mHa={1e3 * gate:.4f} pop={r['pop']:.1f} "
        f"measured_gens={r['gens']} gen_per_s={r['gen_per_s']:.3f} "
        f"device_ms_per_gen={r['ms_per_gen']:.4f} deck_seconds="
        f"{r['seconds']:.2f}")
    if not (math.isfinite(r["e"]) and math.isfinite(r["err"])):
        raise AssertionError(f"{tag}: non-finite energy")
    if abs(r["pop"] - target_pop) > 0.1 * target_pop:
        raise AssertionError(f"{tag}: population {r['pop']:.0f} not within "
                             f"10% of {target_pop:.0f}")
    if lower_bound_only:
        if d < -5 * r["err"]:
            raise AssertionError(f"{tag}: e_mixed below the exact energy by "
                                 "more than 5 sigma")
    elif abs(d) >= gate:
        raise AssertionError(f"{tag}: |e_mixed - oracle| = {abs(d):.6f} >= "
                             f"{gate:.6f}")


def phase_dense_hubbard(dev, workdir):
    """8a: the dense `hubbard` deck through the CLI at full width: the 3x3
    periodic cluster, U/t = 4, 4 + 4 electrons, 126^2 = 15,876 dets (H is
    2.02 GB in f64).  The oracle is independent of the dense code: the
    Davidson ground state over the whole determinant space of the
    real-space system, on the SpMV kernel."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.davidson import davidson
    from sqmc_tpu_torch.algo.hci import _rayleigh_f64
    from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
    from sqmc_tpu_torch.ops.spmv import BlockEllSpmv
    from sqmc_tpu_torch.systems.hubbard.system import (
        enumerate_dets, make_hubbard_real_system)

    t0 = time.time()
    s = make_hubbard_real_system(3, 3, 1.0, 4.0, 4, 4, device=dev)
    up, dn = (torch.as_tensor(x, device=dev) for x in enumerate_dets(9, 4, 4))

    def oracle():
        # a random start: a single det lies in one symmetry sector of the
        # cluster, and Davidson would stay there
        H = build_sparse_ham(s.table, up, dn, 4, 4, 9)
        x0 = np.random.default_rng(8).standard_normal((H.n, 1))
        evals, evecs = davidson(H, 1, initial=x0, tol=3e-6, max_iter=400,
                                matvec_fn=BlockEllSpmv(H))
        return H, _rayleigh_f64(H, evecs[:, 0]), evecs[:, 0]

    (H, e0, vec), c = _counted(oracle, COUNTS8)
    n = H.n
    # Psi_T through the cards: the 1,000 dets of largest weight in the
    # ground state with their coefficients (det index = iup * 126 + idn,
    # 1-based in the deck).  The guiding function equals Psi_T there and is
    # a positive constant elsewhere.  A single-det Psi_T would do for the
    # energy, but the population control follows the cumulative mixed
    # estimate, which the first generations on one det would dominate.
    top = np.argsort(-np.abs(vec))[:HUB_DENSE_NPSIT]
    vec = vec / np.linalg.norm(vec)
    log(f"phase 8a oracle: dets={n} nonzeros={2 * len(H.vals) + n} "
        f"e0={e0:.9f} spmv_launches={c['spmv']} largest_coef="
        f"{float(np.abs(vec).max()):.4f} psi_t_dets={len(top)} psi_t_norm2="
        f"{float(np.sum(vec[top] ** 2)):.4f} seconds={time.time() - t0:.2f}")
    if n != 15876 or c["spmv"] <= 0:
        raise AssertionError("8a: the oracle did not run on the SpMV kernel "
                             "over the whole space")
    cards = HUBBARD_DENSE_CARDS.format(
        ndet_psi_t=len(top), iwdet=" ".join(str(i + 1) for i in top),
        cdet=" ".join(f"{vec[i]:.8f}" for i in top))
    bytes_h = n * n * 8
    log(f"phase 8a matvec bound: H is {bytes_h / 1e9:.3f} GB in f64, "
        f"{bytes_h / 3.35e12 * 1e3:.3f} ms per generation at 3.35 TB/s")
    # e_trial_initial: the oracle's energy to 3 digits, as a user's estimate
    guess = f"{e0:.3f}"
    r = _dense_cli("8a_hubbard_dense_none",
                   _dense_deck(cards, "none", 0, 31, tau="0.02",
                               e_trial=guess), workdir)
    _gate_dense("phase 8a hubbard dense none", r, e0)
    r = _dense_cli("8a_hubbard_dense_fixed_node1",
                   _dense_deck(cards, "fixed_node1", 1, 32, tau="0.02",
                               e_trial=guess), workdir)
    _gate_dense("phase 8a hubbard dense fixed_node1", r, e0,
                lower_bound_only=True)
    if "ndet=          15876" not in r["text"]:
        raise AssertionError("8a: the deck did not run at 15,876 dets")


FICT_POP_CTRL = 250.0                 # population_control_expon of the 8b decks


def phase_dense_fictitious(dev, workdir):
    """8b: the `fictitious` system at ndet 16,384 (2.15 GB in f64),
    spectrum i^0.5 with fluctuations 0.5.  Through the CLI: bosonic 1 with
    the plain projector and bosonic 0 with partial_node (eps 0.5); each
    deck diagonalizes its matrix on the card (torch.linalg.eigh), the
    oracle of the exact projector.  partial_node's oracle is the same
    projector iterated here without a random draw (min_wt = 0), on the
    deck's matrix built again from its seed; release_node and sr (eps 0)
    run on that matrix in this process, against the deck's exact energy.
    tau is 0.0039 here, so the decks raise population_control_expon to
    250: a signed walk loses about 3% of |w| a generation to cancellation,
    and at the default 10 the population settles at 0.44 of its target."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo import densewalk as dw
    from sqmc_tpu_torch.cli import _seed4
    from sqmc_tpu_torch.systems.toy import make_fictitious_system

    def deck(bosonic, run_type, imp, seed, **kw):
        return _dense_deck(FICTITIOUS_CARDS.format(bosonic=bosonic,
                                                   ndet=FICT_NDET),
                           run_type, imp, seed, pop_ctrl=f"{FICT_POP_CTRL}",
                           **kw)

    r = _dense_cli("8b_fictitious_boson_none", deck(1, "none", 0, 41), workdir)
    log(f"phase 8b fictitious: ndet={FICT_NDET} matrix_seconds="
        f"{r['t_matrix']:.2f} eigh_seconds={r['t_eigh']:.2f} tau={r['tau']:.6f}")
    if f"ndet={FICT_NDET:15d}" not in r["text"]:
        raise AssertionError("8b: the deck did not run at full width")
    _gate_dense("phase 8b fictitious bosonic none", r, r["e_exact"])

    r = _dense_cli("8b_fictitious_fermi_partial_node",
                   deck(0, "partial_node", 1, 42, eps=0.5), workdir)
    t0 = time.time()
    s = make_fictitious_system(FICT_NDET, 0, 1.0, 0.5, 0.5, 0.5,
                               seed=_seed4(42), device=dev)
    psi_t = np.zeros(FICT_NDET)
    psi_t[0] = 1.0
    psi_g = np.full(FICT_NDET, 0.0078125)
    base = dict(ndet=FICT_NDET, tau=r["tau"], w_abs_target=2e5,
                importance_sampling=1, pop_ctrl_exponent=FICT_POP_CTRL)
    cfg = dw.DenseWalkConfig(run_type="partial_node", partial_node_eps=0.5,
                             min_wt=0.0, **base)
    tables = dw.build_dense_tables(s, cfg, psi_t, psi_g)
    state = dw.init_dense_state(cfg, psi_t, psi_g, 2e5, r["e_exact"],
                                device=dev)
    state, stats = dw.dense_walk_block(state, tables, cfg, 3000)
    dw.release_graphs()                 # the graph holds the tables
    e_pn = float(stats["e_gen"][-1])
    drift = abs(e_pn - float(stats["e_gen"][-500]))
    log(f"phase 8b partial_node oracle: deterministic limit after 3000 "
        f"generations e={e_pn:.9f} (last 500 moved {drift:.2e}) exact e0="
        f"{r['e_exact']:.5f} seconds={time.time() - t0:.2f}")
    if drift > 2e-6 or e_pn < r["e_exact"] - 1e-4:
        raise AssertionError("8b: the partial-node oracle did not converge "
                             "or lies below e0")
    del tables, state
    _gate_dense("phase 8b fictitious fermi partial_node eps=0.5", r, e_pn)

    for run_type, kw in (("release_node", dict(release_step=750)),
                         ("sr", dict(partial_node_eps=0.0))):
        cfg = dw.DenseWalkConfig(run_type=run_type, min_wt=0.5, **kw, **base)
        t0 = time.time()
        out = dw.run_dense_walk(s, cfg, psi_t, psi_g, nstep=100, nblk=25,
                                nblk_eq=15, w_abs_begin=2e5,
                                e_trial_initial=r["e_exact"], seed=43)
        _gate_dense(f"phase 8b fictitious fermi {run_type}", dict(
            e=out.e_mixed, err=out.e_err, gens=out.n_measured,
            gen_per_s=out.n_measured / out.t_measured,
            ms_per_gen=out.device_ms_per_gen,
            pop=float(np.mean(out.w_abs_trace[-100:])),
            seconds=time.time() - t0), r["e_exact"])
    del s
    torch.cuda.empty_cache()


def phase_two_engines(dev):
    """8c: the 1x8 open chain (784 dets, no sign violator: fixed-node is
    exact) through both walk engines, fixed_node1, the same Gutzwiller
    guiding function, tau and population: the two e_mixed agree within 5
    combined sigma, and each lies within 4 seed scatters of e0."""
    import dataclasses
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.densewalk import DenseWalkConfig, run_dense_walk
    from sqmc_tpu_torch.algo.guiding import (eval_guiding,
                                             make_gutzwiller_guiding)
    from sqmc_tpu_torch import cli
    from sqmc_tpu_torch.config import parse_input
    from sqmc_tpu_torch.systems.hubbard.system import (
        enumerate_dets, make_hubbard_dense_system, make_hubbard_real_system)

    s = make_hubbard_real_system(1, 8, 1.0, 4.0, 2, 2, pbc=False, device=dev)
    guide = make_gutzwiller_guiding(s, g=0.7)
    toy = make_hubbard_dense_system(1, 8, 1.0, 4.0, 2, 2, pbc=False,
                                    device=dev)
    up, dn = (torch.as_tensor(x, device=dev) for x in enumerate_dets(8, 2, 2))
    g = eval_guiding(guide, "gutzwiller", up, dn, 8, 2, 2)
    e0 = float(torch.linalg.eigvalsh(toy.ham)[0])
    ht = toy.ham * (g[:, None] / g[None, :])
    nviol = int(((ht > 0) & ~torch.eye(toy.ndet, dtype=torch.bool,
                                       device=dev)).sum())
    tau, pop, nstep, nblk, nblk_eq = 0.02, 3000.0, 100, 4, 2

    t0 = time.time()
    dcfg = DenseWalkConfig(ndet=toy.ndet, tau=tau, w_abs_target=pop,
                           run_type="fixed_node1", importance_sampling=1,
                           min_wt=0.5)
    d = run_dense_walk(toy, dcfg, g, g, nstep=nstep, nblk=nblk + nblk_eq,
                       nblk_eq=nblk_eq, w_abs_begin=1500.0,
                       e_trial_initial=e0, seed=5)
    t1 = time.time()
    # the determinant walk as the chain deck of 7c sets it up (Psi_T of 200
    # dets from HCI, the cards' capacities), from another seed: the seed
    # scatter above was taken on exactly this configuration
    cfg = dataclasses.replace(parse_input(HUB2_FN_DECK), seeds=(5, 5))
    w, c = _counted(lambda: cli.run_from_config(cfg, verbose=False,
                                                device=dev), COUNTS8)
    comb = float(np.hypot(d.e_err, w.e_err))
    log(f"phase 8c two engines on the 1x8 chain: dets={toy.ndet} violators="
        f"{nviol} e0={e0:.6f} dense e_mixed={d.e_mixed:.6f} +- {d.e_err:.6f} "
        f"({nstep * nblk / d.t_measured:.1f} gen/s, {t1 - t0:.1f} s) "
        f"determinant e_mixed={w.e_mixed:.6f} +- {w.e_err:.6f} "
        f"({w.steps_per_sec:.1f} gen/s, {time.time() - t1:.1f} s) "
        f"difference={d.e_mixed - w.e_mixed:+.6f} combined_sigma={comb:.6f} "
        f"seg_scan_launches={c['seg_scan']}")
    if nviol or c["seg_scan"] <= 0 or w.capacity_grows:
        raise AssertionError("8c: the chain has violators, or the "
                             "determinant walk missed its kernel")
    if not (abs(d.e_mixed - w.e_mixed) < 5 * comb
            and abs(d.e_mixed - e0) < 4 * CHAIN_SCATTER_DENSE
            and abs(w.e_mixed - e0) < 4 * CHAIN_SCATTER_DET):
        raise AssertionError("8c: the two engines disagree, or one is off "
                             "the exact energy")


def phase_vmc_cpmc_dm(dev, workdir):
    """8d: VMC (through the `hubbard2` deck, run_type vmc) and CPMC on the
    4x4 periodic cluster, U/t = 4, 5 + 5 electrons; the density-matrix
    block basis on the 4x2 cluster at 4 + 4 (4,900 dets)."""
    import re
    import numpy as np
    import torch
    from sqmc_tpu_torch.systems.hubbard import cpmc, dmbasis, meanfield, vmc
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_dense_system

    e0 = -19.58094               # the cluster's exact energy (7a's cell)
    pu, pd, _ = meanfield.hartree_fock(4, 4, 1.0, 4.0, 5, 5, True)
    h = meanfield.hopping_matrix(4, 4, 1.0, True)
    Pu, Pd = pu @ pu.T, pd @ pd.T
    # at g = 1 the wavefunction is one Slater determinant: Wick's theorem
    e_slater = float(np.trace(h @ Pu) + np.trace(h @ Pd)
                     + 4.0 * np.sum(np.diag(Pu) * np.diag(Pd)))
    # g = 1 in this process (the deck's call: 256 walkers, 200 sweeps of 10
    # steps), the deck's g = 0.7 through the CLI
    t0 = time.time()
    e1, err1 = vmc.run_vmc(4, 4, 1.0, 4.0, 5, 5, g=1.0, seed=7, device=dev)
    sec = time.time() - t0
    log(f"phase 8d vmc g=1.0: e_vmc={e1:.6f} +- {err1:.6f} slater_energy="
        f"{e_slater:.6f} walkers=256 sweeps_per_s={200 / sec:.3f} "
        f"seconds={sec:.2f}")
    text, sec, _ = _run_cli("8d_hubbard2_vmc_g0.7",
                            HUB2_VMC_DECK.format(g="0.7"), workdir)
    eg, errg = map(float, re.search(
        r"e_vmc=\s*([-+0-9.]+)\s*\+-\s*([0-9.eE-]+)", text).groups())
    log(f"phase 8d vmc g=0.7 cli: e_vmc={eg:.6f} +- {errg:.6f} e0={e0:.5f} "
        f"walkers=256 sweeps_per_s={_grab(text, r'sweeps_per_s='):.3f} "
        f"deck_seconds={sec:.2f}")
    if not abs(e1 - e_slater) < 5 * err1:
        raise AssertionError("8d: VMC at g = 1 missed the Slater energy")
    if not e0 < eg < e_slater:
        raise AssertionError("8d: VMC at g = 0.7 is not between e0 and the "
                             "Slater energy")

    # the orthonormalization: many small QR factorizations against
    # Cholesky-QR in batched tensor operations
    p = torch.randn(1024, 16, 5, dtype=torch.float64, device=dev)
    ortho_ms = {m: _median_ms(lambda m=m: cpmc._orthonormalize(p, m), reps=5,
                              warm=1) for m in ("cholesky", "qr")}
    cfg = cpmc.CpmcConfig(4, 4, 1.0, 4.0, 5, 5, tau=0.05, n_walkers=1024)
    torch.cuda.synchronize()
    t0 = time.time()
    e, err = cpmc.run_cpmc(cfg, n_blocks=20, nstep=20, n_eq=5, seed=0,
                           verbose=True, device=dev)
    torch.cuda.synchronize()
    sec = time.time() - t0
    log(f"phase 8d cpmc: e={e:.6f} +- {err:.6f} e0={e0:.5f} rel_diff="
        f"{abs(e - e0) / abs(e0):.5f} walkers=1024 steps_per_s="
        f"{400 / sec:.1f} seconds={sec:.2f} orthonormalize_ms cholesky="
        f"{ortho_ms['cholesky']:.3f} qr={ortho_ms['qr']:.3f}")
    if not abs(e - e0) < 0.01 * abs(e0):
        raise AssertionError("8d: CPMC is not within 1% of e0")

    # hubbarddm: the exact rotation keeps the real-space spectrum and a
    # truncated basis is variational.  The patch density matrix comes from
    # the 12-site embedding at 2 + 2 electrons, not at the matched 6 + 6
    # filling (853,776 dets, whose sort-join does not fit the card).
    t0 = time.time()
    rho = dmbasis.patch_density_matrix(dmbasis.CROSS_BONDS,
                                       dmbasis.CROSS_NSITES, 1.0, 4.0, 2, 2,
                                       device=dev)
    u, su, sd, _ = dmbasis.block_rotation(rho)
    H_dm, _ = dmbasis.dm_basis_hamiltonian(4, 2, 1.0, 4.0, 4, 4, u, su, sd,
                                           device=dev)
    H_tr, _ = dmbasis.dm_basis_hamiltonian(4, 2, 1.0, 4.0, 4, 4, u, su, sd,
                                           keep_per_sector=3, device=dev)
    toy = make_hubbard_dense_system(4, 2, 1.0, 4.0, 4, 4, device=dev)
    w_real = torch.linalg.eigvalsh(toy.ham)
    diff = float((torch.linalg.eigvalsh(H_dm) - w_real).abs().max())
    e_tr = float(torch.linalg.eigvalsh(H_tr)[0])
    log(f"phase 8d hubbarddm 4x2 4+4: dets={toy.ndet} exact_rotation_"
        f"spectrum_diff={diff:.2e} truncated_basis={H_tr.shape[0]} "
        f"e_truncated={e_tr:.6f} e0={float(w_real[0]):.6f} "
        f"seconds={time.time() - t0:.2f}")
    if H_dm.shape[0] != 4900 or diff > 1e-9 or e_tr < float(w_real[0]) - 1e-10:
        raise AssertionError("8d: the density-matrix basis missed its oracle")


HEG_DUMP_DECK = HEG_DECK.replace(
    "f                                  dump_wf_var",
    "t                                  dump_wf_var")


def phase_restart(dev, workdir, heg14, res, trial):
    """8e: restart artifacts on HEG-14.  The HCI deck with dump_wf_var, run
    twice in one fresh directory: the second run reads the cache, skips the
    variational stage and prints the same energies.  Reference-format files
    round-trip; a walk writes its walkalize trace."""
    import re
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.semistoch import (build_trial_wavefunction,
                                               load_trial_from_reference)
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.utils import refio

    runs = []
    for k in (1, 2):
        text, sec, c = _run_cli(f"8e_heg14_dump_wf_var_run{k}", HEG_DUMP_DECK,
                                workdir)
        # cpu seconds between the BEG and END lines (the first number of a
        # timer line is the process's cpu time so far; the card's work is
        # synchronized, so it counts)
        mark = {k: float(v) for k, v in re.findall(
            r"(BEG|END) OF variational part CP, REAL TIME\s+([0-9.]+)", text)}
        t_var = mark["END"] - mark["BEG"]
        runs.append((text, sec, c, t_var))
        log(f"phase 8e dump_wf_var run {k}: "
            f"{re.search(r'^Variational energy=.*$', text, re.M).group(0)} "
            f"variational_part_cpu_seconds={t_var:.2f} deck_seconds={sec:.2f} "
            f"spmv_launches={c['spmv']} wrote={'Writing variational' in text} "
            f"read={'Reading variational' in text}")
    (t1, _, _, _), (t2, _, c2, _) = runs
    lines = [re.findall(r"^(?:Variational energy|Second-order PT energy "
                        r"lowering|Total energy \(includ. Madelung\))=.*$", t,
                        re.M)[-3:] for t in (t1, t2)]
    if ("Writing variational wavefn" not in t1
            or "Reading variational wavefn" not in t2
            or "Iteration   1" in t2 or lines[0] != lines[1] or c2["spmv"]
            or abs(_grab(t2, r"Variational energy=") - GOLD_EVAR) > 1e-6):
        raise AssertionError("8e: the second run did not restart from the "
                             "wavefunction cache with the same energies")

    t0 = time.time()
    p = os.path.join(workdir, "wf_eps_var_reference_format")
    refio.write_wf_eps_var(p, res.up, res.dn, res.wts, res.energies)
    up, dn, wts, en = refio.read_wf_eps_var(p, heg14.norb)
    ok = (np.array_equal(up, res.up.cpu().numpy())
          and np.array_equal(dn, res.dn.cpu().numpy())
          and np.array_equal(wts, res.wts) and np.array_equal(en, res.energies))
    pc, pd_ = (os.path.join(workdir, x) for x in ("psit_connections",
                                                  "dtm_projector"))
    n = (heg14.nup, heg14.ndn, heg14.norb)
    # the text files are written and parsed line by line on the host: a
    # trial of 100 Psi_T dets and 1,000 D dets keeps that to seconds
    small = build_trial_wavefunction(heg14, eps_var=EPS_VAR, n_psi_t=100,
                                     n_imp=1000)
    refio.write_psit_connections(pc, small.ct_up, small.ct_dn, small.ct_num,
                                 small.ct_den, *n)
    refio.write_dtm_projector(pd_, small.imp_up, small.imp_dn, small.imp_ham,
                              *n)
    back = load_trial_from_reference(heg14, pc, pd_)
    keep = small.ct_num.abs() > 1e-10
    ok_trial = (torch.equal(back.imp_up, small.imp_up)
                and torch.equal(back.psit_up, small.psit_up)
                and torch.equal(back.ct_up, small.ct_up[keep])
                and float((back.ct_num - small.ct_num[keep]).abs().max()) < 1e-12
                and float((back.imp_ham.dense() - small.imp_ham.dense()
                           ).abs().max()) < 1e-12
                and back.imp_up.device == small.imp_up.device)
    log(f"phase 8e reference-format round trips: wf_eps_var dets={len(up)} "
        f"equal={ok}; psit_connections rows={int(keep.sum())} dtm_projector "
        f"dets={len(small.imp_up)} nonzeros={len(small.imp_ham.vals)} "
        f"trial_equal={ok_trial} seconds={time.time() - t0:.2f}")
    if not (ok and ok_trial):
        raise AssertionError("8e: a reference-format round trip changed "
                             "the data")

    cfg = WalkConfig(mwalk=458_752, cap_spawn=262_144, norb=heg14.norb,
                     nup=heg14.nup, ndn=heg14.ndn, n_words=heg14.n_words,
                     tau=2e-3, w_abs_target=W_TARGET, spawn_granularity=2.0,
                     min_wt=0.5, r_initiator=0.5, f32_state=True,
                     has_singles=False)
    path = os.path.join(workdir, "walkalize")
    out, c = _counted(lambda: run_walk(
        heg14, trial, cfg, nstep=100, nblk=1, nblk_eq=1, w_abs_begin=W_BEGIN,
        e_trial_initial=trial.e_trial, verbose=False, max_eq_extensions=0,
        seed=3, walkalize_file=path), COUNTS8)
    with open(path) as f:
        rows = f.read().splitlines()
    fmt = re.compile(r"^ {0,9}\d{1,10} {1,6}\d\.\d{6} \d\.\d{6}e[+-]\d\d"
                     r" {1,8}-?\d+\.\d{12} {0,8}\d+$")
    good = sum(bool(fmt.match(r)) for r in rows)
    log(f"phase 8e walkalize: lines={len(rows)} well_formed={good} last="
        f"{rows[-1]!r} seg_scan_launches={c['seg_scan']}")
    if len(rows) != 200 or good != 200 or c["seg_scan"] != 200 \
            or int(rows[-1].split()[0]) != 200:
        raise AssertionError("8e: the walkalize trace is not 200 "
                             "well-formed lines")


def phase_dense(dev, heg14=None, res=None, trial=None):
    """Phase 8: 8a-8e; every path's kernel counts set to 0 just before it
    and read just after, summed into COUNTS8."""
    workdir = os.path.join(HERE, "build", "smoke_phase8")
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        os.remove(os.path.join(workdir, name))
    stamps = [time.time()]
    phase_dense_hubbard(dev, workdir)
    stamps.append(time.time())
    phase_dense_fictitious(dev, workdir)
    stamps.append(time.time())
    phase_two_engines(dev)
    stamps.append(time.time())
    phase_vmc_cpmc_dm(dev, workdir)
    stamps.append(time.time())
    if heg14 is None:
        from sqmc_tpu_torch.algo.hci import run_hci
        from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
        from sqmc_tpu_torch.systems.heg.system import make_heg_system
        heg14 = make_heg_system(*HEG, device=dev)
        res = run_hci(heg14, eps_var=EPS_VAR, eps_var_sched=[EPS_VAR] * 10,
                      verbose=False)
        trial = build_trial_wavefunction(heg14, eps_var=EPS_VAR, n_psi_t=2000,
                                         n_imp=20000)
    phase_restart(dev, workdir, heg14, res, trial)
    stamps.append(time.time())
    log(f"phase 8 launches: {COUNTS8}")
    log("phase 8 stages: " + " ".join(
        f"8{x}={b - a:.2f}" for x, a, b in zip("abcde", stamps, stamps[1:]))
        + " seconds")


# ---------------------------------------------------------------------------
# Phase 9: the legacy CI and the SHCI observables
# ---------------------------------------------------------------------------

COUNTS9 = dict.fromkeys(KERNELS, 0)   # phase 9's launches, path by path
HUB_RESULTS = {}                      # 7a's E_var and E_var + PT, when run
HUB_E0 = -19.58094                    # 7a's and 8d's oracle for the cluster
C2_SCHED = [2e-3, 2e-3, 1e-3]         # the C2 decks' eps_var schedule
C2_ACTIVE = (3, 3, 20)                # n_var_e_up, n_var_e_dn, n_var_orbs
NATORB_EPS_PT_BIG = 3e-5              # the PT vector's screen (~1e5 dets)
CAS_CORE, CAS_ACT = 2, 12             # CAS(4e,12o) of the synthetic file
LANCZOS_ITERS = 150
LANCZOS_TOL = 1e-9                    # 9b's stop: |dE| between iterations
LEGACY_ITERS = dict(selected_ci=4, trunc_lanc=8)
LEGACY_NTRUNC = 10_000
HUBK_LEGACY_DECK = """\
1 1                                irand_seed
100 {iters} {iters} 0                          nstep,nblk,nblk_eq,ipr
1000 2000 0                        w_abs_gen_begin, w_abs_gen_target, MWALK
0.1 0.                             tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
heat_bath2 0 1. 0 1.               proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
{run_type}                         run_type
.false. f                          semistochastic, use_exponential_projector
{n_trunc}                              n_truncate_det
'hubbardk' 0                       hamiltonian_type,ipr
4 4                                l_x, l_y
t f                                pbc, neel_up_only
1. 4.                              t, U
5 5                                n_alpha, n_beta
"""


def _timed(fn, dev):
    """(fn(), seconds, peak GB of device memory allocated during it)."""
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize(dev)
    return (out, time.time() - t0,
            (torch.cuda.max_memory_allocated(dev) - base) / 1e9)


def _tot_and_err(text):
    """State 1's E_var + PT of a CLI log and its error bar (0 if the PT
    was deterministic)."""
    import re
    tot = _grab(text, r"Total energy\(1\)=")
    m = re.search(r"Second-order PT energy lowering=\s*[-+0-9.eE]+\s*\+-\s*"
                  r"([0-9.eE+-]+)", text)
    return tot, float(m.group(1)) if m else 0.0


def _natorb_decks():
    """6b's deck with &natorb use_pt .false. and &greens_function, and with
    &natorb use_pt .true.; eps_pt_big defaults to eps_var, where HCI has
    already taken every det the PT vector would hold, so the second
    screens it at NATORB_EPS_PT_BIG."""
    no_pt = (C2_HCI_DECK + "&natorb get_natorbs=.true. use_pt=.false. /\n"
             "&greens_function get_greens_function=.true. n_w=50 "
             "w_min=-2. w_max=2. /\n")
    pt = C2_HCI_DECK.replace(
        "&selected_ci eps_var_sched=2*2e-3 /",
        f"&selected_ci eps_var_sched=2*2e-3 eps_pt_big={NATORB_EPS_PT_BIG:g} /"
    ) + "&natorb get_natorbs=.true. use_pt=.true. /\n"
    return {False: no_pt, True: pt}


def start_c2_decks(workdir, fcidump):
    """Start 9a's first decks together: both &natorb decks (each in its own
    directory, as each writes FCIDUMP.natorb) and &active_space."""
    jobs = {}
    for use_pt, deck in _natorb_decks().items():
        d = os.path.join(workdir, "natorb_pt" if use_pt else "natorb_no_pt")
        os.makedirs(d, exist_ok=True)
        jobs[use_pt] = _start_cli("9a_c2_natorb" + ("_pt" if use_pt else
                                                    "_greens"), deck, d,
                                  "-f", fcidump)
    jobs["active_space"] = _start_cli(
        "9a_c2_active_space", C2_HCI_DECK + "&active_space n_var_e_up=3 "
        "n_var_e_dn=3 n_var_orbs=20 /\n", workdir, "-f", fcidump)
    return jobs


def phase_c2_observables(dev, workdir, fcidump, jobs):
    """9a (i)-(iii): the &natorb (both branches), &greens_function and
    &active_space decks through the CLI on the synthetic C2-shaped file
    (`jobs`, from start_c2_decks), the natural-orbital FCIDUMPs run again
    as HCI + PT decks, and in this process the active space, ARPACK, the
    1-RDM, the PT vector, the rotation and the Green's function sum rules
    on the same system.  The decks run two or three at a time, beside this
    process's work: their seconds include that contention."""
    import numpy as np
    import torch
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.algo import rdm
    from sqmc_tpu_torch.algo.greens import greens_function_g0
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.systems.base import make_chem_system

    # (ii) + (iii) through the CLI; E_var and E_var + PT are 6b's
    text, sec_a, c_a = _finish_cli(jobs[False])
    e_var = _grab(text, r"Variational energy=")
    e_tot, e_err = _tot_and_err(text)
    g0 = _grab(text, r"trace=", every=True)
    if "Wrote FCIDUMP.natorb" not in text or len(g0) != 50 \
            or not np.all(np.isfinite(g0)):
        raise AssertionError("the &natorb / &greens_function deck is off")
    text, sec_c, c_c = _finish_cli(jobs[True])
    if abs(_grab(text, r"Variational energy=") - e_var) > 1e-9 \
            or "Wrote FCIDUMP.natorb" not in text:
        raise AssertionError("the &natorb use_pt deck is off")
    secs = dict(natorb_greens=sec_a, natorb_pt=sec_c)
    reruns = {}
    for use_pt in (False, True):
        name = "natorb_pt" if use_pt else "natorb_no_pt"
        path = os.path.join(workdir, f"FCIDUMP.{name}")
        os.replace(os.path.join(workdir, name, "FCIDUMP.natorb"), path)
        reruns[use_pt] = _start_cli(f"9a_c2_on_{name}", C2_HCI_DECK, workdir,
                                    "-f", path)

    # (i) in this process: the active space's dets, ARPACK on K2 in f64
    system = make_chem_system(fcidump, time_sym=True, z=1, point_group="d2h",
                              hf_symmetry=1, device=dev)
    kw = dict(eps_var=1e-3, eps_var_sched=C2_SCHED, n_states=2, verbose=False)
    (full, t_full, _), c_full = _counted(
        lambda: _timed(lambda: run_hci(system, device_davidson=True, **kw),
                       dev), COUNTS9)
    (act, t_act, _), c_act = _counted(
        lambda: _timed(lambda: run_hci(system, device_davidson=True,
                                       active_space=C2_ACTIVE, **kw), dev),
        COUNTS9)
    (arp, t_arp, _), c_arp = _counted(
        lambda: _timed(lambda: run_hci(system, diagonalizer="arpack", **kw),
                       dev), COUNTS9)
    # (i) through the CLI
    text, secs["active_space"], _ = _finish_cli(jobs["active_space"])
    e_act = _grab(text, r"Variational energy=")
    if e_act < e_var - 1e-9:
        raise AssertionError("the active-space E_var lies below the "
                             "unrestricted one")
    bu, bd = (dets.to_bits(w, system.norb) for w in (act.up, act.dn))
    frozen_ok = bool((bu[:, 0] == 1).all() and (bd[:, 0] == 1).all()
                     and (bu[:, 21:] == 0).all() and (bd[:, 21:] == 0).all())
    log(f"phase 9a c2 in process: device_davidson ndets={len(full.up)} "
        f"e_var={full.energies[0]:.9f} ({t_full:.2f} s, spmv {c_full['spmv']}); "
        f"active_space ndets={len(act.up)} e_var={act.energies[0]:.9f} "
        f"frozen_ok={frozen_ok} ({t_act:.2f} s, spmv {c_act['spmv']}); "
        f"arpack ndets={len(arp.up)} e_var={arp.energies[0]:.12f} "
        f"vs_cli_davidson={arp.energies[0] - e_var:.3e} ({t_arp:.2f} s, "
        f"spmv {c_arp['spmv']})")
    if not frozen_ok or abs(act.energies[0] - e_act) > 1e-6:
        raise AssertionError("the active space broke its frozen orbitals or "
                             "disagrees with the CLI")
    if abs(arp.energies[0] - e_var) > 1e-8 or c_arp["spmv"] <= 0:
        raise AssertionError("ARPACK on K2 disagrees with Davidson")
    if abs(full.energies[0] - e_var) > 1e-6 or c_full["spmv"] <= 0:
        raise AssertionError("device-Davidson HCI disagrees with the CLI")

    # (ii) in this process: each stage's seconds and peak memory
    c0 = full.wts[:, 0]
    e0 = float(full.energies[0])
    sym = np.asarray(system.table.orb_sym)
    gamma, t_rdm, m_rdm = _timed(
        lambda: rdm.get_1rdm(system, full.up, full.dn, c0), dev)
    (pu, _, _), t_pt, m_pt = _timed(lambda: rdm.first_order_pt_vector(
        system, full.up, full.dn, c0, e0, NATORB_EPS_PT_BIG), dev)
    gamma_pt, t_rdm_pt, m_rdm_pt = _timed(lambda: rdm.get_1rdm_with_pt(
        system, full.up, full.dn, c0, e0, NATORB_EPS_PT_BIG), dev)
    stats = []
    for name, g in (("rdm", gamma), ("rdm_with_pt", gamma_pt)):
        occ, U = rdm.natural_orbitals(g, sym)
        stats.append((name, float(np.trace(g)), float(occ.min()),
                      float(occ.max())))
    (h2, eri2), t_rot, m_rot = _timed(
        lambda: rdm.rotate_integrals(system.table, U), dev)
    t0 = time.time()
    rdm.write_fcidump(os.path.join(workdir, "FCIDUMP.natorb_in_process"), h2,
                      eri2, system.table.core_energy, sym, nelec=8)
    t_write = time.time() - t0
    log(f"phase 9a natorb stages: rdm {t_rdm:.3f} s {m_rdm:.3f} GB; "
        f"pt_vector eps_pt_big={NATORB_EPS_PT_BIG:g} pt_dets={len(pu)} "
        f"{t_pt:.3f} s {m_pt:.3f} GB; rdm_with_pt {t_rdm_pt:.3f} s "
        f"{m_rdm_pt:.3f} GB; rotation {t_rot:.3f} s {m_rot:.3f} GB; write "
        f"{t_write:.3f} s; trace / occupation min / max: {stats}")
    for name, tr, lo, hi in stats:
        if abs(tr - 8.0) > 1e-10 or lo < -1e-10 or hi > 2.0 + 1e-10:
            raise AssertionError(f"{name}: trace {tr!r} or occupations "
                                 f"[{lo!r}, {hi!r}] out of range")

    # (iii) the sum rules at w = 1e8: w G+ -> 2 I - gamma, w G- -> gamma
    (gp, gm), t_g, m_g = _timed(lambda: greens_function_g0(
        system, full.up, full.dn, c0, e0, np.array([1e8])), dev)
    err_p = float(np.abs(1e8 * gp[0].real - (2 * np.eye(system.norb) - gamma)
                         ).max())
    err_m = float(np.abs(1e8 * gm[0].real - gamma).max())
    log(f"phase 9a greens sum rules: |w G+ - (2 - gamma)|={err_p:.3e} "
        f"|w G- - gamma|={err_m:.3e} seconds={t_g:.3f} peak_gb={m_g:.3f}")
    if err_p > 1e-5 or err_m > 1e-5:
        raise AssertionError("the Green's function misses its sum rules")

    # (ii) each FCIDUMP.natorb as 6b's HCI + PT deck
    for use_pt, job in reruns.items():
        text, sec, _ = _finish_cli(job)
        secs["on_natorb" + ("_pt" if use_pt else "_no_pt")] = sec
        tot, err = _tot_and_err(text)
        gate = max(5 * np.hypot(err, e_err), 2e-3)
        log(f"phase 9a natorb use_pt={use_pt}: e_var="
            f"{_grab(text, 'Variational energy='):.9f} e_var_plus_pt={tot:.9f} "
            f"vs_deck_mHa={1e3 * (tot - e_tot):.4f} gate_mHa={1e3 * gate:.4f}")
        if abs(tot - e_tot) > gate:
            raise AssertionError("HCI + PT in the natural orbitals is not "
                                 "within max(5 sigma, 2 mHa) of the deck")
    log(f"phase 9a c2 decks: e_var={e_var:.9f} e_var_plus_pt={e_tot:.9f} "
        f"e_var_active={e_act:.9f} seconds={secs} launches="
        f"{dict(natorb_greens=c_a, natorb_pt=c_c)}")
    return e_var


def phase_cas_anchor(dev, workdir, fcidump):
    """9a (iv): CAS(4e,12o) of the synthetic file by the frozen-core fold;
    HCI at eps_var -> 0 selects the whole HF symmetry sector and equals a
    dense eigh of that sector on the card; MP2 of the 26-orbital system."""
    from itertools import combinations
    import numpy as np
    import torch
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
    from sqmc_tpu_torch.ops import setalg
    from sqmc_tpu_torch.systems.base import make_chem_system
    from sqmc_tpu_torch.systems.chem.cas import write_cas_fcidump
    from sqmc_tpu_torch.systems.chem.mp2 import mp2_deterministic

    t0 = time.time()
    cas_path = os.path.join(workdir, "FCIDUMP_cas_4e12o")
    info = write_cas_fcidump(fcidump, CAS_CORE, CAS_ACT, cas_path)
    s = make_chem_system(cas_path, point_group="d2h", device=dev)
    res = run_hci(s, eps_var=1e-14, eps_var_sched=[1e-14], verbose=False)
    t_hci = time.time() - t0
    norb, nup, ndn = s.norb, s.nup, s.ndn
    ups = torch.as_tensor(np.stack([dets.det_from_orbs(o, norb) for o in
                                    combinations(range(norb), nup)]),
                          device=dev)
    dns = torch.as_tensor(np.stack([dets.det_from_orbs(o, norb) for o in
                                    combinations(range(norb), ndn)]),
                          device=dev)
    up = ups.repeat_interleave(len(dns), dim=0)
    dn = dns.repeat(len(ups), 1)
    irrep = s.orb_sym_arr.to(torch.int64) - 1

    def det_irrep(bu, bd):
        occ = (bu + bd).to(torch.int64) % 2          # doubly occupied cancel
        out = torch.zeros(len(bu), dtype=torch.int64, device=dev)
        for p in range(norb):
            out ^= occ[:, p] * irrep[p]
        return out
    sector = det_irrep(dets.to_bits(up, norb), dets.to_bits(dn, norb))
    hf = det_irrep(*(dets.to_bits(torch.as_tensor(w[None], device=dev), norb)
                     for w in (s.hf_up, s.hf_dn)))
    keep = sector == hf
    up, dn = up[keep], dn[keep]
    o = setalg.lexsort_dets(up, dn)
    up, dn = up[o], dn[o]
    t1 = time.time()
    H = build_sparse_ham(s.table, up, dn, nup, ndn, norb).dense()
    e_eigh = float(torch.linalg.eigvalsh(H)[0])
    torch.cuda.synchronize(dev)
    t_eigh = time.time() - t1
    same = len(up) == len(res.up) and bool((up == res.up).all()
                                           and (dn == res.dn).all())
    t2 = time.time()
    plain = make_chem_system(fcidump, point_group="d2h", device=dev)
    e_mp2, _ = mp2_deterministic(plain)
    t_mp2 = time.time() - t2
    log(f"phase 9a cas anchor: CAS({info['nelec']}e,{info['norb']}o) "
        f"space={len(ups) * len(dns)} sector={len(up)} hci_ndets="
        f"{len(res.up)} same_dets={same} e_hci={res.energies[0]:.12f} "
        f"e_eigh={e_eigh:.12f} diff={res.energies[0] - e_eigh:.3e} "
        f"hci_seconds={t_hci:.2f} eigh_seconds={t_eigh:.2f}; mp2 of the "
        f"26-orbital system={e_mp2:.12f} ({t_mp2:.2f} s)")
    if len(ups) * len(dns) != 4356 or not same \
            or abs(res.energies[0] - e_eigh) > 1e-8:
        raise AssertionError("HCI at eps_var -> 0 on the CAS is not the "
                             "sector's exact energy")
    if not (np.isfinite(e_mp2) and e_mp2 < 0):
        raise AssertionError("MP2 of the synthetic system is not negative")


def phase_lanczos_full(dev, e_var_hci):
    """9b: hubbard_lanczos_full on the 4x4 periodic real-space cluster
    (5 + 5, U/t = 4, 19,079,424 dets), matrix-free on the card from a
    seeded random start (a single det can miss the ground state's sector);
    |E - HUB_E0| < 1e-4 and E <= the HCI E_var of 7a's system."""
    import contextlib
    import io
    import torch
    from sqmc_tpu_torch.algo import legacy_ci as L
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_real_system

    s = make_hubbard_real_system(*HUB, pbc=True, device=dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (e, vec, up, dn), sec, peak = _timed(lambda: L.hubbard_lanczos_full(
            s, iters=LANCZOS_ITERS, tol=LANCZOS_TOL, verbose=True,
            random_start=True), dev)
    its = buf.getvalue().strip().splitlines()
    diag = L._diag_elements(s, up, dn)
    hv, t_apply, m_apply = _timed(lambda: L.apply_h_on_the_fly(
        s, up, dn, vec, diag=diag), dev)
    resid = float(torch.linalg.norm(hv - e * vec))
    log(f"phase 9b lanczos full: dets={len(up)} iterations={len(its)} "
        f"e={e:.10f} vs_oracle={e - HUB_E0:.3e} residual={resid:.3e} "
        f"seconds={sec:.2f} seconds_per_h_application={t_apply:.3f} "
        f"apply_peak_gb={m_apply:.3f} peak_gb={peak:.3f} [{nvidia_smi_line()}]")
    log(f"phase 9b the cluster's exact energy {e:.10f}: 7a's HCI e_var "
        f"{HUB_RESULTS.get('e_var', e_var_hci):.9f}, 7a's e_var + pt "
        f"{HUB_RESULTS.get('e_tot', float('nan')):.9f}, the oracle of 7a "
        f"and 8d {HUB_E0}")
    if len(up) != 19_079_424 or abs(e - HUB_E0) > 1e-4 or e > e_var_hci:
        raise AssertionError("the full-space Lanczos missed the 4x4 "
                             "cluster's exact energy")
    return e


def start_legacy_decks(workdir):
    """Start 9c's selected_ci and trunc_lanc decks together."""
    return {run_type: _start_cli(f"9c_hubbardk_{run_type}",
                                 HUBK_LEGACY_DECK.format(
                                     run_type=run_type, iters=iters,
                                     n_trunc=LEGACY_NTRUNC), workdir)
            for run_type, iters in LEGACY_ITERS.items()}


def phase_legacy_ci(dev, jobs):
    """9c and 9b: 7a's HCI list under the matrix-free Lanczos, the full
    space, then the selected_ci and trunc_lanc decks through the CLI
    (`jobs`, from start_legacy_decks; they ran beside 9a)."""
    import torch
    from sqmc_tpu_torch.algo import legacy_ci as L
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system

    s = make_hubbard_k_system(*HUB, device=dev)
    t0 = time.time()
    res = run_hci(s, eps_var=1e-3, eps_var_sched=[2e-3, 2e-3, 1e-3],
                  verbose=False)
    t_hci = time.time() - t0
    (e_l, _), t_l, _ = _timed(lambda: L.matrix_lanczos_on_the_fly(
        s, res.up, res.dn, iters=300, tol=1e-12), dev)
    log(f"phase 9c lanczos on the HCI list: ndets={len(res.up)} "
        f"e_davidson={res.energies[0]:.12f} e_lanczos={e_l:.12f} "
        f"diff={e_l - res.energies[0]:.3e} hci_seconds={t_hci:.2f} "
        f"lanczos_seconds={t_l:.2f}")
    if abs(e_l - res.energies[0]) > 1e-8:
        raise AssertionError("the matrix-free Lanczos disagrees with the COO "
                             "Davidson on the HCI list")
    done = {k: _finish_cli(job) for k, job in jobs.items()}
    e_exact = phase_lanczos_full(dev, float(res.energies[0]))
    e_hf = float(L._diag_elements(s, torch.as_tensor(s.hf_up[None], device=dev),
                                  torch.as_tensor(s.hf_dn[None], device=dev))[0])
    for run_type, iters in LEGACY_ITERS.items():
        text, sec, c = done[run_type]
        if run_type == "selected_ci":
            e = _grab(text, r"Selected CI energy=")
            its = _grab(text, r"selected_ci iter \d+: ndet=\d+ E=", every=True)
            ok = len(its) == iters and e < its[0]
        else:
            e = _grab(text, r"Truncated Lanczos energy=")
            its = _grab(text, r"trunc_lanc iter \d+: ndet=\d+ E=", every=True)
            ok = e < e_hf
        log(f"phase 9c {run_type} cli: e={e:.9f} per_iteration={its} "
            f"vs_exact_mHa={1e3 * (e - e_exact):.4f} e_hf={e_hf:.9f} "
            f"seconds={sec:.2f} launches={c}")
        if e < e_exact - 1e-9 or not ok:
            raise AssertionError(f"{run_type} broke its variational or "
                                 "progress gate")
    return e_exact


def phase_legacy(dev):
    """Phase 9: the CLI decks of 9a and 9c start together; 9a's CAS anchor
    and in-process checks run beside them; then 9c with 9b inside it, with
    no deck left running.  Every in-process path's kernel counts are set
    to 0 just before it and read just after, summed into COUNTS9."""
    import shutil
    workdir = os.path.join(HERE, "build", "smoke_phase9")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    fcidump = os.path.join(workdir, "FCIDUMP_c2_synthetic")
    write_c2_fcidump(fcidump)
    t0 = time.time()
    try:
        c2_jobs = start_c2_decks(workdir, fcidump)
        legacy_jobs = start_legacy_decks(workdir)
        phase_cas_anchor(dev, workdir, fcidump)
        t1 = time.time()
        phase_c2_observables(dev, workdir, fcidump, c2_jobs)
        t2 = time.time()
        phase_legacy_ci(dev, legacy_jobs)
    finally:
        _stop_cli_jobs()
    log(f"phase 9 launches: {COUNTS9}")
    log(f"phase 9 stages: 9a_cas={t1 - t0:.2f} 9a_decks_and_observables="
        f"{t2 - t1:.2f} 9bc={time.time() - t2:.2f} seconds")


# ---------------------------------------------------------------------------
# Phase 10: the mesh (parallel/dist.py) on one card
# ---------------------------------------------------------------------------

COUNTS10 = dict.fromkeys(KERNELS, 0)  # phase 10's launches, path by path
MESH_RANKS = 2                        # 10b-10e: gloo ranks, both on cuda:0
# phase 3's global cell split over the ranks: per-rank mwalk and cap_spawn
# (each rank's spawn buckets then hold cap_spawn / ranks rows)
MESH_MWALK, MESH_CAP = 458_752 // MESH_RANKS, 262_144 // MESH_RANKS
MESH_EQ, MESH_F32_BLK, MESH_F64_BLK = 1, 4, 3   # blocks of NSTEP generations
MESH_UNIQ_N = 2_000_000               # 10e's candidates


def _heg14_walk_cfg(system, **extra):
    """Phase 3's walk knobs (f32 state), with `extra` on top."""
    from sqmc_tpu_torch.algo.walk import WalkConfig
    kw = dict(mwalk=458_752, cap_spawn=262_144, norb=system.norb,
              nup=system.nup, ndn=system.ndn, n_words=system.n_words,
              tau=2e-3, w_abs_target=W_TARGET, spawn_granularity=2.0,
              min_wt=0.5, r_initiator=0.5, f32_state=True, proj_bf16=False,
              has_singles=False)
    kw.update(extra)
    return WalkConfig(**kw)


def _gate_heg14(tag, out):
    """Phase 3's gates on a HEG-14 walk: finite, no overflow or growth,
    population within 10%, |e_mixed - oracle| < max(5 sigma, 0.3 mHa)."""
    return _gate_walk(tag, out, W_TARGET, ORACLE, 3e-4)


def _pt_pair(system, res, mesh):
    """Deterministic PT at phase 4's eps_pt and the semistochastic
    difference at phase 4's knobs over `mesh` (None: serial): (pt,
    n_connected, pt_diff, n_samples)."""
    from sqmc_tpu_torch.algo.pt import second_order_pt, second_order_pt_alias
    e_var = float(res.energies[0])
    pt, nconn = second_order_pt(system, res.up, res.dn, res.wts[:, 0], e_var,
                                EPS_PT, verbose=False, mesh=mesh)
    ss = second_order_pt_alias(system, res.up, res.dn, res.wts[:, 0], e_var,
                               EPS_PT, EPS_PT_BIG, N_MC, PT_TARGET,
                               pt_big=0.0, seed=0, verbose=False, mesh=mesh)
    return pt, nconn, ss.pt_diff, ss.n_samples


def _mesh_shci(system, mesh):
    """run_hci over the mesh at phase 3's eps_var, then _pt_pair on it."""
    from sqmc_tpu_torch.algo.hci import run_hci
    res = run_hci(system, eps_var=EPS_VAR, eps_var_sched=[EPS_VAR] * 10,
                  verbose=False, mesh=mesh)
    return res, _pt_pair(system, res, mesh)


def _gate_hci_pt(tag, up, dn, e_var, pts, ref):
    """10c: the serial dets, E_var within 1e-6 of the golden and 1e-10 of
    the serial port, deterministic PT within 1e-12 relative with the
    same connection count, pt_diff within 1e-12 with the same sample
    count."""
    import numpy as np
    pt, nconn, diff, ns = pts
    log(f"phase 10c {tag}: ndets={len(up)} e_var={e_var:.12f} "
        f"d_e_var_serial={e_var - ref['e_var']:.3e} pt={pt:.15f} "
        f"rel_d_pt={(pt - ref['pt']) / abs(ref['pt']):.3e} n_connected={nconn} "
        f"pt_diff={diff:.15e} d_pt_diff={diff - ref['diff']:.3e} "
        f"samples={ns}")
    if not (np.array_equal(np.asarray(up), ref["up"])
            and np.array_equal(np.asarray(dn), ref["dn"])):
        raise AssertionError(f"10c {tag}: dets differ from the serial HCI")
    if abs(e_var - GOLD_EVAR) > 1e-6 or abs(e_var - ref["e_var"]) > 1e-10:
        raise AssertionError(f"10c {tag}: E_var {e_var:.12f}")
    if abs(pt - ref["pt"]) > 1e-12 * abs(ref["pt"]) or nconn != ref["nconn"]:
        raise AssertionError(f"10c {tag}: deterministic PT off serial")
    if abs(diff - ref["diff"]) > 1e-12 or ns != ref["ns"]:
        raise AssertionError(f"10c {tag}: semistochastic PT off serial")


def _walkers(state):
    """A walk's occupied walkers and control scalars as host arrays (the
    warm start of _warm_state)."""
    import numpy as np
    n = int(state.nwalk)
    return dict(up=state.up[:n].cpu().numpy(), dn=state.dn[:n].cpu().numpy(),
                wt=state.wt[:n].double().cpu().numpy(),
                imp=state.imp[:n].cpu().numpy(),
                init=state.init[:n].cpu().numpy(),
                diag=state.diag[:n].double().cpu().numpy(),
                ct=state.ct[:n].cpu().numpy().astype(np.int32),
                e_trial=float(state.e_trial), e_est=float(state.e_est),
                reweight=float(state.reweight_factor_inv),
                w_abs=float(state.w_abs_gen))


def _warm_state(state, walkers, cfg, mesh):
    """This rank's share of 10a's equilibrated walkers (sharded by owner,
    with their diagonal elements and C(T) indices) and 10a's control
    scalars, in place of make_sharded_walk's initial population."""
    import torch
    from sqmc_tpu_torch.algo.walk import DIAG_UNKNOWN
    from sqmc_tpu_torch.parallel.dist import shard_initial_state
    r, dev = mesh.rank, mesh.device
    w = walkers
    s_up, s_dn, s_wt, s_imp, s_init, counts = shard_initial_state(
        w["up"], w["dn"], w["wt"], w["imp"], w["init"], mesh.size, cfg.mwalk)
    # the same layout again, carrying diag and the C(T) index
    _, _, s_diag, _, s_ct, _ = shard_initial_state(
        w["up"], w["dn"], w["diag"], w["imp"], w["ct"], mesh.size, cfg.mwalk)
    n = int(counts[r])
    live = torch.arange(cfg.mwalk, device=dev) < n
    sdt = torch.float32 if cfg.f32_state else torch.float64
    t = lambda x, dt=None: torch.as_tensor(x, device=dev, dtype=dt)  # noqa
    return state._replace(
        up=t(s_up[r]), dn=t(s_dn[r]), wt=t(s_wt[r], sdt), imp=t(s_imp[r]),
        init=t(s_init[r]), nwalk=t(n, torch.int32),
        diag=torch.where(live, t(s_diag[r], sdt), DIAG_UNKNOWN),
        ct=torch.where(live, t(s_ct[r], torch.int64), -1),
        e_trial=t(walkers["e_trial"], torch.float64),
        e_est=t(walkers["e_est"], torch.float64),
        tau=t(cfg.tau, torch.float64),
        reweight_factor_inv=t(walkers["reweight"], torch.float64),
        reached_target=t(True), w_abs_gen=t(walkers["w_abs"], torch.float64))


def _mesh_ranks(mesh, walkers, ref, fcidump):
    """10b-10e on one gloo rank (every rank on cuda:0; rank 0 prints).
    Returns each path's kernel counts and numbers."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import run_walk
    from sqmc_tpu_torch.ops import setalg
    from sqmc_tpu_torch.parallel import dist
    from sqmc_tpu_torch.parallel.dryrun import dryrun_rank
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    say = log if mesh.rank == 0 else (lambda msg: None)
    dev = mesh.device
    counts = dict.fromkeys(KERNELS, 0)
    out = dict(transport=mesh.transport)
    system = make_heg_system(*HEG, device=dev)
    res = run_hci(system, eps_var=EPS_VAR, eps_var_sched=[EPS_VAR] * 10,
                  verbose=False)
    trial = build_trial_wavefunction(system, eps_var=EPS_VAR, n_psi_t=2000,
                                     n_imp=20000)

    # 10b: the sharded walk, float32 (dense row slices) and float64 (K2)
    for tag, f32, nblk in (("f32", True, MESH_F32_BLK),
                           ("f64", False, MESH_F64_BLK)):
        cfg = _heg14_walk_cfg(system, mwalk=MESH_MWALK, cap_spawn=MESH_CAP,
                              f32_state=f32, axis_name="d", n_dev=mesh.size)
        _, st0, tables = dist.make_sharded_walk(
            system, trial, cfg, mesh, W_TARGET, walkers["e_trial"])
        state = _warm_state(st0, walkers, cfg, mesh)
        t0 = time.time()
        walk, c = _counted(lambda: run_walk(
            system, trial, cfg, nstep=NSTEP, nblk=nblk, nblk_eq=MESH_EQ,
            w_abs_begin=W_TARGET, e_trial_initial=walkers["e_trial"],
            verbose=False, max_eq_extensions=0, tables=tables, state=state,
            seed=4), counts)
        torch.cuda.synchronize(dev)
        secs = time.time() - t0
        # one exchange: cap_spawn rows x 6 int64 columns (up, dn, wt, imp,
        # init, valid) to and from every rank, whatever their fill
        buf = torch.zeros((cfg.cap_spawn, 6), dtype=torch.int64, device=dev)
        mesh.all_to_all(buf)
        torch.cuda.synchronize(dev)
        t1 = time.time()
        for _ in range(20):
            mesh.all_to_all(buf)
        torch.cuda.synchronize(dev)
        ms_x = (time.time() - t1) / 20 * 1e3
        nw = [int(x) for x in mesh.all_gather(
            walk.state.nwalk.reshape(1).to(torch.int64)).tolist()]
        pop, dev_, gate = _gate_heg14(f"10b {tag}", walk)
        out[tag] = dict(e=walk.e_mixed, err=walk.e_err, gens=walk.n_measured,
                        gen_s=walk.steps_per_sec, secs=secs, nwalk=nw,
                        bytes_gen=buf.numel() * 8, ms_x=ms_x, counts=c)
        say(f"phase 10b {tag} walk: ranks={mesh.size} transport="
            f"{mesh.transport} per_rank mwalk={cfg.mwalk} cap_spawn="
            f"{cfg.cap_spawn} bucket={cfg.cap_spawn // mesh.size} "
            f"measured_gens={walk.n_measured} gen_per_s="
            f"{walk.steps_per_sec:.3f} seconds={secs:.1f} nwalk_per_rank={nw} "
            f"pop={pop:.1f} e_mixed={walk.e_mixed:.9f} +- {walk.e_err:.9f} "
            f"bias_mHa={1e3 * dev_:.4f} gate_mHa={1e3 * gate:.4f} "
            f"bytes_routed_per_gen_per_rank={buf.numel() * 8} "
            f"ms_per_exchange={ms_x:.3f} launches={c}")

    # 10c: SHCI over the mesh
    t0 = time.time()
    (mres, pts), c = _counted(lambda: _mesh_shci(system, mesh), counts)
    out["10c"] = dict(up=mres.up.cpu().numpy(), dn=mres.dn.cpu().numpy(),
                      e_var=float(mres.energies[0]), pts=pts, counts=c,
                      secs=time.time() - t0)
    say(f"phase 10c {mesh.size} ranks: seconds={time.time() - t0:.2f} "
        f"launches={c}")

    # 10e: distributed dedup of ~2M candidates with duplicates
    rng = np.random.default_rng(10)
    pool = rng.integers(-(1 << 63), (1 << 63) - 1, (MESH_UNIQ_N // 3, 2),
                        dtype=np.int64)
    pick = pool[rng.integers(0, len(pool), MESH_UNIQ_N)]
    up, dn = (torch.as_tensor(pick[:, k:k + 1], device=dev) for k in (0, 1))
    torch.cuda.synchronize(dev)
    t0 = time.time()
    u, d = dist.sharded_unique_dets(mesh, up, dn)
    torch.cuda.synchronize(dev)
    t_sh = time.time() - t0
    t0 = time.time()
    ru, rd, _, _ = setalg.unique_dets(up, dn)
    torch.cuda.synchronize(dev)
    t_ser = time.time() - t0
    same = bool(torch.equal(u, ru) and torch.equal(d, rd))
    out["10e"] = dict(n=MESH_UNIQ_N, n_unique=len(ru), same=same,
                      secs=t_sh, serial_secs=t_ser)
    say(f"phase 10e sharded_unique_dets: candidates={MESH_UNIQ_N} "
        f"unique={len(ru)} equal_to_unique_dets={same} seconds={t_sh:.3f} "
        f"serial_seconds={t_ser:.3f}")
    if not same:
        raise AssertionError("10e: sharded_unique_dets != unique_dets")

    # 10d: the dry run against its golden
    t0 = time.time()
    dry, c = _counted(lambda: dryrun_rank(mesh, fcidump), counts)
    out["10d"] = dict(dry, secs=time.time() - t0, counts=c)
    say(f"phase 10d dryrun({mesh.size}): e_mixed={dry['e_mixed']:.6f} +- "
        f"{dry['e_err']:.6f} sigma={dry['sigma']:.2f} nwalk={dry['nwalk']} "
        f"seconds={time.time() - t0:.1f} launches={c}")
    out["counts"] = counts
    return out


def phase_mesh(dev, system=None, res=None, trial=None, warm=None):
    """Phase 10: 10a the HEG-14 cell through make_sharded_walk on a world
    of one NCCL rank (from its initial population with phase 3's depth,
    or, in the whole smoke, warm-started from phase 3's walkers `warm`
    with 10b's depth); 10c's one-rank run (NCCL) of run_hci and PT over
    the mesh against the serial port; then a world of two gloo ranks on
    this card (NCCL refuses two ranks on one device) for 10b (the sharded
    walk, f32 and f64, warm-started from 10a's walkers), 10c at two ranks,
    10e (the distributed dedup) and 10d (the dry run).  Kernel counts are
    set to 0 around each path, in every rank, and summed into COUNTS10."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import run_walk
    from sqmc_tpu_torch.parallel import dist
    from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    t_start = time.time()
    if system is None:
        system = make_heg_system(*HEG, device=dev)
        res = run_hci(system, eps_var=EPS_VAR, eps_var_sched=[EPS_VAR] * 10,
                      verbose=False)
        trial = build_trial_wavefunction(system, eps_var=EPS_VAR,
                                         n_psi_t=2000, n_imp=20000)
    mesh = dist.make_mesh(dev, backend="nccl")
    try:
        # 10a: one NCCL rank at full width
        cfg = _heg14_walk_cfg(system, axis_name="d", n_dev=1)
        _, state, tables = dist.make_sharded_walk(system, trial, cfg, mesh,
                                                  W_BEGIN, trial.e_trial)
        nblk, nblk_eq = NBLK, NBLK_EQ
        if warm is not None:
            state = _warm_state(state, warm, cfg, mesh)
            nblk, nblk_eq = MESH_F32_BLK, MESH_EQ
        t0 = time.time()
        out, c = _counted(lambda: run_walk(
            system, trial, cfg, nstep=NSTEP, nblk=nblk, nblk_eq=nblk_eq,
            w_abs_begin=W_BEGIN, e_trial_initial=trial.e_trial,
            verbose=False, max_eq_extensions=2, tables=tables, state=state,
            seed=1), COUNTS10)
        torch.cuda.synchronize(dev)
        pop, dev_, gate = _gate_heg14("10a", out)
        log(f"phase 10a sharded walk: ranks=1 transport={mesh.transport} "
            f"warm_start={warm is not None} "
            f"measured_gens={out.n_measured} gen_per_s="
            f"{out.steps_per_sec:.3f} seconds={time.time() - t0:.1f} "
            f"nwalk={int(out.state.nwalk)} pop={pop:.1f} "
            f"e_mixed={out.e_mixed:.9f} +- {out.e_err:.9f} "
            f"bias_mHa={1e3 * dev_:.4f} gate_mHa={1e3 * gate:.4f} "
            f"launches={c}")
        _need("10a", c, "seg_scan", "hb_spawn", "slot_parents")
        walkers = _walkers(out.state)

        # 10c: serial references, then one NCCL rank
        t0 = time.time()
        pt, nconn, diff, ns = _pt_pair(system, res, None)
        ref = dict(up=res.up.cpu().numpy(), dn=res.dn.cpu().numpy(),
                   e_var=float(res.energies[0]), pt=pt, nconn=nconn,
                   diff=diff, ns=ns)
        t_ser = time.time() - t0
        t0 = time.time()
        (mres, pts), c = _counted(lambda: _mesh_shci(system, mesh), COUNTS10)
        torch.cuda.synchronize(dev)
        _gate_hci_pt("1 rank nccl", mres.up.cpu().numpy(),
                     mres.dn.cpu().numpy(), float(mres.energies[0]), pts, ref)
        log(f"phase 10c 1 rank: serial_pt_seconds={t_ser:.2f} mesh_seconds="
            f"{time.time() - t0:.2f} launches={c}")
        if c["spmv"] <= 0:
            raise AssertionError("10c never launched the SpMV kernel")
    finally:
        mesh.close()

    workdir = os.path.join(HERE, "build", "smoke_phase10")
    os.makedirs(workdir, exist_ok=True)
    fcidump = os.path.join(workdir, "FCIDUMP_c2_synthetic")
    write_c2_fcidump(fcidump)
    t0 = time.time()
    outs = dist.spawn(_mesh_ranks, MESH_RANKS, backend="gloo", device=dev,
                      args=(walkers, ref, fcidump), timeout=900)
    t_ranks = time.time() - t0
    o = outs[0]
    for r, x in enumerate(outs):
        _gate_hci_pt(f"{MESH_RANKS} ranks gloo (rank {r})", x["10c"]["up"],
                     x["10c"]["dn"], x["10c"]["e_var"], x["10c"]["pts"], ref)
        for k in COUNTS10:
            COUNTS10[k] += x["counts"][k]
    for tag in ("f32", "f64"):
        if o[tag]["counts"]["seg_scan"] <= 0:
            raise AssertionError(f"10b {tag} never launched the seg-scan kernel")
    if o["f64"]["counts"]["spmv"] <= 0 or o["10c"]["counts"]["spmv"] <= 0:
        raise AssertionError("10b f64 / 10c never launched the SpMV kernel")
    log(f"phase 10 stages: ranks_seconds={t_ranks:.1f} (10b f32 "
        f"{o['f32']['secs']:.1f}, f64 {o['f64']['secs']:.1f}, 10c "
        f"{o['10c']['secs']:.1f}, 10e {o['10e']['secs']:.1f}, 10d "
        f"{o['10d']['secs']:.1f}) total_seconds={time.time() - t_start:.1f} "
        f"launches={COUNTS10}")


# ---------------------------------------------------------------------------
# Phase 11: the port's bench, entry() and the proposals' walks
# ---------------------------------------------------------------------------

COUNTS11 = dict.fromkeys(KERNELS, 0)  # phase 11's launches, path by path
PROPOSAL_NBLK_EQ, PROPOSAL_NBLK = 4, 4    # 11c's blocks of 100 generations
# 11c departs from the bench's knobs in two (both seen on an NVIDIA H100
# 80GB HBM3 at the bench's knobs): the two proposals' walks occupy 1.35-1.5
# dets per unit |w| (the heat-bath walk 1.23) and overshot to 5.0e5
# occupied dets in their first block, so the walker and spawn capacities
# are run_walk's first growth (2x) from the start; and at the default
# pop_ctrl_exponent (10) their spawn noise held |w| at 1.37x
# (Cauchy-Schwarz) and 1.72x (uniform) the target, so the population is
# controlled at the reference's population_control_expon 100
PROPOSAL_KNOBS = dict(mwalk=917_504, cap_spawn=524_288,
                      pop_ctrl_exponent=100.0)


def phase_bench(dev, smi):
    """11a: ``sqmc_tpu_torch.bench.run`` at bench.py's knobs (the
    synthetic C2-shaped file, plain dets, heat-bath with singles,
    population 2e5, 12 + 30 blocks of 100 generations);
    gates: no capacity growth, the population within 10% of 2e5,
    |e_mixed - ORACLE_E0| < max(5 sigma, 2 mHa), K1, K3 and K4 launched."""
    from sqmc_tpu_torch import bench
    t0 = time.time()
    rec, c = _counted(lambda: bench.run(dev), COUNTS11)
    secs = time.time() - t0
    log("phase 11a bench record: " + json.dumps(rec))
    gate = max(5 * rec["e_err"], 2e-3)
    log(f"phase 11a bench: gen_per_s={rec['gen_per_sec']:.3f} "
        f"walker_steps_per_s={rec['value']:.6g} e_mixed={rec['e_mixed']:.9f} "
        f"+- {rec['e_err']:.9f} bias_mHa={rec['bias_mHa']:.4f} gate_mHa="
        f"{1e3 * gate:.4f} pop={rec['pop']:.1f} capacity_grows="
        f"{rec['config']['capacity_grows']} max_abs_spawn_weight_below="
        f"{rec['max_abs_spawn_weight_below']:g} launches={c} "
        f"seconds={secs:.1f} [{smi}]")
    if rec["config"]["capacity_grows"]:
        raise AssertionError("11a: capacity growth in the bench walk")
    if abs(rec["pop"] - 2e5) > 2e4:
        raise AssertionError(f"11a: population {rec['pop']:.0f} not within "
                             "10% of 2e5")
    if not abs(rec["e_mixed"] - bench.ORACLE_E0) < gate:
        raise AssertionError(f"11a: |e_mixed - oracle| = "
                             f"{abs(rec['bias_mHa']):.4f} mHa >= "
                             f"{1e3 * gate:.4f}")
    _need("phase 11a bench", c, "seg_scan", "hb_spawn", "slot_parents")
    return rec


def phase_entry(dev):
    """11b: ``sqmc_tpu_torch.entry.entry()``'s fn called 10 times on the
    card: finite outputs, K1-K4 launched; one more call under
    torch.cuda's sync debug mode lists where it waits for the card."""
    import warnings
    import torch
    from sqmc_tpu_torch.entry import entry
    t0 = time.time()
    fn, (state, tables) = entry(dev)
    fn(state, tables)                  # warm-up
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    _reset_counts()
    t1 = time.time()
    outs = [fn(state, tables) for _ in range(10)]
    torch.cuda.synchronize()
    t_calls = time.time() - t1
    c = _read_counts()
    for k in KERNELS:
        COUNTS11[k] += c[k]
    for wt, e_num, w_abs in outs:
        if not (bool(torch.isfinite(wt).all()) and bool(torch.isfinite(e_num))
                and bool(torch.isfinite(w_abs)) and float(w_abs) > 0):
            raise AssertionError("11b: non-finite entry() output")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(state, tables)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = sorted({f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                    for w in caught if "synchroniz" in str(w.message)})
    n_sync = sum("synchroniz" in str(w.message) for w in caught)
    log(f"phase 11b entry: calls=10 setup_seconds={t_setup:.2f} "
        f"ms_per_call={1e3 * t_calls / 10:.3f} w_abs={float(outs[-1][2]):.1f} "
        f"host_syncs_per_call={n_sync} sync_sites={sites} launches={c}")
    _need("phase 11b entry", c, *F64_WALK)


def phase_proposal_walks(dev, hb_rec):
    """11c: the uniform / Cauchy-Schwarz proposals with singles on the
    synthetic file (plain dets, 2n = 52) at the bench's knobs but
    PROPOSAL_KNOBS, cut to PROPOSAL_NBLK_EQ + PROPOSAL_NBLK blocks of 100
    generations: no capacity growth, no measured block more than 20% off
    the population target, |e_mixed - ORACLE_E0| < max(5 sigma, 2 mHa);
    prints the largest
    |spawn weight| beside the heat-bath bench walk's (11a)."""
    import dataclasses
    import numpy as np
    from sqmc_tpu_torch import bench
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    system, trial, _, _ = bench.system_and_trial(dev, bench.WORKDIR,
                                                 **bench.TRIAL)
    base = WalkConfig(norb=system.norb, nup=system.nup, ndn=system.ndn,
                      n_words=system.n_words, **bench.WALK)
    for proposal in ("cauchy_schwarz", "uniform"):
        cfg = dataclasses.replace(base, proposal=proposal, **PROPOSAL_KNOBS)
        t0 = time.time()
        out, c = _counted(lambda: run_walk(
            system, trial, cfg, nstep=100, nblk=PROPOSAL_NBLK,
            nblk_eq=PROPOSAL_NBLK_EQ, w_abs_begin=bench.RUN["w_abs_begin"],
            e_trial_initial=trial.e_trial, verbose=False,
            max_eq_extensions=0, seed=11), COUNTS11)
        blocks = out.w_abs_trace[-out.n_measured:].reshape(-1, 100).mean(1)
        pop, dev_, gate = _gate_walk(f"11c {proposal}", out, 2e5,
                                     bench.ORACLE_E0, 2e-3)
        log(f"phase 11c {proposal} singles walk: measured_gens="
            f"{out.n_measured} gen_per_s={out.steps_per_sec:.3f} "
            f"pop={pop:.1f} block_w_abs={np.round(blocks, 1).tolist()} "
            f"e_mixed={out.e_mixed:.9f} +- {out.e_err:.9f} "
            f"vs_oracle_mHa={1e3 * dev_:.4f} gate_mHa={1e3 * gate:.4f} "
            f"max_abs_spawn_weight_below="
            f"{bench.spawn_weight_below(out.spawn_hist):g} (heat-bath 11a: "
            f"{hb_rec['max_abs_spawn_weight_below']:g}) launches={c} "
            f"seconds={time.time() - t0:.1f}")
        if np.abs(blocks / 2e5 - 1).max() > 0.2:
            raise AssertionError(f"11c {proposal}: population bursts, block "
                                 f"w_abs {blocks}")
        _need(f"phase 11c {proposal}", c, "seg_scan", "slot_parents")


def phase_bench_all(dev, smi):
    """Phase 11: 11a the bench, 11b entry(), 11c the proposals' walks."""
    t0 = time.time()
    rec = phase_bench(dev, smi)
    t1 = time.time()
    phase_entry(dev)
    t2 = time.time()
    phase_proposal_walks(dev, rec)
    log(f"phase 11 stages: 11a={t1 - t0:.1f} 11b={t2 - t1:.1f} "
        f"11c={time.time() - t2:.1f} seconds launches={COUNTS11} [{smi}]")


# ---------------------------------------------------------------------------
# Phase 12: the captured paths against their eager loops
# ---------------------------------------------------------------------------

COUNTS12 = dict.fromkeys(KERNELS, 0)  # phase 12's launches, both paths
GRAPH_GENS = 100                      # one block of each path, per cell
PROFILE_STEPS = 10                    # the profiled window of each path
RATES12 = {}                          # phase 12: tag -> {path: rate}


def _same_walk(tag, a, b, sa, sb):
    """Fail unless two states (NamedTuples: tensors compared bit for bit,
    host values by equality) and their stats are equal."""
    import torch
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            same = (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y))
        else:
            same = x == y
        if not same:
            raise AssertionError(f"12 {tag}: captured and eager paths "
                                 f"differ in state field {f}")
    for k in sa:
        if sa[k].dtype != sb[k].dtype or not torch.equal(sa[k], sb[k]):
            raise AssertionError(f"12 {tag}: captured and eager paths "
                                 f"differ in stat {k}")


def _timed_block(fn, n):
    """fn() (a block of n steps) timed: (its result, steps a wall second,
    ms a step between CUDA events around it)."""
    import torch
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
    ev0.record()
    t0 = time.perf_counter()
    out = fn()
    ev1.record()
    torch.cuda.synchronize()
    return out, n / (time.perf_counter() - t0), ev0.elapsed_time(ev1) / n


def _profiled(fn, n):
    """fn() (a block of n steps) under torch.profiler: (kernel ms a step,
    host launches a step), "not measured" where the profiler returned no
    such rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sqmc_tpu_torch.bench_walk import HOST_LAUNCHES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us, rows, host = 0.0, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_us += e.time_range.elapsed_us()
            rows += 1
        elif e.name.startswith(HOST_LAUNCHES):
            host += 1
    return (f"{dev_us / 1e3 / n:.4f}" if rows else "not_measured",
            f"{host / n:.2f}" if host else "not_measured")


def _path_cell(tag, unit, n, eager, graph, smi, counts_need=()):
    """One block of n steps through the eager loop and through the
    captured path, from one state and seed (the capture made beforehand by
    the caller): equal bit for bit (each fn returns (state, stats)), the
    same launch counts; then a window of PROFILE_STEPS steps of each under
    the profiler.  Prints both paths' rates, device ms a step (CUDA events
    around the block) and, from the profiles, kernel ms and host launches
    a step.  Returns the graph's (state, stats)."""
    out, rate, ev_ms, counts = {}, {}, {}, {}
    for mode, fn in (("eager", eager), ("graph", graph)):
        (out[mode], counts[mode]), rate[mode], ev_ms[mode] = _timed_block(
            lambda fn=fn: _counted(lambda: fn(n), COUNTS12), n)
    (a, sa), (b, sb) = out["eager"], out["graph"]
    _same_walk(tag, a, b, sa, sb)
    if counts["eager"] != counts["graph"]:
        raise AssertionError(f"12 {tag}: launches {counts}")
    prof = {m: _profiled(lambda fn=fn: fn(PROFILE_STEPS), PROFILE_STEPS)
            for m, fn in (("eager", eager), ("graph", graph))}
    log(f"phase 12 {tag}: steps={n} bitwise_equal=True "
        f"eager_{unit}_per_s={rate['eager']:.3f} "
        f"graph_{unit}_per_s={rate['graph']:.3f} "
        f"eager_device_ms_per_step={ev_ms['eager']:.4f} "
        f"graph_device_ms_per_step={ev_ms['graph']:.4f} "
        f"eager_kernel_ms_per_step={prof['eager'][0]} "
        f"graph_kernel_ms_per_step={prof['graph'][0]} "
        f"eager_host_launches_per_step={prof['eager'][1]} "
        f"graph_host_launches_per_step={prof['graph'][1]} "
        f"launches={counts['graph']} [{smi}]")
    _need(f"phase 12 {tag}", counts["graph"], *counts_need)
    RATES12[tag] = rate
    return b, sb


def _graph_vs_eager(tag, system, trial, cfg, w0, smi, need):
    """A walk: one block of GRAPH_GENS generations from one state and seed
    through the eager loop and through the captured generation (captured
    first, outside the timed block), _path_cell's checks and lines, the
    generators' states equal; prints the capture's seconds and memory pool
    and the graph's replays a generation.  Returns (tables, the graph's
    final state)."""
    import torch
    from sqmc_tpu_torch.algo import walk as W
    dev = trial.psit_coef.device
    tables = W.build_walk_tables(system, trial, cfg)
    st = W.init_walk_state(cfg, trial, w0, trial.e_trial, tables)
    gens = {m: torch.Generator(device=dev).manual_seed(12)
            for m in ("eager", "graph")}
    graph = W._step_graph(st, tables, cfg, gens["graph"], GRAPH_GENS)
    start = {"eager": st, "graph": st}

    def run(mode, block):
        def fn(n):
            out = block(start[mode], tables, cfg, n, gens[mode])
            start[mode] = out[0]        # the profiled window continues
            return out
        return fn
    b, sb = _path_cell(tag, "gen", GRAPH_GENS,
                       run("eager", W._walk_block_eager),
                       run("graph", W.walk_block), smi, need)
    if not torch.equal(gens["eager"].get_state(), gens["graph"].get_state()):
        raise AssertionError(f"12 {tag}: the generators' states differ")
    log(f"phase 12 {tag}: capture_seconds={graph.capture_seconds:.3f} "
        f"pool_MB={graph.pool_bytes / 2**20:.1f} replays={graph.replays} "
        f"(the block's and the profiled window's) "
        f"w_abs={float(sb['w_abs_gen'][-1]):.1f} [{smi}]")
    W.release_graphs()
    return tables, b


def _graph_dense(dev, smi):
    """12b: the dense engine.  8b's fictitious system (ndet 16,384,
    bosonic 0, the deck's seed 42) as release_node with importance
    sampling, released at generation 50 of the block (two graphs), and
    8c's 1x8 chain as fixed_node1 with its Gutzwiller guide."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.algo import densewalk as dw
    from sqmc_tpu_torch.algo.guiding import (eval_guiding,
                                             make_gutzwiller_guiding)
    from sqmc_tpu_torch.cli import _seed4
    from sqmc_tpu_torch.systems.hubbard.system import (
        enumerate_dets, make_hubbard_dense_system, make_hubbard_real_system)
    from sqmc_tpu_torch.systems.toy import make_fictitious_system

    def cell(tag, system, cfg, psi_t, psi_g, w0):
        tables = dw.build_dense_tables(system, cfg, psi_t, psi_g)
        v = torch.as_tensor(psi_t, dtype=torch.float64, device=dev)
        e_t = float(v @ (system.ham @ v) / (v @ v))
        st = dw.init_dense_state(cfg, psi_t, psi_g, w0, e_t, seed=12,
                                 device=dev)
        dw.dense_walk_block(st, tables, cfg, GRAPH_GENS)      # the captures
        start = {"eager": st, "graph": st}

        def run(mode, block):
            def fn(n):
                out = block(start[mode], tables, cfg, n)
                start[mode] = out[0]
                return out
            return fn
        _path_cell(tag, "gen", GRAPH_GENS,
                   run("eager", dw._dense_walk_block_eager),
                   run("graph", dw.dense_walk_block), smi)
        dw.release_graphs()

    s = make_fictitious_system(FICT_NDET, 0, 1.0, 0.5, 0.5, 0.5,
                               seed=_seed4(42), device=dev)
    psi_t = np.zeros(FICT_NDET)
    psi_t[0] = 1.0
    cell("12b_dense_fictitious_release_node", s, dw.DenseWalkConfig(
        ndet=FICT_NDET, tau=0.0039, w_abs_target=2e5, run_type="release_node",
        release_step=GRAPH_GENS // 2, importance_sampling=1,
        pop_ctrl_exponent=FICT_POP_CTRL), psi_t,
        np.full(FICT_NDET, 0.0078125), 2e5)
    del s
    torch.cuda.empty_cache()
    real = make_hubbard_real_system(1, 8, 1.0, 4.0, 2, 2, pbc=False,
                                    device=dev)
    toy = make_hubbard_dense_system(1, 8, 1.0, 4.0, 2, 2, pbc=False,
                                    device=dev)
    up, dn = (torch.as_tensor(x, device=dev) for x in enumerate_dets(8, 2, 2))
    g = eval_guiding(make_gutzwiller_guiding(real, g=0.7), "gutzwiller", up,
                     dn, 8, 2, 2)
    cell("12b_dense_chain_fixed_node1", toy, dw.DenseWalkConfig(
        ndet=toy.ndet, tau=0.02, w_abs_target=3000.0, run_type="fixed_node1",
        importance_sampling=1, min_wt=0.5), g, g, 1500.0)


def _graph_vmc(dev, smi):
    """12c: VMC on the 4x4 cluster (5 + 5, U/t = 4, 256 walkers, 10 steps a
    sweep, g = 0.7 as the `hubbard2` deck), one block of 50 sweeps."""
    import torch
    from sqmc_tpu_torch.systems.hubbard import meanfield, vmc
    pu, pd, _ = meanfield.hartree_fock(4, 4, 1.0, 4.0, 5, 5, True)
    st = vmc.init_vmc(pu, pd, 4, 4, 256, seed=12, device=dev)
    nbr = torch.as_tensor(vmc.neighbor_table(4, 4, True), dtype=torch.int64,
                          device=dev)
    args = (torch.as_tensor(pu, device=dev), torch.as_tensor(pd, device=dev),
            nbr, 0.7, 4.0, 1.0, 10, 16)
    vmc.vmc_sweep(st, *args)                                  # the capture
    start = {"eager": st, "graph": st}

    def run(mode, sweep):
        def fn(n):
            es = []
            for _ in range(n):
                start[mode], e_loc = sweep(start[mode], *args)
                es.append(e_loc)
            return start[mode], {"e_loc": torch.stack(es)}
        return fn
    _, stats = _path_cell("12c_vmc_4x4", "sweep", 50,
                          run("eager", vmc._vmc_sweep_eager),
                          run("graph", vmc.vmc_sweep), smi)
    log(f"phase 12 12c_vmc_4x4: e_vmc={float(stats['e_loc'].mean()):.6f} "
        f"[{smi}]")
    vmc.release_graphs()


def _graph_cpmc(dev, smi):
    """12d: CPMC on the same cluster (1,024 walkers, tau 0.05), one block of
    20 steps and its mixed-energy measurement."""
    from sqmc_tpu_torch.systems.hubbard import cpmc
    cfg = cpmc.CpmcConfig(4, 4, 1.0, 4.0, 5, 5, tau=0.05, n_walkers=1024)
    setup, st = cpmc.init_cpmc(cfg, seed=12, device=dev)
    cpmc.cpmc_block(st, setup, cfg, 20)                       # the capture
    start = {"eager": st, "graph": st}

    def run(mode, block):
        def fn(n):
            start[mode], e_mix = block(start[mode], setup, cfg, n)
            return start[mode], {"e_mix": e_mix}
        return fn
    _, stats = _path_cell("12d_cpmc_4x4", "step", 20,
                          run("eager", cpmc._cpmc_block_eager),
                          run("graph", cpmc.cpmc_block), smi)
    log(f"phase 12 12d_cpmc_4x4: e_mix={float(stats['e_mix']):.6f} "
        f"linalg_library={_cpmc_linalg_rows(cpmc, setup, cfg, st)} [{smi}]")
    cpmc.release_graphs()


def _cpmc_linalg_rows(cpmc, setup, cfg, st):
    """The factorization kernels of one eager CPMC step under the pinned
    library, by name (which library runs: cuBLAS / cuSOLVER or MAGMA)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cpmc._cpmc_block_eager(st, setup, cfg, 1)
    names = sorted({e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA and any(
                        k in e.name.lower() for k in (
                            "getrf", "potrf", "trsm", "getrs", "magma",
                            "lu_", "cholesky", "solve"))})
    return "|".join(n[:48] for n in names) or "not_measured"


def _seq_on_walk_rows(st, tables, cfg, ngen):
    """K5 on a walk's own merge rows: ngen eager generations from state st
    with K5's arguments recorded, then K5 on the last generation's rows
    against its plain version on the card, bit for bit, and its device
    time against its bound.  Launches made here are outside every counted
    run.  Returns the fields of the log line."""
    import torch
    from sqmc_tpu_torch.algo import walk as W
    from sqmc_tpu_torch.ops import seqinit
    dev = st.wt.device
    seen = []
    kernel = seqinit.sequential_initiator

    def spy(neq, s_wt, init_row):
        seen.append((neq.clone(), s_wt.clone(), init_row.clone()))
        return kernel(neq, s_wt, init_row)
    seqinit.sequential_initiator = spy
    try:
        W._walk_block_eager(st, tables, cfg, ngen,
                            torch.Generator(device=dev).manual_seed(3))
    finally:
        seqinit.sequential_initiator = kernel
    longest = []
    for args in seen:
        stats = {}
        ref = seqinit.sequential_initiator_plain(*args, stats=stats)
        longest.append((int(_longest_group(args[0])), stats["passes"] + 1))
    got = seqinit.sequential_initiator_cuda(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("seq_init on the walk's rows: differs from the "
                             "plain version")
    fn = (lambda: seqinit.sequential_initiator_cuda(*args))
    nbytes = _seq_bytes(args[0].shape[0], args[1].element_size(),
                        stats["active"])
    bound_us, bound_by = _bound_us(nbytes)
    dev_us = _device_us(fn)
    return (f"longest_group={max(x[0] for x in longest)} "
            f"longest_active_group={max(x[1] for x in longest)} "
            f"(last generation {longest[-1][0]} / {longest[-1][1]}) "
            f"rows={args[0].shape[0]} active_rows={stats['active']} "
            f"groups={int(args[0].sum())} match max_abs_err=0 "
            f"wrapper_ms={_median_ms(fn, reps=5, warm=1):.4f} "
            f"device_us={dev_us:.1f} bound_us={bound_us:.3f} "
            f"bound_by={bound_by} share={bound_us / dev_us:.4f}")


def _graph_sequential(dev, smi, system, trial):
    """12e: phase 3's HEG-14 f32 cell under initiator_rule="sequential"
    (K5 in every generation's merge), then three more eager generations
    from the graph's final state to read the longest merge group and the
    longest group of active rows, and to hold K5 on that generation's own
    rows to its plain version on the card, bit for bit, and time it
    (_seq_on_walk_rows)."""
    from sqmc_tpu_torch.algo.walk import WalkConfig
    tag = "12e_heg14_f32_sequential"
    cfg = WalkConfig(
        mwalk=458_752, cap_spawn=262_144, norb=system.norb, nup=system.nup,
        ndn=system.ndn, n_words=system.n_words, tau=2e-3,
        w_abs_target=W_TARGET, spawn_granularity=2.0, min_wt=0.5,
        r_initiator=0.5, f32_state=True, has_singles=False,
        initiator_rule="sequential")
    tables, st = _graph_vs_eager(tag, system, trial, cfg, W_BEGIN, smi,
                                 ("seg_scan", "hb_spawn", "slot_parents",
                                  "seq_init"))
    line = _seq_on_walk_rows(st, tables, cfg, 3)
    log(f"phase 12 {tag} seq_init on the walk's rows: {line} "
        f"graph_gen_per_s={RATES12[tag]['graph']:.3f} "
        f"group_max_graph_gen_per_s={RATES12['heg14_f32']['graph']:.3f} "
        f"[{smi}]")


def phase_graph(dev, smi, system=None, trial=None):
    """12: every captured path against its eager loop: the bench's walk and
    HEG-14's (phase 3's system and trial when given), the dense engine
    (12b), VMC (12c), CPMC (12d) and HEG-14 under the sequential initiator
    rule (12e)."""
    import torch
    from sqmc_tpu_torch import bench
    from sqmc_tpu_torch.algo.walk import WalkConfig
    t0 = time.time()
    walk_kernels = ("seg_scan", "hb_spawn", "slot_parents")
    bsys, btrial, _, _ = bench.system_and_trial(dev, bench.WORKDIR,
                                                **bench.TRIAL)
    _graph_vs_eager("bench", bsys, btrial,
                    WalkConfig(norb=bsys.norb, nup=bsys.nup, ndn=bsys.ndn,
                               n_words=bsys.n_words, **bench.WALK),
                    bench.RUN["w_abs_begin"], smi, walk_kernels)
    del bsys, btrial
    if system is None:
        from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
        from sqmc_tpu_torch.systems.heg.system import make_heg_system
        system = make_heg_system(*HEG, device=dev)
        trial = build_trial_wavefunction(system, eps_var=EPS_VAR,
                                         n_psi_t=2000, n_imp=20000)
        torch.cuda.synchronize()
    _graph_vs_eager("heg14_f32", system, trial, WalkConfig(
        mwalk=458_752, cap_spawn=262_144, norb=system.norb, nup=system.nup,
        ndn=system.ndn, n_words=system.n_words, tau=2e-3,
        w_abs_target=W_TARGET, spawn_granularity=2.0, min_wt=0.5,
        r_initiator=0.5, f32_state=True, has_singles=False), W_BEGIN, smi,
        walk_kernels)
    stamps = [time.time()]
    for cell in (_graph_dense, _graph_vmc, _graph_cpmc):
        cell(dev, smi)
        stamps.append(time.time())
    _graph_sequential(dev, smi, system, trial)
    stamps.append(time.time())
    log("phase 12 stages: " + " ".join(
        f"12{x}={b - a:.2f}" for x, a, b in zip("bcde", stamps, stamps[1:]))
        + " seconds")
    log(f"phase 12 seconds={time.time() - t0:.1f} launches={COUNTS12}")


def phase_build():
    """Every kernel source, one nvcc each, started together (K3b, hb_spawn,
    is built with K3: one source)."""
    from concurrent.futures import ThreadPoolExecutor
    mods = [m for k, m in _kernel_modules().items() if k != "hb_spawn"]
    t0 = time.time()
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = [ex.submit(mod.build) for mod in mods]
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
    if "--dense" in sys.argv[1:]:
        phase_dense(dev)
        raise SystemExit("chip_smoke: --dense ran phases 0, 1 and 8 only; "
                         "no result")
    if "--legacy" in sys.argv[1:]:
        phase_legacy(dev)
        raise SystemExit("chip_smoke: --legacy ran phases 0, 1 and 9 only; "
                         "no result")
    if "--mesh" in sys.argv[1:]:
        phase_mesh(dev)
        raise SystemExit("chip_smoke: --mesh ran phases 0, 1 and 10 only; "
                         "no result")
    if "--bench" in sys.argv[1:]:
        phase_bench_all(dev, smi)
        raise SystemExit("chip_smoke: --bench ran phases 0, 1 and 11 only; "
                         "no result")
    if "--graph" in sys.argv[1:]:
        phase_graph(dev, smi)
        raise SystemExit("chip_smoke: --graph ran phases 0, 1 and 12 only; "
                         "no result")
    seg = phase_kernel_vs_plain(dev)
    sp = phase_spmv_vs_plain(dev)
    hb, spawn, slot = phase_spawn_vs_plain(dev)
    seq = phase_seq_init_vs_plain(dev)
    kernel_us = phase_kernel_rows()
    seg["kernel_us"] = kernel_us["seg_scan walk_merge_6field_f32"]
    sp["kernel_us"] = kernel_us["spmv c2_synthetic blockell float32 m=1"]
    hb["kernel_us"] = kernel_us["hb_select walk_heg14"]
    spawn["kernel_us"] = kernel_us["hb_spawn c2_f32_pack"]
    slot["kernel_us"] = kernel_us["slot_parents walk"]
    seq["kernel_us"] = kernel_us["seq_init merge_f32"]
    PROFILED.clear()
    if "--kernels" in sys.argv[1:]:
        raise SystemExit("chip_smoke: --kernels ran phases 0-2 only; no "
                         "result")
    launches, system, res, trial, walkers = phase_main_path(dev)
    launches["spmv"] += phase_shci(dev, system, res)
    phase_f64_walk(dev, system, trial)
    phase_cli(dev)
    phase_hubbard(dev, smi, system, trial)
    phase_dense(dev, system, res, trial)
    phase_legacy(dev)
    phase_mesh(dev, system, res, trial, walkers)
    phase_bench_all(dev, smi)
    phase_graph(dev, smi, system, trial)
    for counts in (COUNTS7, COUNTS8, COUNTS9, COUNTS10, COUNTS11, COUNTS12):
        for k in KERNELS:
            launches[k] += counts[k]

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
              "sqmc_tpu/ops/pscan.py:163", launches["seg_scan"], seg),
        entry("spmv", "sqmc_tpu_torch/csrc/spmv.cu",
              "sqmc_tpu/ops/spmv_pallas.py:83", launches["spmv"], sp),
        entry("hb_select", "sqmc_tpu_torch/csrc/hbselect.cu",
              "sqmc_tpu/ops/prefix.py:53", launches["hb_select"], hb),
        entry("hb_spawn", "sqmc_tpu_torch/csrc/hbselect.cu",
              "sqmc_tpu/algo/walk.py:1539", launches["hb_spawn"], spawn),
        entry("slot_parents", "sqmc_tpu_torch/csrc/slotpar.cu",
              "sqmc_tpu/algo/walk.py:1459", launches["slot_parents"],
              slot),
        entry("seq_init", "sqmc_tpu_torch/csrc/seqinit.cu",
              "sqmc_tpu/algo/walk.py:2090", launches["seq_init"], seq)]}))
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
