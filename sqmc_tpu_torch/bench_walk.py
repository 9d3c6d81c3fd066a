"""Generations per second of the walk on the card, and where its device
time goes.

    python sqmc_tpu_torch/bench_walk.py [--repo DIR] [--gens N] [--tag NAME]
                                        [--deck c2|bench] [--profile N]
                                        [--state both|f32|f64] [--kernels]

By default runs the 14-electron electron gas (3D, r_s = 0.5, 19 plane
waves; HCI at eps_var 1e-3, D = the 9,475 HCI dets, Psi_T its top 2,000)
at the walk knobs of chip_smoke.py's phases 3 and 5 (population 2e5,
mwalk 458,752, cap_spawn 262,144) for N generations after N / 2 of
equilibration, in float32 state (dense projector) and in float64 state
(block-ELL SpMV kernel), and prints one line per state with gen/s, the
launches of the package's kernels and the card's nvidia-smi name and
power limit.

--deck c2 runs chip_smoke.py's phase 6b walk deck instead (its synthetic
C2-shaped FCIDUMP, 26 orbitals with singles, time-symmetrized, float64
state, population 2e5, the deck's own depth) through the CLI's
run_from_config; the FCIDUMP goes to build/bench_walk/.

The walks run as the package runs them: on the card each block replays
one captured generation (a CUDA graph).  --profile N runs N more
generations from each walk's final state, first through the eager loop
(``walk._walk_block_eager``), then through the captured generation, each
twice: timed (CUDA-synchronized wall time) and under torch.profiler, and
prints the kernel time a generation, the device rows (kernels, copies,
sets) a generation, the timed ms and gen/s, the busy share (kernel time /
timed wall time), the host calls that queue work (kernel and graph
launches, copies, sets) a generation, the top rows by device time and the
rows of the package's own kernels; for the graph also its capture seconds
and memory pool.

--deck bench runs the walk of ``python -m sqmc_tpu_torch.bench`` (the
synthetic C2-shaped file in plain dets, its trial cached in build/bench/,
its knobs and 12 equilibration blocks) for N generations.

--state f32 or f64 runs only that state of the electron gas.

--kernels runs no walk: it times the spawn kernels alone (device us a
call, chip_smoke.py's CUDA-graph timing) -- the heat-bath selection (K3)
at phase 2d's walk and chem shapes and at shapes no walk of the package
runs (18 and 34 electrons at 2n = 52, 20 at 2n = 260 with R2 read through
L1/L2), the slot -> parent expand (K4) at phase 2d's two shapes -- each
first held against its plain version with phase 2d's criteria; then the
sequential initiator combine (K5) at phase 2e's four row sets, bit for
bit against its plain version, its device us a call and, from one
profiler session over them, each of its kernels' us a call (mark and
compact, walk, fill).

--repo DIR imports the package from DIR instead of the directory above
this file, so that two checkouts can be timed in one process-per-run
sequence on one card (old, new, new, old) with the same script.
"""

import argparse
import importlib.util
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = 12                              # profile rows printed
OWN = ("k_seg_scan", "k_spmv", "k_hb_select", "k_hb_spawn", "k_slot_parents",
       "k_seq_init")


def _launch_counts():
    """{kernel: launches} of the kernel modules the imported package has."""
    out = {}
    for name in ("segscan", "spmv", "hbselect", "hbspawn", "slotpar",
                 "seqinit"):
        mod = f"sqmc_tpu_torch.ops.{name}"
        if importlib.util.find_spec(mod) is not None:
            out[name] = importlib.import_module(mod).launches
    return out


def _reset_counts():
    for name in _launch_counts():
        importlib.import_module(f"sqmc_tpu_torch.ops.{name}").reset_launches()


# host calls that put work on the card's queue
HOST_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def _profile(system, trial, cfg, state, guide, n, tag, smi):
    """n generations from `state`, timed, then n more under the profiler,
    first through the eager loop (walk._walk_block_eager), then through
    the captured generation (walk.walk_block: one CUDA graph replayed)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sqmc_tpu_torch.algo import walk as W
    tables = W.build_walk_tables(system, trial, cfg, guide=guide)
    gen = torch.Generator(device=state.wt.device).manual_seed(7)
    # a checkout from before the captured walk (--repo) has the loop only
    modes = ((("eager", W._walk_block_eager), ("graph", W.walk_block))
             if hasattr(W, "_walk_block_eager") else (("eager", W.walk_block),))
    for mode, block in modes:
        state, _ = block(state, tables, cfg, 2, gen)    # graph: the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = block(state, tables, cfg, n, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = block(state, tables, cfg, n, gen)
            torch.cuda.synchronize()
        _profile_lines(prof, DeviceType, n, wall, f"{tag} {mode}", smi)
        if mode == "graph":
            g = W._GRAPH[next(iter(W._GRAPH))]
            print(f"bench_walk {tag} graph: capture_seconds="
                  f"{g.capture_seconds:.3f} pool_MB={g.pool_bytes / 2**20:.1f}"
                  f" [{smi}]", flush=True)
    if hasattr(W, "release_graphs"):
        W.release_graphs()


def _profile_lines(prof, DeviceType, n, wall, tag, smi):
    rows = {}
    host = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = rows.get(e.name, (0.0, 0))
            rows[e.name] = (us + e.time_range.elapsed_us(), k + 1)
        elif e.name.startswith(HOST_LAUNCHES):
            host += 1
    total = sum(us for us, _ in rows.values())
    count = sum(k for _, k in rows.values())
    print(f"bench_walk {tag} profile: gens={n} kernel_ms_per_gen="
          f"{total / n / 1e3:.4f} device_rows_per_gen={count / n:.1f} "
          f"timed_ms_per_gen={wall / n * 1e3:.4f} busy_share="
          f"{total / 1e6 / wall:.3f} gen_per_s={n / wall:.3f} "
          f"host_launches_per_gen={host / n:.2f} [{smi}]", flush=True)
    for name, (us, k) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"bench_walk {tag} profile row: us_per_gen={us / n:.1f} "
              f"calls_per_gen={k / n:.2f} share={us / total:.3f} "
              f"{name[:100]}", flush=True)
    for kernel in OWN:                 # the package's kernels, ranked or not
        found = [(us, k) for name, (us, k) in rows.items() if kernel in name]
        us, k = sum(f[0] for f in found), sum(f[1] for f in found)
        print(f"bench_walk {tag} profile kernel: {kernel} us_per_gen="
              f"{us / n:.1f} calls_per_gen={k / n:.2f} share="
              f"{us / max(total, 1e-9):.3f}", flush=True)


def _report(tag, out, smi):
    print(f"bench_walk {tag}: measured_gens={out.n_measured} "
          f"gen_per_s={out.steps_per_sec:.3f} e_mixed={out.e_mixed:.9f} "
          f"capacity_grows={out.capacity_grows} launches={_launch_counts()} "
          f"[{smi}]", flush=True)


def heg14(args, smi):
    import torch
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.systems.heg.system import make_heg_system

    system = make_heg_system(3, 0.5, 14, 7, 1.49)
    trial = build_trial_wavefunction(system, eps_var=1e-3, n_psi_t=2000,
                                     n_imp=20000)
    nblk = max(1, args.gens // 100)
    states = {"both": (True, False), "f32": (True,), "f64": (False,)}
    for f32 in states[args.state]:
        cfg = WalkConfig(mwalk=458_752, cap_spawn=262_144, norb=system.norb,
                         nup=7, ndn=7, n_words=1, tau=2e-3, w_abs_target=2e5,
                         spawn_granularity=2.0, min_wt=0.5, r_initiator=0.5,
                         f32_state=f32, has_singles=False)
        _reset_counts()
        out = run_walk(system, trial, cfg, nstep=100, nblk=nblk,
                       nblk_eq=max(1, nblk // 2), w_abs_begin=2e5,
                       e_trial_initial=trial.e_trial, verbose=False,
                       max_eq_extensions=0, seed=1)
        torch.cuda.synchronize()
        tag = f"{args.tag} heg14 {'f32' if f32 else 'f64'}"
        _report(tag, out, smi)
        if args.profile:
            _profile(system, trial, cfg, out.state, None, args.profile, tag,
                     smi)


def _chip_smoke():
    """chip_smoke.py of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# (norb, nup, ndn, R2 kind, singles, share of sentinel slots) at 262,144
# slots: phase 2d's walk and chem cases, then dets past the kernel's
# register path
K3_SHAPES = {"walk_heg14": (19, 7, 7, "heg14", False, 0.0),
             "walk_heg14_sentinel30": (19, 7, 7, "heg14", False, 0.3),
             "chem26_singles": (26, 4, 4, "float", True, 0.0),
             "chem26_18e": (26, 9, 9, "float", True, 0.0),
             "chem26_34e": (26, 17, 17, "float", True, 0.0),
             "norb130_20e": (130, 10, 10, "float", True, 0.0)}


def kernels(args, smi):
    """K3 and K4 alone: each case held against its plain version, then
    its device time a call."""
    import numpy as np
    import torch
    from sqmc_tpu_torch.ops import hbselect, slotpar
    smoke = _chip_smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    cap, m = smoke.SPAWN_CAP, smoke.SPAWN_M
    t = lambda x: None if x is None else torch.as_tensor(x, device=dev)  # noqa: E731
    for name, (norb, nup, ndn, kind, singles, empty) in K3_SHAPES.items():
        n2 = 2 * norb
        if kind == "heg14":
            R2 = smoke._heg14_r2(dev)
        else:
            R2 = rng.exponential(1.0, (n2, n2)).astype(np.float32)
            np.fill_diagonal(R2, 0.0)
            R2 = t(R2)
        u_rowsum = t(rng.exponential(1.0, norb)) if singles else None
        up = t(smoke._random_dets(rng, cap, norb, nup))
        dn = t(smoke._random_dets(rng, cap, norb, ndn))
        up[int((1 - empty) * cap):] = -1
        dn[int((1 - empty) * cap):] = -1
        hb = (up, dn, norb, R2, u_rowsum, t(rng.random(cap)),
              t(rng.random(cap)))
        smoke._hb_compare(name, hbselect.hb_select(*hb),
                          hbselect.hb_select_plain(*hb), exact=False)
        us = smoke._device_us(lambda: hbselect.hb_select(*hb))
        print(f"bench_walk {args.tag} kernel: hb_select {name} cap={cap} "
              f"2n={n2} ne={nup + ndn} device_us={us:.1f} [{smi}]",
              flush=True)
    for name, goal in (("walk", int(0.7 * cap)), ("overflow", 2 * cap)):
        nchild = rng.poisson(3.0, m) * (rng.random(m) < 0.5)
        nchild[500] = 5000
        cum = np.cumsum(nchild)
        i = int(np.searchsorted(cum, goal))
        nchild[i] -= cum[i] - goal
        nchild[i + 1:] = 0
        cum = torch.cumsum(t(nchild), 0)
        if not torch.equal(slotpar.slot_parents(cum, cap),
                           slotpar.slot_parents_plain(cum, cap)):
            raise AssertionError(f"slot_parents {name}: differs")
        us = smoke._device_us(lambda: slotpar.slot_parents(cum, cap))
        print(f"bench_walk {args.tag} kernel: slot_parents {name} M={m} "
              f"cap={cap} total={goal} device_us={us:.1f} [{smi}]",
              flush=True)
    seq_kernels(args, smi, smoke)


def seq_kernels(args, smi, smoke, calls=20):
    """K5 at phase 2e's row sets: bit for bit against its plain version,
    device us a call, then each of its kernels' us a call (one profiler
    session)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from sqmc_tpu_torch.ops import seqinit
    dev = torch.device("cuda")
    cases = {}
    for name, wdt, rows in (
            ("merge_f32", np.float32, lambda w: smoke._seq_rows(
                smoke.MERGE_N, 25, w)),
            ("merge_f64", np.float64, lambda w: smoke._seq_rows(
                smoke.MERGE_N, 25, w)),
            ("walk_f32", np.float32, lambda w: smoke._seq_walk_rows(25, w)),
            ("long_group_f32", np.float32, lambda w: smoke._seq_rows(
                smoke.MERGE_N, 25, w, smoke.SEQ_LONG))):
        host = [torch.as_tensor(x) for x in rows(wdt)]
        a = [x.to(dev) for x in host]
        stats = {}
        if not torch.equal(seqinit.sequential_initiator(*a).cpu(),
                           seqinit.sequential_initiator_plain(*host,
                                                              stats=stats)):
            raise AssertionError(f"seq_init {name}: differs")
        us = smoke._device_us(lambda a=a: seqinit.sequential_initiator(*a))
        print(f"bench_walk {args.tag} kernel: seq_init {name} "
              f"n={a[0].shape[0]} active_rows={stats['active']} "
              f"longest_active_group={stats['passes'] + 1} "
              f"device_us={us:.1f} [{smi}]",
              flush=True)
        cases[name] = a
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, a in cases.items():
            with record_function("case:" + name):
                for _ in range(calls):
                    seqinit.sequential_initiator(*a)
                torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name[5:]: (e.time_range.start, e.time_range.end)
              for e in events if e.name.startswith("case:")}
    for name, (lo, hi) in ranges.items():
        rows = {}
        for e in events:
            if (e.device_type == DeviceType.CUDA and "k_seq_init" in e.name
                    and lo <= e.time_range.start <= hi):
                key = re.search(r"k_seq_init_\w+", e.name).group(0)
                rows[key] = rows.get(key, 0.0) + e.time_range.elapsed_us()
        print(f"bench_walk {args.tag} kernel: seq_init {name} kernel_us "
              + " ".join(f"{k}={v / calls:.1f}" for k, v in sorted(rows.items()))
              + f" [{smi}]", flush=True)


def c2_deck(args, smi):
    """chip_smoke.py's 6b walk deck through the CLI, its run_walk wrapped
    to report and profile the walk it runs."""
    import torch
    from sqmc_tpu_torch import cli
    from sqmc_tpu_torch.algo import walk as W
    from sqmc_tpu_torch.config import parse_input

    smoke = _chip_smoke()
    workdir = os.path.join(ROOT, "build", "bench_walk")
    os.makedirs(workdir, exist_ok=True)
    fcidump = os.path.join(workdir, "FCIDUMP_c2_synthetic")
    smoke.write_c2_fcidump(fcidump)
    real = W.run_walk

    def run_walk(system, trial, cfg, *a, **kw):
        out = real(system, trial, cfg, *a, **kw)
        torch.cuda.synchronize()
        tag = f"{args.tag} c2_deck"
        _report(tag, out, smi)
        if args.profile:
            if out.capacity_grows:
                raise SystemExit("bench_walk: the deck's walk grew its "
                                 "capacity; no profile of its configuration")
            _profile(system, trial, cfg, out.state, kw.get("guide"),
                     args.profile, tag, smi)
        return out

    W.run_walk = run_walk
    try:
        _reset_counts()
        cli.run_from_config(parse_input(smoke.C2_WALK_DECK), fcidump=fcidump,
                            verbose=False, device="cuda")
    finally:
        W.run_walk = real


def bench_cell(args, smi):
    """The walk of sqmc_tpu_torch/bench.py at its knobs, for args.gens
    measured generations."""
    import torch
    from sqmc_tpu_torch import bench
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    system, trial, _, _ = bench.system_and_trial(
        torch.device("cuda"), bench.WORKDIR, **bench.TRIAL)
    cfg = WalkConfig(norb=system.norb, nup=system.nup, ndn=system.ndn,
                     n_words=system.n_words, **bench.WALK)
    _reset_counts()
    out = run_walk(system, trial, cfg, nstep=100,
                   nblk=max(1, args.gens // 100),
                   nblk_eq=bench.RUN["nblk_eq"],
                   w_abs_begin=bench.RUN["w_abs_begin"],
                   e_trial_initial=trial.e_trial, verbose=False,
                   max_eq_extensions=0)
    torch.cuda.synchronize()
    tag = f"{args.tag} bench"
    _report(tag, out, smi)
    if args.profile:
        _profile(system, trial, cfg, out.state, None, args.profile, tag, smi)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=ROOT)
    ap.add_argument("--gens", type=int, default=400)
    ap.add_argument("--tag", default="")
    ap.add_argument("--deck", choices=("heg14", "c2", "bench"),
                    default="heg14")
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    ap.add_argument("--state", choices=("both", "f32", "f64"),
                    default="both")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_walk: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if args.kernels:
        kernels(args, smi)
    else:
        {"heg14": heg14, "c2": c2_deck, "bench": bench_cell}[args.deck](
            args, smi)


if __name__ == "__main__":
    main()
