#!/usr/bin/env python3
"""Name the device rows of a benchmark walk cell by their call sites.

    python3 tools/walk_stacks.py --workload heg54.walk [--seed 1]
        [--eq-blocks 10] [--gens 10] [--top 25]

Sets the cell up as ``benchmark/run.py`` does (its driver, with
``--eq-blocks`` blocks of equilibration in place of the traffic's), then
runs ``--gens`` generations through the eager loop
(``walk._walk_block_eager``) under torch.profiler with Python stacks.  A
replayed CUDA graph's kernels carry no stack; the eager loop launches the
same ops in the same order, so each kernel there is named by the aten op
that launched it (with its input shapes for a matrix product) and the
innermost functions of the port around that op.
Prints one line a (kernel, op, call site), largest device time first, in
ms a generation, beside the card's name and power limit.  Runs on the card
only.
"""

import argparse
import collections
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _sites(events, depth=3):
    """{id(op event): its call site}: the innermost `depth` functions of the
    port whose Python-function events enclose the op on its thread (a
    sweep over start times with a stack of the open functions), or the
    op's own recorded stack where the profiler keeps one."""
    own = "sqmc_tpu_torch/"
    by_thread = collections.defaultdict(list)
    for e in events:
        is_py = ".py(" in e.name and own in e.name
        if is_py or e.kernels:
            by_thread[e.thread].append((e.time_range.start, not is_py, e))
    out = {}
    for rows in by_thread.values():
        rows.sort(key=lambda r: (r[0], r[1]))
        open_ = []
        for start, is_op, e in rows:
            while open_ and open_[-1].time_range.end < start:
                open_.pop()
            if not is_op:
                open_.append(e)
                continue
            frames = [f for f in e.stack or () if own in f]
            frames = frames or [p.name for p in reversed(open_)]
            out[id(e)] = " < ".join(f.split(own)[-1] for f in frames[:depth])
    return out

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--eq-blocks", type=int, default=10)
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    a = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness, registry
    if not torch.cuda.is_available():
        raise SystemExit("walk_stacks: no CUDA card")
    spec = registry.Spec(ROOT)
    cell = spec.cell(a.workload)
    config = dict(spec.config(cell["config"]), name=cell["config"])
    traffic = spec.traffic(cell["traffic"])
    traffic["run"] = dict(traffic["run"], eq_blocks=a.eq_blocks)
    dev = torch.device("cuda", 0)
    drv = registry.driver(traffic["kind"]).Driver(
        config, traffic, a.seed, dev, harness.workdir(ROOT),
        registry.system(config["system"]))
    drv.setup({})
    W = drv.W
    st = W.end_of_block(drv.state)
    st = st._replace(equilibrated=torch.ones_like(st.equilibrated))
    W._walk_block_eager(st, drv.tables, drv.cfg, 2, drv.gen)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, record_shapes=True) as prof:
        W._walk_block_eager(st, drv.tables, drv.cfg, a.gens, drv.gen)
        torch.cuda.synchronize()
    rows = collections.defaultdict(lambda: [0.0, 0])
    total = 0.0
    events = prof.events()
    sites = _sites(events)
    for e in events:
        shapes = str(e.input_shapes) if e.name in ("aten::mm", "aten::mv",
                                                   "aten::addmm") else ""
        for k in e.kernels:
            r = rows[(k.name[:60], e.name + shapes, sites.get(id(e), ""))]
            r[0] += k.duration
            r[1] += 1
            total += k.duration
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    n_py = sum(".py(" in e.name for e in events)
    print(f"walk_stacks {a.workload}: {a.gens} eager generations, "
          f"{total / 1e3 / a.gens:.3f} kernel ms a generation, "
          f"{n_py} Python-function events "
          f"(cap_spawn {drv.cfg.cap_spawn}, mwalk {drv.cfg.mwalk}) [{smi}]")
    for (kern, op, site), (us, n) in sorted(rows.items(),
                                            key=lambda kv: -kv[1][0])[:a.top]:
        print(f"  {us / 1e3 / a.gens:8.4f} ms/gen  {n / a.gens:6.1f} rows/gen"
              f"  {kern}  <- {op}  @ {site}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
