"""The readings that set a cell's limits: the program's numbers on
many seeds, the control's (the reference one precision lower in the
program's place) on the same runs, and each planted fault's.

    python3 benchmark/control.py --workload <name> --seeds 12 \
        --first-seed <n> --seconds 2 --faults 3 --out <file.jsonl>

One process: set-up once, then per seed a fresh state, equilibration and
a window at the cell's own sizes; each fault is planted before its run's
restart, so the equilibration has it too.  Not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault-names", default="",
                    help="comma-separated faults to read (default: all)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default="{}",
                    help="JSON: traffic keys replaced (a tiny CPU rehearsal)")
    a = ap.parse_args(argv)

    import torch
    from benchmark import faults, harness, registry
    spec = registry.Spec(ROOT)
    cell = spec.cell(a.workload)
    config = dict(spec.config(cell["config"]), name=cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for k, v in json.loads(a.override).items():
        traffic[k] = dict(traffic[k], **v) if isinstance(v, dict) else v
    system_mod = registry.system(config["system"])
    mod = registry.driver(traffic["kind"])
    dev = torch.device(a.device)
    wd = harness.workdir(ROOT)
    seeds = [a.first_seed + 7919 * i for i in range(a.seeds)]
    drv = mod.Driver(config, traffic, seeds[0], dev, wd, system_mod)
    drv.setup({})
    H = system_mod.reference(config, traffic, dev, wd)
    control = drv.control()
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "a") as f:
        def emit(rec):
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec), flush=True)
        names = (a.fault_names.split(",") if a.fault_names
                 else list(faults.FOR[mod.Driver.kind]))
        runs = [(s, None) for s in seeds] + [
            (s, name) for name in names for s in seeds[:a.faults]]
        for i, (seed, fault) in enumerate(runs):
            # a fault goes in before the restart, so that the captured
            # generation and the equilibration have it too
            undo = faults.FOR[mod.Driver.kind][fault](drv) if fault else None
            if i:
                drv.restart(seed)
            e2e = drv.window(a.seconds)
            out = drv.outputs()
            if undo is not None:
                undo()
            t0 = time.perf_counter()
            info = {}
            rec = {"cell": a.workload, "seed": seed, "fault": fault,
                   "e2e": e2e, "program": mod.judge(H, out, info=info),
                   "info": info}
            rec["judge_s"] = time.perf_counter() - t0
            if fault is None:
                rec["control"] = mod.judge(H, out, control)
                rec["control_precision"] = control
            emit(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
