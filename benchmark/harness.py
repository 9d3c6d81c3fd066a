"""One run of one cell: set-up, the window (or the traced window), the
judge, and the result line's fields.

``run.py`` calls :func:`run_cell` after it has found the cards the cell
asks for; the benchmark's CPU checks call it on the CPU at a tiny size.
"""

from __future__ import annotations

import math
import os
import sys
import time

from benchmark import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "sqmc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def workdir(root: str) -> str:
    """Where the benchmark writes its inputs: inside the checkout."""
    return os.path.join(root, "build", "benchmark", "inputs")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_cell(spec: registry.Spec, name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, traffic_override=None,
             patch=None, control: bool = False,
             limits_override=None) -> dict:
    """The result of one run (the last line's fields, `checks` last).

    traffic_override, limits_override: keys replaced in the traffic and
    the limits (the CPU checks' tiny sizes).  patch: called with the
    driver after set-up, before the window (the CPU checks plant faults
    so, and take them out after).  control: judge the reference one
    precision lower in the program's place."""
    import torch
    cell = spec.cell(name)
    config = dict(spec.config(cell["config"]), name=cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for k, v in (traffic_override or {}).items():
        traffic[k] = dict(traffic[k], **v) if isinstance(v, dict) else v
    limits = dict(spec.limits(name), **(limits_override or {}))
    system_mod = registry.system(config["system"])
    mod = registry.driver(traffic["kind"])
    device = torch.device(device)
    wd = workdir(spec.root)
    drv = mod.Driver(config, traffic, seed, device, wd, system_mod)

    spans = {"start": time.time() - t_start}
    drv.setup(spans)
    if patch is not None:
        patch(drv)
    t_window = time.time()
    setup_s = t_window - t_start
    _log(f"# {name} seed={seed} setup_s={setup_s:.3f} "
         f"spans={ {k: round(v, 3) for k, v in spans.items()} }")

    metrics, summary, dev_extra = {}, None, {}
    if trace:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)
        from benchmark.yardstick import trace as T
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        events, window_s, units = drv.traced(profile(activities=acts),
                                             record_function, seconds)
        summary = T.summarize(events, window_s, units)
        del events
        dev_extra = {"busy_s": summary["busy_s"], "window_s": window_s}
        spans.update(getattr(drv, "traced_spans", dict)())
        run = {"kind": mod.Driver.kind, "trace": summary, "spans": spans,
               "driver": drv}
        units_of = {m["name"]: m["unit"] for m in spec.doc["per_layer"]}
        for m in spec.per_layer(name):
            v = registry.metric(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units_of[m["name"]]}
    else:
        e2e = drv.window(seconds)
        e2e["setup_s"] = setup_s
        for m in spec.end_to_end(name):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    _log(f"# {name} window closed: {metrics}")

    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    dev.update(dev_extra)
    outputs = drv.outputs()
    control_prec = drv.control() if control else None
    drv.release()

    t_judge = time.perf_counter()
    H = system_mod.reference(config, traffic, device, wd)
    numbers = mod.judge(H, outputs, control_prec)
    _log(f"# {name} judged in {time.perf_counter() - t_judge:.3f}s")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    for k, c in checks.items():
        _log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return result
