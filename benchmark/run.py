"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Exits nonzero, printing no result, without as many NVIDIA cards as the
cell asks for, or when JAX or the JAX package was loaded.  See README.md.
"""

import time

T_START = time.time()        # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark", "cache", sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch
    from benchmark import harness, registry
    spec = registry.Spec(ROOT)
    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {a.workload} needs {cell['chips']} NVIDIA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, a.workload, a.seed, a.seconds,
                              bool(a.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
