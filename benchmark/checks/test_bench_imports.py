"""Nothing on the run path loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness, registry

HERE = os.path.join(registry.ROOT, "benchmark")


def test_forbidden_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("sqmc_tpu", None)
        sys.modules["sqmc_tpu_torch_probe"] = sys
        assert "sqmc_tpu_torch_probe" not in harness.forbidden_modules()
        sys.modules["sqmc_tpu.probe"] = sys
        assert harness.forbidden_modules() == ["sqmc_tpu.probe"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]);"
            "sys.path.insert(0, sys.argv[2]);"
            "import bench_tiny; from benchmark import harness;"
            "bench_tiny.run('c2.walk'); bench_tiny.run('heg14.shci');"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, registry.ROOT,
                          os.path.dirname(__file__)], capture_output=True,
                         text=True, timeout=600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_and_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "yardstick", "inputs"):
        for f in os.listdir(os.path.join(HERE, sub)):
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in
                        _imports(os.path.join(HERE, sub, f))}
                assert not tops & {"sqmc_tpu", "sqmc_tpu_torch", "jax",
                                   "jaxlib", "flax"}, (sub, f)
