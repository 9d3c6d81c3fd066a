"""On the card: one short run of each cell through the command itself."""

import json
import subprocess
import sys

import pytest

from benchmark import registry


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.Spec().doc["workloads"]])
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", "2718281828", "--seconds", "2",
                          "--trace", "0"], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
