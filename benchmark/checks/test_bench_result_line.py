"""The result line carries the contract's keys only, the numbers compared
come last, and rates are taken over the whole window."""

import json
import subprocess
import sys
import time

import pytest

import bench_tiny
from benchmark import registry

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_only_the_contract_keys(trace):
    r = bench_tiny.run("c2.walk", trace=trace)
    keys = list(r)
    assert keys[-1] == "checks"
    assert set(keys[:-1]) - set(KEYS) <= {"breakdown"}
    assert set(KEYS) <= set(keys)
    json.dumps(r)
    spec = registry.Spec()
    want = [m["name"] for m in (spec.per_layer("c2.walk") if trace
                                else spec.end_to_end("c2.walk"))]
    assert set(r["metrics"]) <= set(want)
    if not trace:
        assert set(r["metrics"]) == set(want)
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_rates_are_over_the_whole_window():
    seen = {"gens": 0, "nwalk": 0.0, "t": []}

    def patch(drv):
        orig = drv.block_fn

        def block(start, tables, cfg, n, gen):
            t0 = time.perf_counter()
            out, stats = orig(start, tables, cfg, n, gen)
            time.sleep(0.05)
            seen["gens"] += n
            seen["nwalk"] += float(stats["nwalk"].sum())
            seen["t"].append((t0, time.perf_counter()))
            return out, stats
        drv.block_fn = block
    r = bench_tiny.run("heg14.walk", seconds=0.4, patch=patch)
    span = seen["t"][-1][1] - seen["t"][0][0]
    g = r["metrics"]["gen_per_s"]["value"]
    w = r["metrics"]["walker_steps_per_s"]["value"]
    assert r["attempted"] == seen["gens"] and r["failed"] == 0
    # every block of the window counts, over at least the blocks' own span
    assert g <= seen["gens"] / span
    assert g >= 0.95 * seen["gens"] / (span + 0.01)
    assert w / g == pytest.approx(seen["nwalk"] / seen["gens"], rel=1e-12)


def test_no_card_means_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this sandbox check needs a machine without a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "c2.walk", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
