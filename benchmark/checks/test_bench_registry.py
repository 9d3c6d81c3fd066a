"""The benchmark finds its pieces by name, and a new cell, configuration,
traffic mix or metric is only new files and entries: a kernel metric
reads its call shapes from the driver the harness hands it."""

import filecmp
import json
import os
import re
import shutil
import subprocess
import sys

import bench_tiny
from benchmark import registry

ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves():
    spec = registry.Spec()
    for w in spec.doc["workloads"]:
        config = spec.config(w["config"])
        traffic = spec.traffic(w["traffic"])
        registry.system(config["system"])
        assert hasattr(registry.driver(traffic["kind"]), "Driver")
        assert spec.limits(w["name"])
        assert any(m["name"] == "setup_s" for m in spec.end_to_end(w["name"]))
        assert len(spec.end_to_end(w["name"])) >= 2
        assert spec.per_layer(w["name"])
    for m in spec.doc["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_benchmark_json_keeps_the_contract_shape():
    doc = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in doc[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(doc["end_to_end"][i]["name"]
                   for i in range(len(doc["end_to_end"])))) \
        == len(doc["end_to_end"])
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        spec = registry.Spec()
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in spec.end_to_end(cell)}
    pairs = [(w["config"], w["traffic"]) for w in doc["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in doc["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


NEW_METRIC = '''"""A metric a later change adds."""


def read(run):
    return 42.0
'''


def test_new_cell_metric_and_mix_are_found_from_new_files_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    (b / "configs" / "heg14-rs1.json").write_text(json.dumps(dict(
        json.load(open(b / "configs" / "heg14.json")), r_s=1.0)))
    (b / "traffic" / "walk-f32-pop4e5.json").write_text(json.dumps(dict(
        json.load(open(b / "traffic" / "walk-f32.json")))))
    (b / "limits" / "heg14rs1.walk.json").write_text(
        (b / "limits" / "heg14.walk.json").read_text())
    (b / "metrics" / "new_metric.py").write_text(NEW_METRIC)
    doc["configs"].append(dict(doc["configs"][1], name="heg14-rs1",
                               file="benchmark/configs/heg14-rs1.json"))
    doc["workloads"].append({"name": "heg14rs1.walk", "config": "heg14-rs1",
                             "traffic": "walk-f32-pop4e5", "chips": 1,
                             "why": "a later cell"})
    doc["per_layer"].append({"name": "new_metric", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "kernels", "moves": "gen_per_s",
                             "workloads": ["heg14rs1.walk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from benchmark import registry as r;"
        "s = r.Spec(sys.argv[1]); c = s.cell('heg14rs1.walk');"
        "assert s.config(c['config'])['r_s'] == 1.0;"
        "assert s.traffic(c['traffic'])['kind'] == 'walk';"
        "assert s.limits('heg14rs1.walk');"
        "assert [m['name'] for m in s.per_layer('heg14rs1.walk')] "
        "== ['new_metric'];"
        "assert r.metric('new_metric').read({}) == 42.0;"
        "assert r.HERE.startswith(sys.argv[1]); print('found')")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "found" in out.stdout
    # nothing that was there was edited
    cmp = filecmp.dircmp(os.path.join(ROOT, "benchmark"), b,
                         ignore=["__pycache__"])

    def diffs(c):
        return c.diff_files + [f for s in c.subdirs.values() for f in diffs(s)]
    assert diffs(cmp) == []


NEW_KERNEL_METRIC = '''"""A kernel metric a later change adds: its call shape
comes from the driver the harness hands it."""


def read(run):
    drv = run.get("driver")
    if run.get("kind") != "walk" or drv is None:
        return None
    return float(drv.cfg.mwalk + drv.cfg.cap_spawn)
'''


def test_a_new_kernel_metric_reads_its_shapes_from_new_files_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    doc = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (tmp_path / "benchmark" / "metrics" / "merge_rows.py").write_text(
        NEW_KERNEL_METRIC)
    doc["per_layer"].append({"name": "merge_rows", "unit": "rows",
                             "better": "lower", "source": "device_trace",
                             "layer": "kernels", "moves": "gen_per_s",
                             "workloads": ["c2.walk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + "
        "'/benchmark/checks', sys.argv[2]];"
        "import bench_tiny; from benchmark import harness;"
        "assert harness.__file__.startswith(sys.argv[1]);"
        "r = bench_tiny.run('c2.walk', trace=True);"
        "print(r['metrics']['merge_rows']['value'])")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), ROOT],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = bench_tiny.WALK["walk"]["mwalk"] + bench_tiny.WALK["walk"][
        "cap_spawn"]
    assert float(out.stdout.strip().splitlines()[-1]) == want
