"""Find the benchmark's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; each
lives in a file of its own, found here by that name:

    configs/<config>.json     the deployment (its "system" names a module
                              systems/<system>.py that builds it)
    traffic/<traffic>.json    the mix (its "kind" names a generator
                              drivers/<kind>.py)
    limits/<cell>.json        the limit of each number that decides
                              `correct` in the cell
    metrics/<metric>.py       a per-layer metric's reader: read(run)

A new cell, configuration, mix or metric is a new file and a new entry
in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.doc = _json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(HERE, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return _json(os.path.join(HERE, "limits", f"{cell}.json"))

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics to read in the cell: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def system(name: str):
    return _module("systems", name)


def driver(kind: str):
    return _module("drivers", kind)


def metric(name: str):
    return _module("metrics", name)
