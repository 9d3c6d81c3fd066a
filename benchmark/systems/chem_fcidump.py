"""Molecular deployments read from an FCIDUMP the benchmark writes.

The configuration names the writer under ``benchmark/inputs/`` and its
arguments; the file goes to ``<workdir>/<config name>.FCIDUMP`` and both
the program and the reference read it.  The traffic's ``basis`` picks the
determinant basis (time-reversal symmetrized or plain) and the start."""

from __future__ import annotations

import importlib
import os


def write_input(config: dict, workdir: str) -> str:
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"{config['name']}.FCIDUMP")
    writer = importlib.import_module(f"benchmark.inputs.{config['writer']}")
    writer.write(path, **config["writer_args"])
    return path


def program_system(config: dict, traffic: dict, device, workdir: str):
    from sqmc_tpu_torch.systems.base import make_chem_system
    b = traffic.get("basis", {})
    return make_chem_system(
        write_input(config, workdir), time_sym=b.get("time_sym", False),
        z=b.get("z", 1), point_group=config.get("point_group"),
        hf_symmetry=b.get("hf_symmetry"), device=device)


def reference(config: dict, traffic: dict, device, workdir: str):
    from benchmark.reference import fcidump, slater
    h, eri, core, norb, _, _ = fcidump.load(
        os.path.join(workdir, f"{config['name']}.FCIDUMP"))
    b = traffic.get("basis", {})
    return slater.Hamiltonian(h, eri, core, norb,
                              time_sym=b.get("time_sym", False),
                              z=b.get("z", 1), device=device)
