"""Electron-gas deployments: plane waves in a cubic cell, from the
configuration's dimension, r_s, electrons and cutoff."""

from __future__ import annotations


def program_system(config: dict, traffic: dict, device, workdir: str):
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    return make_heg_system(config["n_dim"], config["r_s"], config["nelec"],
                           config["nup"], config["cutoff_radius"],
                           device=device)


def reference(config: dict, traffic: dict, device, workdir: str):
    from benchmark.reference import heg, slater
    h, eri, core, norb = heg.integrals(config["n_dim"], config["r_s"],
                                       config["nelec"],
                                       config["cutoff_radius"])
    return slater.Hamiltonian(h, eri, core, norb, device=device)
