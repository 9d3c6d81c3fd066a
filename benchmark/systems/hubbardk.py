"""Hubbard deployments in momentum space: an l_x x l_y periodic cluster
of hopping t and on-site U, with nup + ndn electrons (the upstream's
`hubbardk` cards)."""

from __future__ import annotations


def program_system(config: dict, traffic: dict, device, workdir: str):
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system
    return make_hubbard_k_system(config["l_x"], config["l_y"], config["t"],
                                 config["U"], config["nup"], config["ndn"],
                                 device=device)


def reference(config: dict, traffic: dict, device, workdir: str):
    import torch
    from benchmark.reference import hubbardk, slater
    # the reference's products in full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    h, eri, core, norb = hubbardk.integrals(config["l_x"], config["l_y"],
                                            config["t"], config["U"])
    return slater.Hamiltonian(h, eri, core, norb, device=device)
