"""Electron-gas deployments past 64 plane waves, W int64 words a spin: the
program's gas as in systems/heg.py, and the reference's H over dets of
any number of words (reference/slater_words.py)."""

from __future__ import annotations

from benchmark.systems.heg import program_system  # noqa: F401


def reference(config: dict, traffic: dict, device, workdir: str):
    import torch
    from benchmark.reference import heg, slater_words
    # the reference's products in full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    h, eri, core, norb = heg.integrals(config["n_dim"], config["r_s"],
                                       config["nelec"],
                                       config["cutoff_radius"])
    return slater_words.Hamiltonian(h, eri, core, norb, device=device)
