"""The plain reference against the program at tiny sizes on the CPU: its
matrix elements, and whole runs of every cell judged correct."""

import pytest
import torch

import bench_tiny


def _port_and_reference(cell):
    from benchmark import harness, registry
    spec = registry.Spec()
    w = spec.cell(cell)
    config = dict(spec.config(w["config"]), name=w["config"])
    traffic = spec.traffic(w["traffic"])
    sysmod = registry.system(config["system"])
    wd = harness.workdir(spec.root)
    s = sysmod.program_system(config, traffic, torch.device("cpu"), wd)
    return s, sysmod.reference(config, traffic, "cpu", wd)


@pytest.mark.parametrize("cell", bench_tiny.WALK_CELLS)
def test_reference_elements_equal_the_programs(cell):
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    s, H = _port_and_reference(cell)
    tr = build_trial_wavefunction(s, eps_var=2e-2, n_psi_t=50, n_imp=100)
    pu, pd, c = tr.psit_up[:, 0], tr.psit_dn[:, 0], tr.psit_coef
    e = float(c @ H.matvec(pu, pd, pu, pd, c) / (c @ c))
    assert abs(e - tr.e_trial) < 1e-12 * abs(e)
    num = H.matvec(tr.ct_up[:, 0], tr.ct_dn[:, 0], pu, pd, c)
    assert float((num - tr.ct_num).abs().max()) < 1e-12
    iu, idn = tr.imp_up[:, 0], tr.imp_dn[:, 0]
    assert torch.allclose(H.rows(iu, idn, iu, idn), tr.imp_ham.dense(),
                          rtol=0, atol=1e-12)


@pytest.mark.parametrize("cell", bench_tiny.WALK_CELLS + ("heg14.shci",))
def test_a_sound_run_is_correct(cell):
    r = bench_tiny.run(cell)
    assert r["correct"], r["checks"]


def test_the_shci_reference_counts_what_the_program_counts():
    r = bench_tiny.run("heg14.shci")
    assert r["checks"]["n_connected"]["value"] == 0
    assert r["checks"]["pt"]["value"] < 1e-12
