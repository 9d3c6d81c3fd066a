"""The cards of the legacy CI and the SHCI observables through both
packages' card front ends, in process on the CPU (``run_from_config``):
run types ``selected_ci`` and ``trunc_lanc`` on a 2x2 momentum-space
Hubbard deck, and on the 6-orbital time-symmetrized d2h HCI deck of
tests/test_torch_cli.py the ``&natorb`` card in both branches (use_pt
.false. and .true.), ``&greens_function`` and ``&active_space``.  The
port prints the JAX CLI's lines with the same digits (energies to the
printed digit), and the FCIDUMP.natorb files hold the same integrals
(1e-12)."""

import re

import numpy as np
import pytest
import torch

from sqmc_tpu import cli as j_cli
from sqmc_tpu.config import parse_input as j_parse
from sqmc_tpu_torch import cli as t_cli
from sqmc_tpu_torch.config import parse_input as t_parse
from sqmc_tpu_torch.systems.chem.fcidump import read_fcidump
from test_torch_cli import TS_HCI, fcidump  # noqa: F401  (fixture)

torch.set_num_threads(1)

HUBBARDK_LEGACY = """\
1 1                                irand_seed
100 {iters} {iters} 0                  nstep,nblk,nblk_eq,ipr
1000 2000 0                        w_abs_gen_begin, w_abs_gen_target, MWALK
0.1 0.                             tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
heat_bath2 0 1. 0 1.               proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
{run_type}                         run_type
.false. f                          semistochastic, use_exponential_projector
{n_trunc}                                  n_truncate_det
'hubbardk' 0                       hamiltonian_type,ipr
2 2                                l_x, l_y
t f                                pbc, neel_up_only
1. 4.                              t, U
2 2                                n_alpha, n_beta
"""

LEGACY = {
    "selected_ci": HUBBARDK_LEGACY.format(run_type="selected_ci", iters=4,
                                          n_trunc=8),
    "trunc_lanc": HUBBARDK_LEGACY.format(run_type="trunc_lanc", iters=6,
                                         n_trunc=10),
}

OBSERVABLES = {
    "natorb_greens": TS_HCI + (
        "&natorb get_natorbs=.true. use_pt=.false. /\n"
        "&greens_function get_greens_function=.true. n_w=7 w_min=-3. "
        "w_max=3. /\n"),
    "natorb_pt": TS_HCI.replace(
        "&selected_ci eps_var_sched=2*2e-3 /",
        "&selected_ci eps_var_sched=2*2e-3 eps_pt_big=1e-5 /")
    + "&natorb get_natorbs=.true. use_pt=.true. /\n",
    "active_space": TS_HCI
    + "&active_space n_var_e_up=2 n_var_e_dn=2 n_var_orbs=4 /\n",
}

# printed lines compared as strings (the digits the JAX CLI prints)
LINES = (r"^Selected CI energy=.*$", r"^selected_ci iter .*$",
         r"^selected_ci final: .*$", r"^Truncated Lanczos energy=.*$",
         r"^trunc_lanc iter .*$", r"^Variational energy=.*$",
         r"^State \d: variational energy=.*$",
         r"^Second-order PT energy lowering=.*$", r"^Total energy.*$",
         r"^Wrote FCIDUMP.natorb$", r"^G0\(w=.*$")


def _both(deck, capsys, tmp_path, monkeypatch, fcidump_path=None):
    """Run the deck through each package's run_from_config in a directory
    of its own; returns {pkg: (stdout, directory)}."""
    out = {}
    for pkg, parse, run in (
            ("jax", j_parse, lambda c: j_cli.run_from_config(
                c, fcidump=fcidump_path)),
            ("torch", t_parse, lambda c: t_cli.run_from_config(
                c, fcidump=fcidump_path, device="cpu"))):
        d = tmp_path / pkg
        d.mkdir(parents=True)
        monkeypatch.chdir(d)
        capsys.readouterr()
        run(parse(deck))
        out[pkg] = (capsys.readouterr().out, d)
    return out


def _lines(text):
    """The LINES of a log; in the per-iteration lines of the legacy CI the
    det count is left out: a truncated Krylov vector may keep or drop an
    entry whose exact value is 0 by one rounding (the energies and the
    final det list do not move)."""
    out = {p: re.findall(p, text, re.M) for p in LINES}
    for p in (r"^selected_ci iter .*$", r"^trunc_lanc iter .*$"):
        out[p] = [re.sub(r"ndet=\d+ ", "", x) for x in out[p]]
    return out


def _value_err(line):
    """(value, error bar or 0) of an energy line."""
    m = re.search(r"=\s*(-?\d+\.\d+)(?:\s*\+-\s*(\d+\.\d+))?", line)
    return float(m.group(1)), float(m.group(2) or 0.0)


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_cli_legacy_ci_deck_matches_jax(name, capsys, tmp_path, monkeypatch):
    out = _both(LEGACY[name], capsys, tmp_path, monkeypatch)
    j, t = _lines(out["jax"][0]), _lines(out["torch"][0])
    head = ("Selected CI energy=" if name == "selected_ci"
            else "Truncated Lanczos energy=")
    assert head in out["torch"][0]
    assert len(t[r"^" + name + r" iter .*$"]) >= 3
    assert t == j


@pytest.mark.parametrize("name", sorted(OBSERVABLES))
def test_cli_observable_deck_matches_jax(name, fcidump, capsys, tmp_path,
                                         monkeypatch):
    deck = OBSERVABLES[name]
    out = _both(deck, capsys, tmp_path, monkeypatch, fcidump)
    j, t = _lines(out["jax"][0]), _lines(out["torch"][0])
    # eps_pt_big below eps_var makes the PT semistochastic: its two
    # streams differ, so those lines agree to 5 error bars
    for p in (r"^Second-order PT energy lowering=.*$", r"^Total energy.*$"):
        a, b = (np.array([_value_err(y) for y in v[p]]) for v in (t, j))
        assert a.shape == b.shape and len(a), p
        np.testing.assert_array_less(np.abs(a[:, 0] - b[:, 0]),
                                     1.01e-9 + 5 * np.hypot(a[:, 1], b[:, 1]))
        del t[p], j[p]
    assert t == j
    assert t[r"^Variational energy=.*$"]
    if name.startswith("natorb"):
        assert t[r"^Wrote FCIDUMP.natorb$"]
        a, b = (read_fcidump(str(out[k][1] / "FCIDUMP.natorb"))
                for k in ("jax", "torch"))
        np.testing.assert_array_equal(b.orb_sym, a.orb_sym)
        np.testing.assert_allclose(b.h, a.h, rtol=0, atol=1e-12)
        np.testing.assert_allclose(b.eri, a.eri, rtol=0, atol=1e-12)
        assert b.core_energy == a.core_energy
    if name == "natorb_greens":
        assert len(t[r"^G0\(w=.*$"]) == 7
    if name == "active_space":
        res = t_cli.run_hci_pt(t_parse(TS_HCI), t_cli.make_system(
            t_parse(TS_HCI), fcidump, "cpu"), verbose=False)[0]
        e_act = _value_err(t[r"^Variational energy=.*$"][0])[0]
        assert e_act >= res.energies[0] - 1e-9
