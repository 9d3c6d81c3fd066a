"""The port's PT (algo/pt.py) against the JAX package's (sqmc_tpu/algo/pt.py)
on the same variational wavefunction (JAX's HCI result carried over):

  * deterministic PT-2 and n_connected on the tiny HEG, on random chem
    integrals with singles, and on HEG-14 at eps_var 2e-3 / eps_pt 2e-6,
    to 1e-12 (same terms, other summation orders);
  * estimate_n_connections and do_pt's mode switch / eps_pt_big choice,
    exactly;
  * the semistochastic estimator within 5 sigma of JAX's deterministic
    value (the two random streams differ, so only the distribution can
    match);
  * sample_alias frequencies against alias_probabilities by chi^2.
"""

import numpy as np
import pytest
import torch

from reference_impl import random_integrals
from sqmc_tpu.algo import pt as JP
from sqmc_tpu.algo.hci import run_hci as j_hci
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import pt as TP
from sqmc_tpu_torch.ops.alias import (alias_probabilities, sample_alias,
                                      setup_alias_np)
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.heg.system import make_heg_system as t_heg

CASES = {                      # name: (eps_var, eps_pt, eps_pt_big)
    "heg": (1e-4, 1e-7, 1e-5),
    "chem": (1e-2, 1e-5, 1e-4),
    "heg14": (2e-3, 2e-6, 2e-5),
}


def _systems(name):
    from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
    if name == "heg":
        return j_heg(3, 1.0, 4, 2, 1.6), t_heg(3, 1.0, 4, 2, 1.6, device="cpu")
    if name == "heg14":
        return j_heg(3, 0.5, 14, 7, 1.49), t_heg(3, 0.5, 14, 7, 1.49, device="cpu")
    import jax.numpy as jnp
    from sqmc_tpu import dets as jd
    from sqmc_tpu.systems.base import FermionSystem
    from sqmc_tpu.systems.chem.integrals import IntegralTable
    from sqmc_tpu.systems.heatbath import build_heatbath
    # random integrals on a spread of orbital energies, so HCI selects a
    # part of the 784-det space and PT has external dets
    h, eri, core, _ = random_integrals(8, seed=3)
    h = np.diag(np.arange(8.0)) + 0.1 * h
    eri = 0.1 * eri
    table = IntegralTable.from_dense_arrays(h, eri, core, np.ones(8, np.int32))
    js = FermionSystem(name="chem", norb=8, nup=2, ndn=2, table=table,
                       heatbath=build_heatbath(table),
                       orb_sym_arr=jnp.ones(8, jnp.int32), has_singles=True,
                       hf_up=jd.det_from_orbs(range(2), 8),
                       hf_dn=jd.det_from_orbs(range(2), 8), extra={})
    return js, make_system_from_arrays(h, eri, core, 2, 2, device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, jax system, port system, jax HCI result, the same result
    carried over to the port)."""
    name = request.param
    js, ts = _systems(name)
    eps_var = CASES[name][0]
    jr = j_hci(js, eps_var=eps_var, eps_var_sched=[eps_var] * 5,
               verbose=False)
    return name, js, ts, jr, convert.hci_result_from_numpy(jr, device="cpu")


def test_deterministic_pt_matches_jax(case):
    name, js, ts, jr, tr = case
    eps_pt = CASES[name][1]
    e_j, n_j = JP.second_order_pt(js, jr.up, jr.dn, jr.wts[:, 0],
                                  jr.energies[0], eps_pt, verbose=False)
    e_t, n_t = TP.second_order_pt(ts, tr.up, tr.dn, tr.wts[:, 0],
                                  tr.energies[0], eps_pt, verbose=False)
    assert n_t == n_j > len(jr.up)
    assert e_j < 0 and abs(e_t - e_j) < 1e-12


def test_estimate_n_connections_equal(case):
    name, js, ts, jr, tr = case
    for eps in (CASES[name][1], 1e-4, 1e-3):
        assert (TP.estimate_n_connections(ts, tr.up, tr.dn, tr.wts[:, 0], eps)
                == JP.estimate_n_connections(js, jr.up, jr.dn, jr.wts[:, 0],
                                             eps))


def _record_do_pt(monkeypatch, mod, result_cls, system, res, **kw):
    """Run mod.do_pt with both PT evaluators stubbed; returns (mode,
    [eps of each deterministic call], eps_pt_big handed to the sampler)."""
    seen = dict(det=[], big=None)

    def det(system, up, dn, wts, var_energy, eps, **k):
        seen["det"].append(eps)
        return -1e-3, 7

    def alias(system, up, dn, wts, var_energy, eps_pt, eps_pt_big, *a, **k):
        seen["big"] = eps_pt_big
        return result_cls(pt_diff=0.0, std_dev=0.0, n_samples=1, e_tot=0.0)

    monkeypatch.setattr(mod, "second_order_pt", det)
    monkeypatch.setattr(mod, "second_order_pt_alias", alias)
    out = mod.do_pt(system, res.up, res.dn, res.wts[:, 0], res.diag,
                    float(res.energies[0]), verbose=False, **kw)
    return out["mode"], seen["det"], seen["big"], out["n_connected"]


@pytest.mark.parametrize("n_max", [10 ** 9, 20_000, 2_000, 50])
def test_do_pt_modes_equal(case, monkeypatch, n_max):
    """Same n_max_connections -> same mode, same deterministic eps and the
    same auto-chosen eps_pt_big; eps_pt_big_energy skips the
    deterministic part in both."""
    name, js, ts, jr, tr = case
    eps_var, eps_pt, _ = CASES[name]
    for extra in ({}, {"eps_pt_big_energy": -2e-3}):
        kw = dict(eps_var=eps_var, eps_pt=eps_pt, n_max_connections=n_max,
                  **extra)
        j = _record_do_pt(monkeypatch, JP, JP.StochasticPTResult, js, jr, **kw)
        t = _record_do_pt(monkeypatch, TP, TP.StochasticPTResult, ts, tr, **kw)
        assert t == j


def test_semistochastic_pt_within_5_sigma(case):
    """do_pt semistochastic (a deterministic part at eps_pt_big plus the
    sampled difference, n_mc 20, at most 300 samples) against JAX's
    deterministic PT at eps_pt."""
    name, js, ts, jr, tr = case
    eps_var, eps_pt, eps_pt_big = CASES[name]
    e_j, _ = JP.second_order_pt(js, jr.up, jr.dn, jr.wts[:, 0],
                                jr.energies[0], eps_pt, verbose=False)
    out = TP.do_pt(ts, tr.up, tr.dn, tr.wts[:, 0], tr.diag,
                   float(tr.energies[0]), eps_var, eps_pt,
                   eps_pt_big=eps_pt_big, target_error=abs(e_j) * 0.01,
                   n_mc=20, seed=3, verbose=False, max_pt_samples=300)
    assert out["mode"] == "semistochastic" and out["n_samples"] >= 10
    assert out["pt_err"] > 0
    assert abs(out["pt"] - e_j) < 5 * out["pt_err"]


def test_sample_alias_frequencies():
    """200,000 draws from alias tables of a skewed 40-bin distribution:
    chi^2 against alias_probabilities below 100 (39 degrees of freedom;
    P(chi^2 > 100) ~ 1e-7), at a fixed seed."""
    rng = np.random.default_rng(0)
    p = rng.random(40) ** 3
    p /= p.sum()
    J, q = setup_alias_np(p)
    np.testing.assert_allclose(alias_probabilities(J, q), p, atol=1e-12)
    gen = torch.Generator().manual_seed(5)
    n = 200_000
    idx = sample_alias(gen, torch.as_tensor(J), torch.as_tensor(q), n)
    assert idx.dtype == torch.int32 and idx.shape == (n,)
    counts = np.bincount(idx.numpy(), minlength=40)
    chi2 = np.sum((counts - n * p) ** 2 / (n * p))
    assert chi2 < 100


def test_unported_options_raise():
    s = t_heg(3, 1.0, 4, 2, 1.6, device="cpu")
    up = torch.as_tensor(s.hf_up[None])
    dn = torch.as_tensor(s.hf_dn[None])
    w = np.ones(1)
    with pytest.raises(ValueError):
        TP.do_pt(s, up, dn, w, None, 1.0, 1e-3, 1e-6, device=True)
    with pytest.raises(ValueError):
        TP.second_order_pt(s, up, dn, w, 1.0, 1e-6, mesh=object())
