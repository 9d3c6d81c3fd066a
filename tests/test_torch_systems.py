"""Systems of the port against the JAX package on the same inputs:
Slater-Condon elements (float64, to 1e-12: the two packages sum the same
terms in different orders), heat-bath tables (equal), and alias tables
(compared through the probabilities they imply, to 1e-12, because the
JAX package may build them with its native helper)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reference_impl import random_integrals
from sqmc_tpu import dets as jd
from sqmc_tpu.ops.alias import setup_alias_np as j_alias
from sqmc_tpu.systems.chem import slater as jsl
from sqmc_tpu.systems.chem.integrals import IntegralTable as JTable
from sqmc_tpu.systems.heatbath import build_heatbath as j_hb
from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
from sqmc_tpu_torch import dets as td
from sqmc_tpu_torch.ops.alias import alias_probabilities, setup_alias_np
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.chem import slater as tsl
from sqmc_tpu_torch.systems.heatbath import build_heatbath as t_hb
from sqmc_tpu_torch.systems.heg.system import make_heg_system as t_heg

TOL = 1e-12


def _chem_pair():
    h, eri, core, _ = random_integrals(6, seed=3)
    jt = JTable.from_dense_arrays(h, eri, core, np.ones(6, np.int32))
    ts = make_system_from_arrays(h, eri, core, nup=3, ndn=2, device="cpu")
    return jt, ts.table, 6, 3, 2


def _heg_pair():
    js = j_heg(3, 1.0, 4, 2, 1.6)
    return js.table, t_heg(3, 1.0, 4, 2, 1.6, device="cpu").table, js.norb, 2, 2


def _random_det_pairs(norb, nup, ndn, n, seed):
    """Det pairs at excitation levels 0..3 (singles and doubles dominate)."""
    rng = np.random.default_rng(seed)

    def det(k):
        return jd.det_from_orbs(sorted(rng.choice(norb, k, replace=False)), norb)

    def move(w, k):
        occ = jd.orbs_from_det(w, norb)
        emp = [o for o in range(norb) if o not in occ]
        k = min(k, len(occ), len(emp))
        new = (set(occ) - set(rng.choice(occ, k, replace=False))
               | set(rng.choice(emp, k, replace=False)))
        return jd.det_from_orbs(sorted(new), norb)

    ui, di, uj, dj = [], [], [], []
    for i in range(n):
        u, d = det(nup), det(ndn)
        ku, kd = [(0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (1, 1), (2, 1)][i % 7]
        ui.append(u); di.append(d); uj.append(move(u, ku)); dj.append(move(d, kd))
    return [np.stack(x) for x in (ui, di, uj, dj)]


@pytest.mark.parametrize("which", ["chem", "heg"])
def test_slater_elements_match_jax(which):
    jt, tt, norb, nup, ndn = _chem_pair() if which == "chem" else _heg_pair()
    ui, di, uj, dj = _random_det_pairs(norb, nup, ndn, 350, seed=7)
    jb = [jd.to_bits(jnp.asarray(x), norb) for x in (ui, di, uj, dj)]
    tb = [td.to_bits(torch.as_tensor(x.view(np.int64)), norb)
          for x in (ui, di, uj, dj)]
    np.testing.assert_allclose(tsl.diag_elements(tt, tb[0], tb[1]).numpy(),
                               np.asarray(jsl.diag_elements(jt, jb[0], jb[1])),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tsl.pair_matrix_elements(tt, *tb).numpy(),
        np.asarray(jsl.pair_matrix_elements(jt, *jb)), rtol=0, atol=TOL)
    # word-level per-class kernels (sparse-H builder)
    w = [torch.as_tensor(x.view(np.int64)) for x in (ui, di, uj, dj)]
    n_up = np.asarray(jd.popcount(jnp.asarray(ui & ~uj)))
    n_dn = np.asarray(jd.popcount(jnp.asarray(di & ~dj)))
    m = (n_up == 2) & (n_dn == 0)
    np.testing.assert_allclose(
        tsl.same_spin_double_words(tt, w[0][m], w[2][m]).numpy(),
        np.asarray(jsl.same_spin_double_words(jt, jnp.asarray(ui[m]),
                                              jnp.asarray(uj[m]))),
        rtol=0, atol=TOL)
    m = (n_up == 1) & (n_dn == 1)
    np.testing.assert_allclose(
        tsl.opp_spin_double_words(tt, w[0][m], w[2][m], w[1][m], w[3][m]).numpy(),
        np.asarray(jsl.opp_spin_double_words(
            jt, *[jnp.asarray(x[m]) for x in (ui, uj, di, dj)])),
        rtol=0, atol=TOL)
    m = (n_up == 1) & (n_dn == 0)
    np.testing.assert_allclose(
        tsl.single_words(tt, w[0][m], w[2][m], w[1][m], norb).numpy(),
        np.asarray(jsl.single_words(jt, jnp.asarray(ui[m]), jnp.asarray(uj[m]),
                                    jnp.asarray(di[m]), norb)),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("which", ["chem", "heg"])
def test_heatbath_tables_equal(which):
    jt, tt, *_ = _chem_pair() if which == "chem" else _heg_pair()
    a, b = j_hb(jt), t_hb(tt)
    for f in ("same_rs", "same_start", "same_count", "opp_rs", "opp_start",
              "opp_count"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    for f in ("same_val", "opp_val"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert b.max_double == a.max_double


def test_heg_system_matches_jax():
    js, ts = j_heg(3, 0.5, 14, 7, 1.49), t_heg(3, 0.5, 14, 7, 1.49, device="cpu")
    assert ts.norb == js.norb == 19 and not ts.has_singles
    assert ts.extra["energy_hf"] == pytest.approx(js.extra["energy_hf"], abs=TOL)
    assert ts.extra["energy_madelung"] == pytest.approx(
        js.extra["energy_madelung"], abs=TOL)
    np.testing.assert_array_equal(ts.table.heg_V.numpy(), np.asarray(js.table.heg_V))
    np.testing.assert_array_equal(ts.hf_up.view(np.uint64), js.hf_up)


@pytest.mark.parametrize("K", [1, 2, 7, 64])
def test_alias_tables_imply_same_probabilities(K):
    rng = np.random.default_rng(K)
    p = rng.random(K) ** 3
    p[rng.random(K) < 0.2] = 0.0
    p = p / p.sum() if p.sum() > 0 else np.full(K, 1.0 / K)
    Jt, qt = setup_alias_np(p)
    Jj, qj = j_alias(p)
    np.testing.assert_allclose(alias_probabilities(Jt, qt), p, rtol=0, atol=TOL)
    np.testing.assert_allclose(alias_probabilities(Jt, qt),
                               alias_probabilities(Jj, qj), rtol=0, atol=TOL)


def _default_device_calls():
    from sqmc_tpu_torch import convert
    h, eri, core, _ = random_integrals(4, seed=1)
    return {
        "make_heg_system": lambda: t_heg(3, 1.0, 4, 2, 1.6).table.h,
        "make_system_from_arrays":
            lambda: make_system_from_arrays(h, eri, core, 2, 2).table.h,
        "words_to_torch": lambda: convert.words_to_torch(
            np.arange(4, dtype=np.uint64)),
    }


@pytest.mark.parametrize("name", ["make_heg_system", "make_system_from_arrays",
                                  "words_to_torch"])
def test_entry_points_default_to_the_card(name):
    """Called without `device`, a constructor or loader builds on the card:
    with a card its tensors lie there; without one it raises instead of
    building on the CPU."""
    call = _default_device_calls()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
