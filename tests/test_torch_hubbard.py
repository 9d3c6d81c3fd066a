"""The port's Hubbard determinant systems against the JAX package's: the
momentum-space system (analytic integrals with modular momentum
conservation) and the real-space system (hopping plus on-site U).  Tables,
heat-bath arrays and HF dets must be EQUAL (both packages build them in
numpy float64 with the same operations); energies agree to 1e-10."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo.hci import run_hci as j_hci
from sqmc_tpu.systems.hubbard import system as JH
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo.hci import run_hci as t_hci
from sqmc_tpu_torch.systems.hubbard import system as TH

torch.set_num_threads(1)

HB_FIELDS = ("same_rs", "same_val", "same_start", "same_count", "opp_rs",
             "opp_val", "opp_start", "opp_count")
CASES = {
    "k_2x2": ("k", (2, 2, 1.0, 4.0, 2, 2), {}),
    "k_2x4": ("k", (2, 4, 1.0, 4.0, 2, 2), {}),
    "k_3x3": ("k", (3, 3, 1.0, 2.0, 2, 1), {}),       # odd L: shifted k grid
    "k_1x6": ("k", (1, 6, 1.0, 8.0, 3, 3), {}),
    "real_1x8_open": ("r", (1, 8, 1.0, 4.0, 2, 2), dict(pbc=False)),
    "real_2x3_pbc": ("r", (2, 3, 1.0, 4.0, 2, 2), dict(pbc=True)),
    "real_4x4_pbc": ("r", (4, 4, 1.0, 4.0, 5, 5), dict(pbc=True)),
}


def _make(name):
    kind, args, kw = CASES[name]
    if kind == "k":
        return (JH.make_hubbard_k_system(*args),
                TH.make_hubbard_k_system(*args, device="cpu"))
    return (JH.make_hubbard_real_system(*args, **kw),
            TH.make_hubbard_real_system(*args, device="cpu", **kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_hubbard_system_equals_jax(name):
    """Every table of the system equals the JAX package's, and so does the
    system carried over by convert.system_from_numpy."""
    js, ts = _make(name)
    for s in (ts, convert.system_from_numpy(js, device="cpu")):
        assert (s.name, s.norb, s.nup, s.ndn, s.has_singles) == \
            (js.name, js.norb, js.nup, js.ndn, js.has_singles)
        for f in ("h", "direct", "exchange", "eri", "sing_dir", "sing_exch",
                  "heg_V", "heg_rel", "heg_mod"):
            a, b = getattr(s.table, f), getattr(js.table, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        for f in HB_FIELDS:
            np.testing.assert_array_equal(getattr(s.heatbath, f).numpy(),
                                          np.asarray(getattr(js.heatbath, f)),
                                          err_msg=f)
        assert s.heatbath.max_double == js.heatbath.max_double
        np.testing.assert_array_equal(s.hf_up.view(np.uint64), js.hf_up)
        np.testing.assert_array_equal(s.hf_dn.view(np.uint64), js.hf_dn)
    for k in js.extra:
        np.testing.assert_array_equal(np.asarray(ts.extra[k]),
                                      np.asarray(js.extra[k]), err_msg=k)


def test_hubbard_heatbath_shapes():
    """Hubbard-k rows hold equal magnitudes U/N (so every row sum is a
    multiple of it) and no same-spin entries; real-space Hubbard has
    EMPTY doubles rows (the one flat entry is padding), so the walk's
    pair row sums are all zero there."""
    _, k = _make("k_2x4")
    cnt = k.heatbath.opp_count.numpy()
    val = k.heatbath.opp_val.numpy()
    assert cnt.sum() == len(val) and np.all(np.abs(val) == 4.0 / 8)
    assert int(k.heatbath.same_count.sum()) == 0
    _, r = _make("real_2x3_pbc")
    assert int(r.heatbath.same_count.sum()) == 0
    assert int(r.heatbath.opp_count.sum()) == 0
    assert r.heatbath.opp_val.numpy().tolist() == [0.0]


def test_modular_eri_value_matches_jax():
    """(pq|rs) under modular momentum conservation on random index
    quadruples: the tensor path (torch.remainder, non-negative like
    numpy's %) and the numpy path equal the JAX package's values.  Half
    of the k-differences are negative, where fmod would differ."""
    import jax.numpy as jnp
    js, ts = _make("k_3x3")
    rng = np.random.default_rng(0)
    p, q, r, s = rng.integers(0, js.norb, (4, 4000))
    ref = np.asarray(js.table.eri_value(*(jnp.asarray(x) for x in (p, q, r, s))))
    got = ts.table.eri_value(*(torch.as_tensor(x) for x in (p, q, r, s))).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ts.table.eri_value_np(p, q, r, s), ref)
    assert 0 < np.count_nonzero(ref) < len(ref)
    rel = np.asarray(js.table.heg_rel)
    d = rel[p] - rel[q] + rel[r] - rel[s]
    assert (d < 0).any() and np.count_nonzero(ref) > np.count_nonzero(
        np.all(d == 0, axis=1))        # umklapp terms are present


@pytest.mark.parametrize("name", ["k_2x4", "real_2x3_pbc"])
def test_hubbard_hci_matches_jax(name):
    """HCI at eps_var 1e-9 through both packages: the same det count and
    the same energy to 1e-10 (the Davidson tolerance)."""
    js, ts = _make(name)
    kw = dict(eps_var=1e-9, eps_var_sched=[1e-9] * 20, max_iters=40,
              verbose=False)
    jr, tr = j_hci(js, **kw), t_hci(ts, **kw)
    assert len(tr.up) == len(jr.up)
    assert abs(float(tr.energies[0]) - float(jr.energies[0])) < 1e-10


def test_hubbard_k_and_real_space_are_one_hamiltonian():
    """The 2x2 periodic cluster in both bases: the ground energies of the
    HF-connected sectors agree to 1e-9 (-5.6568542, the value
    tests/test_cli.py holds the JAX CLI to)."""
    kw = dict(eps_var=1e-9, eps_var_sched=[1e-9] * 20, max_iters=40,
              verbose=False)
    k = TH.make_hubbard_k_system(2, 2, 1.0, 4.0, 2, 2, device="cpu")
    e_k = float(t_hci(k, **kw).energies[0])
    assert e_k == pytest.approx(-5.6568542, abs=1e-6)
