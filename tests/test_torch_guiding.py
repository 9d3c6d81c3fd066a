"""The port's guiding wavefunctions against the JAX package's: psi_g of
both kinds on random determinants, for k = 2..5 electrons per spin (the
cofactor forms up to 4, torch.linalg.det at 5), to 1e-12 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqmc_tpu import dets as jdets
from sqmc_tpu.algo import guiding as JG
from sqmc_tpu.systems.hubbard.system import make_hubbard_real_system as j_real
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import guiding as TG

torch.set_num_threads(1)


def _random_dets(norb, k, n, seed):
    rng = np.random.default_rng(seed)
    up = np.stack([jdets.det_from_orbs(rng.choice(norb, k, replace=False), norb)
                   for _ in range(n)])
    dn = np.stack([jdets.det_from_orbs(rng.choice(norb, k, replace=False), norb)
                   for _ in range(n)])
    return up, dn


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_gutzwiller_matches_jax(k):
    """Gutzwiller x free-fermion psi_g on the 2x5 open lattice (10 sites,
    no degeneracy at these fillings' Fermi levels is needed: only the
    values are compared), g = 0.7: eval_guiding equals JAX's to 1e-12 and
    the host loop eval_guiding_np to 1e-12."""
    norb = 10
    js = j_real(2, 5, 1.0, 4.0, k, k, pbc=False, with_heatbath=False)
    jg = JG.make_gutzwiller_guiding(js, g=0.7)
    ts = convert.system_from_numpy(js, device="cpu")
    tg = TG.make_gutzwiller_guiding(ts, g=0.7)
    # the port diagonalizes h itself: same orbitals up to the eigensolver
    np.testing.assert_allclose(tg.phi_up.numpy(), np.asarray(jg.phi_up),
                               rtol=0, atol=1e-13)
    cg = convert.guiding_from_numpy(jg, device="cpu")
    up, dn = _random_dets(norb, k, 300, seed=k)
    ref = np.asarray(JG.eval_guiding(jg, "gutzwiller", jnp.asarray(up),
                                     jnp.asarray(dn), norb, k, k))
    tu, td = convert.words_to_torch(up, "cpu"), convert.words_to_torch(dn, "cpu")
    for g in (tg, cg):
        got = TG.eval_guiding(g, "gutzwiller", tu, td, norb, k, k).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
    host = TG.eval_guiding_np(tg, "gutzwiller", up, dn, norb, k, k)
    np.testing.assert_allclose(host, ref, rtol=1e-11, atol=1e-15)


def test_batched_det_forms():
    """Cofactor forms (k <= 4) and the library call (k = 5, 6) against
    numpy's determinant on random matrices, 1e-12 relative."""
    rng = np.random.default_rng(1)
    for k in range(1, 7):
        m = rng.normal(size=(50, k, k))
        got = TG._batched_det(torch.as_tensor(m)).numpy()
        np.testing.assert_allclose(got, np.linalg.det(m), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("norb", [8, 64])
def test_table_guiding_matches_jax(norb):
    """'table' guiding: values of listed dets, 0 for absent ones, equal to
    the JAX package's exactly.  norb = 64 puts orbital 63 in play, so some
    words have bit 63 set: negative as int64, and found only because the
    search compares flipped words."""
    rng = np.random.default_rng(2)
    up, dn = _random_dets(norb, 2, 200, seed=3)
    if norb == 64:
        up[::3] |= np.uint64(1) << np.uint64(63)
        assert (up.view(np.int64) < 0).any()
    _, first = np.unique(np.stack([up[:, 0], dn[:, 0]], 1), axis=0,
                         return_index=True)
    up, dn = up[first], dn[first]
    vals = rng.normal(size=len(up))
    n_tab = len(up) // 2
    jg = JG.make_table_guiding(up[:n_tab], dn[:n_tab], vals[:n_tab])
    tg = TG.make_table_guiding(up[:n_tab], dn[:n_tab], vals[:n_tab],
                               device="cpu")
    cg = convert.guiding_from_numpy(jg, device="cpu")
    ref = np.asarray(JG.eval_guiding(jg, "table", jnp.asarray(up),
                                     jnp.asarray(dn), norb, 2, 2))
    tu, td = convert.words_to_torch(up, "cpu"), convert.words_to_torch(dn, "cpu")
    for g in (tg, cg):
        got = TG.eval_guiding(g, "table", tu, td, norb, 2, 2).numpy()
        np.testing.assert_array_equal(got, ref)
    assert np.count_nonzero(ref) == n_tab
    np.testing.assert_array_equal(
        TG.eval_guiding_np(tg, "table", up, dn, norb, 2, 2), ref)


def test_unknown_kind_raises():
    g = TG.empty_guiding(device="cpu")
    z = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError):
        TG.eval_guiding(g, "jastrow", z, z, 4, 1, 1)
    with pytest.raises(ValueError):
        TG.eval_guiding_np(g, "jastrow", z.numpy(), z.numpy(), 4, 1, 1)
