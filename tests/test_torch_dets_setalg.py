"""Packed determinants and sorted set algebra: the port (int64 words,
flipped-key order) against the JAX package (uint64 words).  Everything is
integer, so every comparison is exact; norb = 64 puts bit 63 in play and
norb = 100 gives two words."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sqmc_tpu import dets as jd
from sqmc_tpu.ops import setalg as js
from sqmc_tpu_torch import dets as td
from sqmc_tpu_torch.ops import setalg as ts


def _random_dets(n, norb, nel, seed):
    rng = np.random.default_rng(seed)
    out = np.stack([jd.det_from_orbs(rng.choice(norb, nel, replace=False), norb)
                    for _ in range(n)])
    return out                                   # uint64 [n, W]


def _t(words):
    return torch.as_tensor(words.view(np.int64))


@pytest.mark.parametrize("norb", [19, 64, 100])
def test_bits_roundtrip_and_word_ops(norb):
    w = _random_dets(300, norb, min(norb // 2, 33), seed=norb)
    if norb == 64:
        w[0, 0] |= np.uint64(1) << np.uint64(63)
    bits_j = np.asarray(jd.to_bits(jnp.asarray(w), norb))
    bits_t = td.to_bits(_t(w), norb).numpy()
    np.testing.assert_array_equal(bits_t, bits_j)
    np.testing.assert_array_equal(td.from_bits(torch.as_tensor(bits_t), norb)
                                  .numpy().view(np.uint64), w)
    np.testing.assert_array_equal(td.popcount(_t(w)).numpy(),
                                  np.asarray(jd.popcount(jnp.asarray(w))))
    rng = np.random.default_rng(1)
    orb = rng.integers(0, norb, len(w))
    for jf, tf in ((jd.set_orb, td.set_orb), (jd.clear_orb, td.clear_orb)):
        np.testing.assert_array_equal(
            tf(_t(w), torch.as_tensor(orb)).numpy().view(np.uint64),
            np.asarray(jf(jnp.asarray(w), jnp.asarray(orb, jnp.int32))))
    np.testing.assert_array_equal(
        td.get_orb(_t(w), torch.as_tensor(orb)).numpy(),
        np.asarray(jd.get_orb(jnp.asarray(w), jnp.asarray(orb, jnp.int32))))
    lo = rng.integers(0, norb + 1, len(w))
    hi = rng.integers(0, norb + 1, len(w))
    np.testing.assert_array_equal(
        td.count_below(_t(w), torch.as_tensor(lo), torch.as_tensor(hi)).numpy(),
        np.asarray(jd.count_below(jnp.asarray(w), jnp.asarray(lo, jnp.int32),
                                  jnp.asarray(hi, jnp.int32))))
    assert td.orbs_from_det(w[0].view(np.int64), norb) == jd.orbs_from_det(w[0], norb)
    np.testing.assert_array_equal(
        td.occ_orbitals(torch.as_tensor(bits_t), 5).numpy(),
        np.asarray(jd.occ_orbitals(jnp.asarray(bits_j), 5)))


@pytest.mark.parametrize("norb", [19, 64, 100])
def test_excitation_positions_and_signs(norb):
    nel = min(norb // 2, 20)
    a = _random_dets(400, norb, nel, seed=2)
    b = a.copy()
    rng = np.random.default_rng(3)
    for i in range(len(b)):             # move one or two electrons
        occ = jd.orbs_from_det(a[i], norb)
        emp = [o for o in range(norb) if o not in occ]
        k = 1 + i % 2
        new = sorted(set(occ) - set(rng.choice(occ, k, replace=False))
                     | set(rng.choice(emp, k, replace=False)))
        b[i] = jd.det_from_orbs(new, norb)
    pj = [np.asarray(x) for x in jd.diff2_words(jnp.asarray(a), jnp.asarray(b))]
    pt = [x.numpy() for x in td.diff2_words(_t(a), _t(b))]
    for x, y in zip(pt, pj):
        np.testing.assert_array_equal(x, y)
    rj = [np.asarray(x) for x in jd.diff2_words(jnp.asarray(b), jnp.asarray(a))]
    two = pj[2] == 2
    args_j = [jnp.asarray(x[two], jnp.int32) for x in (pj[0], pj[1], rj[0], rj[1])]
    args_t = [torch.as_tensor(x[two]) for x in (pj[0], pj[1], rj[0], rj[1])]
    np.testing.assert_array_equal(
        td.double_sign_same_spin_words(_t(a[two]), _t(b[two]), *args_t).numpy(),
        np.asarray(jd.double_sign_same_spin_words(
            jnp.asarray(a[two]), jnp.asarray(b[two]), *args_j)))
    bits = td.to_bits(_t(a[two]), norb)
    np.testing.assert_array_equal(
        td.double_excite_sign_same_spin(bits, *args_t).numpy(),
        np.asarray(jd.double_excite_sign_same_spin(jnp.asarray(bits.numpy()),
                                                   *args_j)))
    one = pj[2] == 1
    p, r = pj[0][one], rj[0][one]
    np.testing.assert_array_equal(
        td.single_sign_words(_t(a[one]), torch.as_tensor(p),
                             torch.as_tensor(r)).numpy(),
        np.asarray(jd.single_sign_words(jnp.asarray(a[one]),
                                        jnp.asarray(p, jnp.int32),
                                        jnp.asarray(r, jnp.int32))))
    np.testing.assert_array_equal(
        td.single_excite_sign(td.to_bits(_t(a[one]), norb), torch.as_tensor(p),
                              torch.as_tensor(r)).numpy(),
        np.asarray(jd.single_excite_sign(jd.to_bits(jnp.asarray(a[one]), norb),
                                         jnp.asarray(p, jnp.int32),
                                         jnp.asarray(r, jnp.int32))))


@pytest.mark.parametrize("norb", [19, 64, 100])
def test_setalg_indices_equal_jax(norb):
    up = _random_dets(500, norb, 5, seed=10)
    dn = _random_dets(500, norb, 4, seed=11)
    if norb == 64:                      # bit 63: unsigned order != signed
        up[::7, 0] |= np.uint64(1) << np.uint64(63)
    up = np.concatenate([up, up[:60]])  # duplicates
    dn = np.concatenate([dn, dn[:60]])
    np.testing.assert_array_equal(ts.lexsort_dets(_t(up), _t(dn)).numpy(),
                                  js.lexsort_dets(up, dn))
    wts = np.random.default_rng(4).standard_normal(len(up))
    uj, dj, (pj,), ij = js.unique_dets(up, dn, [wts])
    ut, dt, (pt,), it = ts.unique_dets(_t(up), _t(dn), [torch.as_tensor(wts)])
    np.testing.assert_array_equal(ut.numpy().view(np.uint64), uj)
    np.testing.assert_array_equal(dt.numpy().view(np.uint64), dj)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-14)
    q_up = np.concatenate([uj[::3], _random_dets(50, norb, 5, seed=12)])
    q_dn = np.concatenate([dj[::3], _random_dets(50, norb, 4, seed=13)])
    np.testing.assert_array_equal(
        ts.search_dets(ut, dt, _t(q_up), _t(q_dn)).numpy(),
        js.search_dets(uj, dj, q_up, q_dn))
    np.testing.assert_array_equal(
        ts.setdiff_dets(_t(q_up), _t(q_dn), _t(up), _t(dn)).numpy(),
        js.setdiff_dets(q_up, q_dn, up, dn))
    np.testing.assert_array_equal(
        ts.lex_less_eq(_t(up[:-1]), _t(dn[:-1]), _t(up[1:]), _t(dn[1:]))[0].numpy(),
        js.keys_less(up[:-1], dn[:-1], up[1:], dn[1:]))


def test_sentinel_sorts_last():
    w = torch.tensor([td.SENTINEL, 5, -(1 << 63), 0], dtype=torch.int64)
    order = torch.argsort(td.flip(w), stable=True)
    # unsigned order: 0 < 5 < 2**63 < 2**64 - 1
    assert order.tolist() == [3, 1, 2, 0]


def test_ordered_sums_match_jax():
    """The COO Davidson matvec and unique_dets's payload sums, both now
    summed with index_put_(accumulate=True) (ordered on the card, ROADMAP
    C7), against the JAX package's on a matrix and a det list with many
    duplicates: 1e-12 and 1e-14, the tolerances of the parity tests."""
    from sqmc_tpu.algo import davidson as jdav
    from sqmc_tpu.algo.sparseham import SparseHam as JH
    from sqmc_tpu_torch import convert
    from sqmc_tpu_torch.algo import davidson as tdav
    rng = np.random.default_rng(7)
    n, nnz = 300, 6000
    r = np.minimum(rng.zipf(1.5, nnz), n - 1) - 1
    c = rng.integers(0, n, nnz)
    keep = np.minimum(r, c) < np.maximum(r, c)
    H = JH(n=n, rows=np.minimum(r, c)[keep], cols=np.maximum(r, c)[keep],
           vals=rng.standard_normal(int(keep.sum())),
           diag=rng.standard_normal(n))
    Ht = convert.sparse_ham_from_numpy(H, device="cpu")
    v = rng.standard_normal((n, 3))
    np.testing.assert_allclose(tdav.matvec(Ht, torch.as_tensor(v)).numpy(),
                               np.asarray(jdav.matvec(H, v)), rtol=0,
                               atol=1e-12)
    up = rng.integers(0, 8, (5000, 1)).astype(np.uint64)
    dn = rng.integers(0, 8, (5000, 1)).astype(np.uint64)
    w = rng.standard_normal((5000, 2))
    _, _, (pj,), _ = js.unique_dets(up, dn, [w])
    _, _, (pt,), _ = ts.unique_dets(_t(up), _t(dn), [torch.as_tensor(w)])
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-12)
