"""The port's legacy CI and matrix-free Lanczos (sqmc_tpu_torch/algo/
legacy_ci.py) against the JAX package's on the 2x2 momentum-space Hubbard
cluster (2 + 2 electrons) and the 4-electron electron gas: apply_h (the
same union det list, y within 1e-12), the per-iteration energies and
final dets of selected CI and truncated Lanczos (1e-10), Lanczos over a
fixed list (1e-9) and over the whole Hubbard space (1e-9, and a 2x3
real-space lattice against dense eigh)."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo import legacy_ci as JL
from sqmc_tpu.algo.hci import run_hci as j_run_hci
from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
from sqmc_tpu.systems.hubbard.system import make_hubbard_k_system as j_hubk
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import legacy_ci as TL
from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
from sqmc_tpu_torch.ops import setalg
from sqmc_tpu_torch.systems.heg.system import make_heg_system as t_heg
from sqmc_tpu_torch.systems.hubbard.system import (make_hubbard_k_system as
                                                   t_hubk,
                                                   make_hubbard_real_system)

torch.set_num_threads(1)


def _u64(t):
    return t.cpu().numpy().view(np.uint64)


def _t(words):
    return convert.words_to_torch(words, device="cpu")


@pytest.fixture(scope="module")
def systems():
    """name -> (JAX system, port system, JAX det list to act on)."""
    jh = j_hubk(2, 2, 1.0, 4.0, 2, 2)
    th = t_hubk(2, 2, 1.0, 4.0, 2, 2, device="cpu")
    up, dn, _, _ = _full_space(jh)
    je = j_heg(3, 1.0, 4, 2, 1.6)
    te = t_heg(3, 1.0, 4, 2, 1.6, device="cpu")
    r = j_run_hci(je, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
                  verbose=False)
    return {"hubbardk": (jh, th, (up, dn)), "heg": (je, te, (r.up, r.dn))}


def _same_coefs(got, want):
    """Equal coefficient magnitudes as multisets.  Truncation ranks by |c|,
    and symmetry-equivalent dets tie there up to the last ulp, so the two
    packages may keep a different member of a tied orbit in a Krylov
    vector: the same dets and energies, the coefficients permuted within
    the orbit."""
    np.testing.assert_allclose(np.sort(np.abs(got)), np.sort(np.abs(want)),
                               rtol=0, atol=1e-12)


def _full_space(s):
    from itertools import combinations
    from sqmc_tpu import dets
    from sqmc_tpu.ops import setalg as js
    ups = np.stack([dets.det_from_orbs(c, s.norb)
                    for c in combinations(range(s.norb), s.nup)])
    dns = np.stack([dets.det_from_orbs(c, s.norb)
                    for c in combinations(range(s.norb), s.ndn)])
    up = np.repeat(ups, len(dns), axis=0)
    dn = np.tile(dns, (len(ups), 1))
    o = js.lexsort_dets(up, dn)
    return up[o], dn[o], ups, dns


@pytest.mark.parametrize("name", ["hubbardk", "heg"])
@pytest.mark.parametrize("n_init", [None, 3])
def test_apply_h_matches_jax(systems, name, n_init):
    js, ts, (up, dn) = systems[name]
    c = np.random.default_rng(5).standard_normal(len(up))
    ju, jd, jy, jc = JL.apply_h(js, up, dn, c, n_initiators=n_init)
    tu, td, ty, tc = TL.apply_h(ts, _t(up), _t(dn), c, n_initiators=n_init)
    np.testing.assert_array_equal(_u64(tu), ju)
    np.testing.assert_array_equal(_u64(td), jd)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert n_init is None or len(ju) < len(up) + 1000


@pytest.mark.parametrize("name", ["hubbardk", "heg"])
@pytest.mark.parametrize("kw", [dict(iters=4, n_initiators=5, n_truncate=8),
                                dict(iters=3, n_initiators=[2, 6, 20],
                                     n_truncate=[6, 12, 30])])
def test_selected_ci_matches_jax(systems, name, kw):
    js, ts, _ = systems[name]
    jr = JL.perform_selected_ci(js, **kw)
    tr = TL.perform_selected_ci(ts, **kw)
    np.testing.assert_allclose(tr.energies_per_iter, jr.energies_per_iter,
                               rtol=0, atol=1e-10)
    assert tr.energy == pytest.approx(jr.energy, abs=1e-10)
    np.testing.assert_array_equal(_u64(tr.up), jr.up)
    np.testing.assert_array_equal(_u64(tr.dn), jr.dn)
    _same_coefs(tr.coef, jr.coef)


@pytest.mark.parametrize("name", ["hubbardk", "heg"])
@pytest.mark.parametrize("kw", [dict(iters=6, n_initiators=10, n_truncate=12),
                                dict(iters=5, n_initiators=100,
                                     n_truncate=200)])
def test_truncated_lanczos_matches_jax(systems, name, kw):
    js, ts, _ = systems[name]
    jr = JL.perform_truncated_lanczos(js, **kw)
    tr = TL.perform_truncated_lanczos(ts, **kw)
    assert len(tr.energies_per_iter) == len(jr.energies_per_iter) > 1
    np.testing.assert_allclose(tr.energies_per_iter, jr.energies_per_iter,
                               rtol=0, atol=1e-10)
    assert tr.energy == pytest.approx(jr.energy, abs=1e-10)
    np.testing.assert_array_equal(_u64(tr.up), jr.up)
    np.testing.assert_array_equal(_u64(tr.dn), jr.dn)
    _same_coefs(tr.coef, jr.coef)


def test_multiplet_start_matches_jax(systems):
    """selected CI and truncated Lanczos from a given (up, dn, coef) start
    (the degenerate-HF multiplet form), and the result converter."""
    js, ts, (up, dn) = systems["hubbardk"]
    start = (up[:4], dn[:4], np.array([0.5, -0.5, 0.5, 0.5]))
    tstart = (_t(up[:4]), _t(dn[:4]), start[2])
    for fn in ("perform_selected_ci", "perform_truncated_lanczos"):
        jr = getattr(JL, fn)(js, 4, 50, 100, start=start)
        tr = getattr(TL, fn)(ts, 4, 50, 100, start=tstart)
        np.testing.assert_allclose(tr.energies_per_iter, jr.energies_per_iter,
                                   rtol=0, atol=1e-10)
        cr = convert.legacy_ci_result_from_numpy(jr, device="cpu")
        assert torch.equal(cr.up, tr.up) and torch.equal(cr.dn, tr.dn)
        assert cr.energy == pytest.approx(tr.energy, abs=1e-10)


def test_lanczos_on_the_fly_matches_jax(systems):
    """Matrix-free Lanczos over the electron gas's HCI list (in a shuffled
    order: the vector comes back in the caller's order)."""
    js, ts, (up, dn) = systems["heg"]
    perm = np.random.default_rng(2).permutation(len(up))
    je, jv = JL.matrix_lanczos_on_the_fly(js, up[perm], dn[perm], iters=60)
    te, tv = TL.matrix_lanczos_on_the_fly(ts, _t(up[perm]), _t(dn[perm]),
                                          iters=60, chunk=7)
    assert te == pytest.approx(je, abs=1e-9)
    assert abs(float(tv.numpy() @ jv)) > 1 - 1e-8
    # apply_h_on_the_fly is apply_h restricted to the list
    x = np.random.default_rng(3).standard_normal(len(up))
    jy = JL.apply_h_on_the_fly(js, up, dn, x)
    for chunk in (5, 1 << 16):
        ty = TL.apply_h_on_the_fly(ts, _t(up), _t(dn), x, chunk=chunk)
        np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-12)


def test_hubbard_lanczos_full_matches_jax(systems):
    js, ts, _ = systems["hubbardk"]
    je, jv, ju, jd = JL.hubbard_lanczos_full(js, iters=60)
    te, tv, tu, td = TL.hubbard_lanczos_full(ts, iters=60)
    np.testing.assert_array_equal(_u64(tu), ju)
    np.testing.assert_array_equal(_u64(td), jd)
    assert te == pytest.approx(je, abs=1e-9)
    assert abs(float(tv.numpy() @ jv)) > 1 - 1e-8


def test_hubbard_lanczos_full_real_space_matches_eigh():
    """2x3 real-space lattice (3 + 3 electrons, 400 dets): from a random
    start the full-space Lanczos equals the lowest eigenvalue of the dense
    H to 1e-9; from the lowest-diagonal det (the JAX package's start) it
    stops at the lowest state that det overlaps, which lies above."""
    s = make_hubbard_real_system(2, 3, 1.0, 4.0, 3, 3, pbc=True, device="cpu")
    e, vec, up, dn = TL.hubbard_lanczos_full(s, iters=200, random_start=True)
    assert len(up) == 400
    assert bool((setalg.lexsort_dets(up, dn) == torch.arange(400)).all())
    H = build_sparse_ham(s.table, up, dn, 3, 3, s.norb).dense().numpy()
    w, v = np.linalg.eigh(H)
    assert e == pytest.approx(w[0], abs=1e-9)
    e_det = TL.hubbard_lanczos_full(s, iters=200)[0]
    start = int(np.argmin(np.diag(H)))
    reach = np.abs(v[start]) > 1e-10
    assert e_det == pytest.approx(w[reach].min(), abs=1e-9)
    assert e_det > w[0] + 1e-3
    assert float(vec.numpy() @ H @ vec.numpy()) == pytest.approx(w[0],
                                                                  abs=1e-8)


def test_fused_key_finder_matches_search():
    """The searchsorted lookup over fused (up, dn) keys equals the set
    algebra's search, hits and misses."""
    s = make_hubbard_real_system(2, 3, 1.0, 4.0, 3, 3, device="cpu")
    _, _, up, dn = TL.hubbard_lanczos_full(s, iters=2)
    keep = torch.arange(len(up)) % 3 != 1
    lu, ld = up[keep], dn[keep]
    got = TL._finder(lu, ld, s.norb)(up, dn)
    want = setalg.search_dets(lu, ld, up, dn)
    assert torch.equal(got, want) and int((got < 0).sum()) > 0
