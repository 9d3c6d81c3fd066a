"""The port's SHCI observables and chemistry extras against the JAX
package's, on the same inputs: the 1-RDM, its first-order PT correction,
the PT vector, natural orbitals and the integral rotation (1e-12), the
natural-orbital FCIDUMP's invariance (full-space energy to 1e-8), the
zeroth-order Green's function (1e-12, and both sum rules), orbital
energies and MP2 (1e-12), the frozen-core CAS fold (1e-12, on an FCIDUMP
written here) with the port's check that every frozen orbital is doubly
occupied, and the time-symmetrized expansion.

Systems: the 5-orbital toy of tests/test_observables.py (full space), a
random-integral system with a spread of orbital energies (HCI selects
part of the space, so PT has external dets), a two-irrep FCIDUMP, and
tests/test_mp2.py's system."""

import functools

import numpy as np
import pytest
import torch

from reference_impl import random_integrals
from sqmc_tpu.algo import greens as JG
from sqmc_tpu.algo import rdm as JR
from sqmc_tpu.algo.hci import run_hci as j_hci
from sqmc_tpu.systems.chem import cas as JC
from sqmc_tpu.systems.chem import mp2 as JM
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import greens as TG
from sqmc_tpu_torch.algo import rdm as TR
from sqmc_tpu_torch.algo.hci import run_hci as t_hci
from sqmc_tpu_torch.systems.base import make_chem_system as t_chem
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.chem import cas as TC
from sqmc_tpu_torch.systems.chem import mp2 as TM
from sqmc_tpu_torch.systems.chem.fcidump import read_fcidump

torch.set_num_threads(1)

SYM7 = np.array([1, 2, 1, 1, 2, 1, 2], np.int32)


def _jax_system(h, eri, core, nup, ndn, sym):
    import jax.numpy as jnp
    from sqmc_tpu import dets as jd
    from sqmc_tpu.systems.base import FermionSystem
    from sqmc_tpu.systems.chem.integrals import IntegralTable
    from sqmc_tpu.systems.heatbath import build_heatbath
    norb = h.shape[0]
    table = IntegralTable.from_dense_arrays(h, eri, core, sym)
    return FermionSystem(
        name="chem", norb=norb, nup=nup, ndn=ndn, table=table,
        heatbath=build_heatbath(table), orb_sym_arr=jnp.asarray(sym),
        has_singles=True, hf_up=jd.det_from_orbs(range(nup), norb),
        hf_dn=jd.det_from_orbs(range(ndn), norb), extra={})


def _pair(h, eri, core, nup, ndn, sym=None):
    sym = np.ones(h.shape[0], np.int32) if sym is None else sym
    return (_jax_system(h, eri, core, nup, ndn, sym),
            make_system_from_arrays(h, eri, core, nup, ndn, orb_sym=sym,
                                    device="cpu"))


def _toy():
    from sqmc_tpu.systems.chem.integrals import n_eri
    rng = np.random.default_rng(3)
    h = rng.normal(size=(5, 5)) * 0.3
    h = 0.5 * (h + h.T) + np.diag(np.arange(5) * 1.0)
    return h, rng.normal(size=n_eri(5)) * 0.1, 0.0


def _spread():
    h, eri, core, _ = random_integrals(8, seed=3)
    return np.diag(np.arange(8.0)) + 0.1 * h, 0.1 * eri, core


def _two_irreps():
    """7 orbitals in two irreps; integrals whose irrep product is odd
    vanish, so the RDM is block diagonal."""
    from sqmc_tpu.systems.chem.integrals import pair_index, quad_index
    h, eri, core, _ = random_integrals(7, seed=4)
    h = np.diag(np.arange(7.0)) + 0.2 * h
    s = SYM7 - 1
    h[s[:, None] != s[None, :]] = 0.0
    g = np.indices((7,) * 4).reshape(4, -1)
    odd = (s[g[0]] ^ s[g[1]] ^ s[g[2]] ^ s[g[3]]) != 0
    eri = 0.2 * eri
    eri[quad_index(pair_index(g[0][odd], g[1][odd]),
                   pair_index(g[2][odd], g[3][odd]))] = 0.0
    return h, eri, core


# name: (integrals, nup, ndn, orbital irreps, eps_var)
CASES = {
    "toy": (_toy, 2, 2, None, 1e-12),
    "spread": (_spread, 2, 2, None, 1e-2),
    "irreps": (_two_irreps, 3, 2, SYM7, 2e-2),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(name, JAX system, port system, JAX HCI result, the same result
    carried over to the port)."""
    make, nup, ndn, sym, eps = CASES[name]
    js, ts = _pair(*make(), nup, ndn, sym)
    jr = j_hci(js, eps, [eps] * 40, max_iters=60, verbose=False)
    return name, js, ts, jr, convert.hci_result_from_numpy(jr, device="cpu")


@pytest.fixture(params=list(CASES))
def case(request):
    return _case(request.param)


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_1rdm_matches_jax(case):
    _, js, ts, jr, tr = case
    g = TR.get_1rdm(ts, tr.up, tr.dn, tr.wts[:, 0])
    _close(g, JR.get_1rdm(js, jr.up, jr.dn, jr.wts[:, 0]))
    assert abs(np.trace(g) - (ts.nup + ts.ndn)) < 1e-10
    _close(g, g.T)


def test_pt_vector_and_1rdm_with_pt_match_jax(case):
    name, js, ts, jr, tr = case
    args = (jr.wts[:, 0], float(jr.energies[0]), 1e-4)
    ju, jd, jc = JR.first_order_pt_vector(js, jr.up, jr.dn, *args)
    tu, td, tc = TR.first_order_pt_vector(ts, tr.up, tr.dn, *args)
    np.testing.assert_array_equal(tu.numpy().view(np.uint64), ju)
    np.testing.assert_array_equal(td.numpy().view(np.uint64), jd)
    _close(tc.numpy(), jc)
    assert (len(ju) == 0) == (name == "toy")
    _close(TR.get_1rdm_with_pt(ts, tr.up, tr.dn, *args),
           JR.get_1rdm_with_pt(js, jr.up, jr.dn, *args))


def test_natural_orbitals_and_rotation_match_jax(case):
    """The same RDM in, the same rotation out (numpy eigh per irrep block,
    column signs included); the rotated integrals to 1e-12."""
    _, js, ts, jr, _ = case
    gamma = JR.get_1rdm(js, jr.up, jr.dn, jr.wts[:, 0])
    sym = np.asarray(js.table.orb_sym)
    jo, jU = JR.natural_orbitals(gamma, sym)
    to, tU = TR.natural_orbitals(gamma, sym)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tU, jU)
    _close(tU @ tU.T, np.eye(len(sym)))
    jh, je = JR.rotate_integrals(js.table, jU)
    th, te = TR.rotate_integrals(ts.table, tU)
    _close(th, jh)
    _close(te, je)


def test_natorb_fcidump_invariance(tmp_path):
    """FCIDUMP.natorb of the toy's full-space wavefunction: both packages'
    files hold the same integrals (1e-12), and the full-space energy in
    the natural orbitals is the original one (1e-8)."""
    _, js, ts, jr, tr = _case("toy")
    jp, tp = str(tmp_path / "j.natorb"), str(tmp_path / "t.natorb")
    jo, _ = JR.generate_natorb_fcidump(js, jr.up, jr.dn, jr.wts[:, 0], jp, 4)
    to, _ = TR.generate_natorb_fcidump(ts, tr.up, tr.dn, tr.wts[:, 0], tp, 4)
    _close(to, jo)
    a, b = read_fcidump(jp), read_fcidump(tp)
    _close(b.h, a.h)
    _close(b.eri, a.eri)
    assert abs(to.sum() - 4.0) < 1e-10
    s2 = t_chem(tp, nup=2, ndn=2, reorder=False, device="cpu")
    r2 = t_hci(s2, 1e-12, [1e-12] * 40, max_iters=60, verbose=False)
    assert len(r2.up) == len(tr.up)
    assert abs(r2.energies[0] - jr.energies[0]) < 1e-8


@pytest.mark.parametrize("eta", [0.0, 0.05])
def test_greens_function_matches_jax(case, eta):
    _, js, ts, jr, tr = case
    w = np.linspace(-2.0, 2.0, 7)
    e0 = float(jr.energies[0])
    jp, jm = JG.greens_function_g0(js, jr.up, jr.dn, jr.wts[:, 0], e0, w, eta)
    tp, tm = TG.greens_function_g0(ts, tr.up, tr.dn, tr.wts[:, 0], e0, w, eta)
    assert tp.dtype == np.complex128 and tp.shape == (7, ts.norb, ts.norb)
    _close(tp, jp)
    _close(tm, jm)


def test_greens_sum_rules(case):
    """At w -> infinity: w G+ -> 2 I - gamma, w G- -> gamma."""
    _, _, ts, _, tr = case
    gamma = TR.get_1rdm(ts, tr.up, tr.dn, tr.wts[:, 0])
    W = np.array([1e8])
    gp, gm = TG.greens_function_g0(ts, tr.up, tr.dn, tr.wts[:, 0],
                                   float(tr.energies[0]), W)
    n = ts.norb
    assert np.abs(W[0] * gp[0].real - (2 * np.eye(n) - gamma)).max() < 1e-5
    assert np.abs(W[0] * gm[0].real - gamma).max() < 1e-5


def test_orbital_energies_and_mp2_match_jax():
    """tests/test_mp2.py's system and the spread system."""
    for h, eri, core in (random_integrals(4, seed=7)[:3], _spread()):
        js, ts = _pair(h, eri, core, 2, 2)
        _close(TM.compute_orbital_energies(ts),
               JM.compute_orbital_energies(js))
        e_t, eps_t = TM.mp2_deterministic(ts)
        e_j, eps_j = JM.mp2_deterministic(js)
        assert e_t < 0 and abs(e_t - e_j) < 1e-12
        _close(eps_t, eps_j)
        eps = np.linspace(-1.0, 2.0, ts.norb)
        assert abs(TM.mp2_deterministic(ts, eps)[0]
                   - JM.mp2_deterministic(js, eps)[0]) < 1e-12


@pytest.fixture(scope="module")
def cas_fcidump(tmp_path_factory):
    """7 orbitals, two irreps, 6 electrons, shuffled orbital energies (the
    reordering permutes), written by the JAX package's writer."""
    h, eri, core = _two_irreps()
    rng = np.random.default_rng(5)
    h[np.diag_indices(7)] = rng.permutation(7).astype(float)
    path = tmp_path_factory.mktemp("cas") / "FCIDUMP"
    JR.write_fcidump(str(path), h, eri, core, SYM7, nelec=6, ms2=0)
    return str(path), h, eri, core


def test_frozen_core_arrays_match_jax(cas_fcidump):
    _, h, eri, core = cas_fcidump
    for fro, act in (([0], [1, 2, 3, 4]), ([2, 5], [0, 1, 3, 6]), ([], [1, 4])):
        for t, j in zip(TC.frozen_core_arrays(h, eri, core, fro, act),
                        JC.frozen_core_arrays(h, eri, core, fro, act)):
            _close(t, j)


@pytest.mark.parametrize("n_core,n_act", [(1, 4), (2, 5), (0, 7)])
def test_write_cas_fcidump_matches_jax(cas_fcidump, tmp_path, n_core, n_act):
    """The written active-space files hold the same integrals (1e-12) and
    the returned descriptions agree."""
    src = cas_fcidump[0]
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    ji = JC.write_cas_fcidump(src, n_core, n_act, jp)
    ti = TC.write_cas_fcidump(src, n_core, n_act, tp)
    for k in ("nelec", "norb", "core_labels", "act_labels", "hf_up", "hf_dn"):
        np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    assert abs(ti["e_core"] - ji["e_core"]) < 1e-12
    a, b = read_fcidump(jp), read_fcidump(tp)
    assert (b.norb, b.nelec, b.ms2) == (a.norb, a.nelec, a.ms2)
    np.testing.assert_array_equal(b.orb_sym, a.orb_sym)
    _close(b.h, a.h)
    _close(b.eri, a.eri)
    assert abs(b.core_energy - a.core_energy) < 1e-12


def test_cas_open_frozen_orbital_raises(cas_fcidump, tmp_path):
    """ROADMAP C6: an HF det with orbital 2 up only and orbital 3 dn only
    (header occupations) passes the JAX package's count check, n_core = 2
    <= min(nup, ndn), and it folds a singly occupied orbital as a closed
    shell; the port checks the orbitals and raises."""
    src = cas_fcidump[0]
    text = open(src).read().replace(" &END", "  1 2 3 hf_up\n  1 2 4 hf_dn\n"
                                     " &END", 1)
    bad = tmp_path / "FCIDUMP_open"
    bad.write_text(text)
    with pytest.raises(ValueError, match="doubly occupied"):
        TC.write_cas_fcidump(str(bad), 3, 3, str(tmp_path / "t"))
    info = JC.write_cas_fcidump(str(bad), 3, 3, str(tmp_path / "j"))
    closed = np.intersect1d(info["hf_up"], info["hf_dn"])
    assert not np.isin(info["core_labels"], closed).all()
    # a closed frozen core passes in both
    TC.write_cas_fcidump(str(bad), 2, 3, str(tmp_path / "t2"))


@pytest.mark.parametrize("z", [1, -1])
def test_expand_time_symmetrized_matches_jax(z):
    """Representatives with words that have bit 63 set (the unsigned key
    order, ROADMAP C3), some with up == dn."""
    rng = np.random.default_rng(8)
    up = rng.integers(0, 2 ** 63, size=(40, 2), dtype=np.uint64)
    up[::3, 0] |= np.uint64(1) << np.uint64(63)
    dn = up.copy()
    dn[1::2] = rng.integers(0, 2 ** 63, size=(20, 2), dtype=np.uint64)
    w = rng.standard_normal(40)
    ju, jd, jw = JR.expand_time_symmetrized(up, dn, w, z)
    tu, td, tw = TR.expand_time_symmetrized(convert.words_to_torch(up, "cpu"),
                                            convert.words_to_torch(dn, "cpu"),
                                            w, z)
    assert len(ju) == 40 + 20
    np.testing.assert_array_equal(tu.numpy().view(np.uint64), ju)
    np.testing.assert_array_equal(td.numpy().view(np.uint64), jd)
    np.testing.assert_array_equal(tw.numpy(), jw)
