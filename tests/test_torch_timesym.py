"""The port's time-reversal symmetrized chemistry path against the JAX
package's, on the same inputs (ref: hamiltonian_chem_time_sym,
chemistry.f90:1323; the C2-curve decks run in this basis).

Inputs are made from numpy seeds: an FCIDUMP with d2h irrep labels whose
integrals vanish unless the irrep product is totally symmetric (written by
sqmc_tpu.algo.rdm.write_fcidump), and the 6-orbital random chem system of
tests/test_time_sym_walk.py.  Det lists compare exactly (on flipped keys:
the port stores int64 words, the JAX package uint64); matrix elements,
connections, sparse H and PT to 1e-12; HCI energies and trial
coefficients to 1e-10; a stochastic symmetrized walk within its error
bar of the exact e0.  The trial constructions and the device Davidson are
in test_torch_timesym_trial.py, the walk in test_torch_timesym_walk.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reference_impl import random_integrals
from sqmc_tpu import dets as jd
from sqmc_tpu.algo import connect as JC
from sqmc_tpu.algo import hci as JH
from sqmc_tpu.algo import pt as JP
from sqmc_tpu.algo import sparseham as JSH
from sqmc_tpu.algo.rdm import write_fcidump
from sqmc_tpu.ops import setalg as j_setalg
from sqmc_tpu.systems.base import FermionSystem as JSystem
from sqmc_tpu.systems.base import make_chem_system as j_chem
from sqmc_tpu.systems.chem import pointgroup as j_pg
from sqmc_tpu.systems.chem import slater as jsl
from sqmc_tpu.systems.chem.integrals import IntegralTable as JTable
from sqmc_tpu.systems.chem.integrals import n_eri, pair_index, quad_index
from sqmc_tpu.systems.heatbath import build_heatbath as j_hb
from sqmc_tpu_torch import convert
from sqmc_tpu_torch import dets as td
from sqmc_tpu_torch.algo import connect as TC
from sqmc_tpu_torch.algo import hci as TH
from sqmc_tpu_torch.algo import pt as TP
from sqmc_tpu_torch.algo import semistoch as TS
from sqmc_tpu_torch.algo import sparseham as TSH
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.ops import setalg as t_setalg
from sqmc_tpu_torch.systems.base import make_chem_system as t_chem
from sqmc_tpu_torch.systems.chem import pointgroup as t_pg
from sqmc_tpu_torch.systems.chem import slater as tsl

torch.set_num_threads(2)

D2H_SYMS = np.array([1, 5, 3, 2, 1, 7, 6, 5])


def _u64(t):
    return t.cpu().numpy().view(np.uint64)


def _t(words):
    return torch.as_tensor(np.asarray(words).view(np.int64))


def sym_integrals(norb, syms, seed):
    """Random integrals that vanish unless the product of the irreps is
    totally symmetric (d2h labels 1-8, XOR product), with ascending
    orbital energies."""
    rng = np.random.default_rng(seed)
    s0 = np.asarray(syms) - 1
    h = rng.normal(size=(norb, norb)) * 0.1
    h = 0.5 * (h + h.T)
    h[s0[:, None] != s0[None, :]] = 0.0
    h[np.diag_indices(norb)] = (np.sort(rng.normal(size=norb)) * 2 - 1
                                + np.arange(norb) * 0.3)
    eri = rng.normal(size=n_eri(norb)) * 0.05
    npair = norb * (norb + 1) // 2
    hi, lo = np.tril_indices(norb)
    ph, pl = np.empty(npair, int), np.empty(npair, int)
    ph[pair_index(hi, lo)], pl[pair_index(hi, lo)] = hi, lo
    qa, qb = np.tril_indices(npair)
    bad = (s0[ph[qa]] ^ s0[pl[qa]] ^ s0[ph[qb]] ^ s0[pl[qb]]) != 0
    eri[quad_index(qa, qb)[bad]] = 0.0
    dd = pair_index(np.arange(norb), np.arange(norb))
    eri[quad_index(dd, dd)] = 0.5 + rng.random(norb) * 0.2
    return h, eri, float(rng.normal())


@pytest.fixture(scope="module")
def fcidump(tmp_path_factory):
    """6 orbitals of d2h irreps 1,5,3,2,1,7; 3 up and 3 down electrons."""
    norb = 6
    h, eri, core = sym_integrals(norb, D2H_SYMS[:norb], 3)
    path = str(tmp_path_factory.mktemp("ts") / "FCIDUMP")
    write_fcidump(path, h, eri, core, D2H_SYMS[:norb], nelec=6, ms2=0)
    return path


def _pair(path, **kw):
    return j_chem(path, **kw), t_chem(path, device="cpu", **kw)


# ---------------------------------------------------------------------------
# representative order, point groups, systems
# ---------------------------------------------------------------------------

def test_keys_less_bit63_words():
    """keys_less in the unsigned det order on two-word (norb = 64 + ...)
    dets whose words have bit 63 set, against the JAX package's uint64
    compare and Python's integer order; a raw signed compare disagrees."""
    rng = np.random.default_rng(0)
    n, W = 4000, 2
    up_a = rng.integers(0, 2 ** 64, (n, W), dtype=np.uint64)
    dn_a = rng.integers(0, 2 ** 64, (n, W), dtype=np.uint64)
    up_b, dn_b = up_a.copy(), dn_a.copy()
    # equal prefixes of every length, differing in bit 63 or below it
    for k in range(n):
        level = k % 5
        words = [(up_b, 1), (up_b, 0), (dn_b, 1), (dn_b, 0)]
        if level < 4:
            arr, w = words[level]
            arr[k, w] ^= np.uint64(1 << 63) if k % 2 else np.uint64(1 << 5)
    assert ((up_a >> np.uint64(63)) == 1).any()
    want = j_setalg.keys_less(up_a, dn_a, up_b, dn_b)
    got = t_setalg.keys_less(_t(up_a), _t(dn_a), _t(up_b), _t(dn_b)).numpy()
    np.testing.assert_array_equal(got, want)

    def key(u, d):
        return (int(u[1]), int(u[0]), int(d[1]), int(d[0]))

    py = np.array([key(up_a[k], dn_a[k]) < key(up_b[k], dn_b[k])
                   for k in range(n)])
    np.testing.assert_array_equal(got, py)
    assert (got != _signed_less(_t(up_a), _t(dn_a), _t(up_b),
                                _t(dn_b))).any()
    # a det and its reverse: the representative test of _time_sym_postprocess
    swap = t_setalg.keys_less(_t(dn_a), _t(up_a), _t(up_a), _t(dn_a)).numpy()
    np.testing.assert_array_equal(
        swap, j_setalg.keys_less(dn_a, up_a, up_a, dn_a))


def _signed_less(ua, da, ub, db):
    lt = torch.zeros(len(ua), dtype=torch.bool)
    eq = torch.ones_like(lt)
    for a, b in ((ua, ub), (da, db)):
        for w in range(a.shape[1] - 1, -1, -1):
            lt = lt | (eq & (a[:, w] < b[:, w]))
            eq = eq & (a[:, w] == b[:, w])
    return lt.numpy()


@pytest.mark.parametrize("name", sorted(j_pg._XOR_GROUPS) + ["dih"])
def test_point_group_tables(name):
    """Product and inverse tables of every group equal the JAX package's."""
    n = j_pg._XOR_GROUPS.get(name, 8)
    syms = np.arange(1, n + 1) if name != "dih" else np.arange(1, 15)
    jg, tg = j_pg.PointGroup(name, syms), t_pg.PointGroup(name, syms)
    assert jg.n == tg.n
    i, j = np.meshgrid(syms, syms, indexing="ij")
    np.testing.assert_array_equal(tg.product(i, j), jg.product(i, j))
    np.testing.assert_array_equal(tg.inverse(syms), jg.inverse(syms))
    occ = list(range(min(3, len(syms))))
    assert tg.det_symmetry(occ) == jg.det_symmetry(occ)


@pytest.mark.parametrize("z,hf_symmetry", [(1, None), (1, 1), (1, 6),
                                           (-1, 2), (-1, 5)])
def test_make_chem_system_time_sym(fcidump, z, hf_symmetry):
    """time_sym with d2h and hf_symmetry: the same starting det (the
    lowest CISD det of the irrep, in representative orientation)."""
    js, ts = _pair(fcidump, time_sym=True, z=z, point_group="d2h",
                   hf_symmetry=hf_symmetry)
    np.testing.assert_array_equal(ts.hf_up.view(np.uint64), js.hf_up)
    np.testing.assert_array_equal(ts.hf_dn.view(np.uint64), js.hf_dn)
    assert (ts.time_sym, ts.z) == (True, z)
    # the port's own system and the JAX one carried over by convert.py
    cv = convert.system_from_numpy(js, device="cpu")
    for s in (ts, cv):
        assert isinstance(s.extra["point_group"], t_pg.PointGroup)
        assert s.extra["point_group"].name == "d2h"
        np.testing.assert_array_equal(s.extra["point_group"].orb_sym,
                                      js.extra["point_group"].orb_sym)
    assert (cv.time_sym, cv.z) == (True, z)
    np.testing.assert_array_equal(cv.hf_up, ts.hf_up)
    np.testing.assert_array_equal(cv.hf_dn, ts.hf_dn)


def test_write_fcidump_matches_jax(tmp_path):
    """The port's FCIDUMP writer (numpy, used by chip_smoke.py for its
    synthetic C2-shaped input) writes the JAX package's file byte for byte,
    and reads back to the same integrals."""
    from sqmc_tpu_torch.systems.chem.fcidump import read_fcidump
    from sqmc_tpu_torch.systems.chem.fcidump import write_fcidump as t_write
    h, eri, core = sym_integrals(8, D2H_SYMS, 7)
    write_fcidump(str(tmp_path / "j"), h, eri, core, D2H_SYMS, nelec=6)
    t_write(str(tmp_path / "t"), h, eri, core, D2H_SYMS, nelec=6)
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()
    d = read_fcidump(str(tmp_path / "t"))
    np.testing.assert_array_equal(d.orb_sym, D2H_SYMS)
    np.testing.assert_allclose(d.h, h, rtol=0, atol=1e-15)
    np.testing.assert_allclose(d.eri, eri, rtol=0, atol=1e-15)


def test_z_minus1_needs_open_shell_start(fcidump):
    for make in (j_chem, lambda p, **kw: t_chem(p, device="cpu", **kw)):
        with pytest.raises(ValueError, match="self-symmetric"):
            make(fcidump, time_sym=True, z=-1)
    with pytest.raises(ValueError, match="point_group"):
        t_chem(fcidump, device="cpu", hf_symmetry=1)


# ---------------------------------------------------------------------------
# matrix elements, connections, sparse H
# ---------------------------------------------------------------------------

def _rep_dets(norb, nup, ndn):
    """Every representative det (up <= dn in the unsigned order) of the
    space, as uint64 word arrays."""
    from reference_impl import all_dets
    combos = all_dets(norb, nup, ndn)
    ups = np.stack([jd.det_from_orbs(u, norb) for u, _ in combos])
    dns = np.stack([jd.det_from_orbs(d, norb) for _, d in combos])
    keep = ~j_setalg.keys_less(dns, ups, ups, dns)
    return ups[keep], dns[keep]


@pytest.mark.parametrize("z", [1, -1])
def test_pair_matrix_elements_time_sym(fcidump, z):
    """Every pair of representatives of the 6-orbital space (self-symmetric
    ones included), to 1e-12."""
    js, ts = _pair(fcidump)
    ups, dns = _rep_dets(6, 3, 3)
    rng = np.random.default_rng(1)
    i = rng.integers(0, len(ups), 3000)
    j = rng.integers(0, len(ups), 3000)
    j[:200] = i[:200]
    selfs = np.nonzero((ups == dns).all(axis=1))[0]
    i[200:260] = rng.choice(selfs, 60)
    j[260:320] = rng.choice(selfs, 60)
    jb = [jd.to_bits(jnp.asarray(x), 6) for x in (ups[i], dns[i], ups[j],
                                                  dns[j])]
    tb = [td.to_bits(_t(x), 6) for x in (ups[i], dns[i], ups[j], dns[j])]
    want = np.asarray(jsl.pair_matrix_elements_time_sym(js.table, *jb, z))
    got = tsl.pair_matrix_elements_time_sym(ts.table, *tb, z).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("z", [1, -1])
def test_generate_connections_and_sparse_ham(fcidump, z):
    """generate_connections from representatives (every emitted candidate
    mapped to its representative, sqrt2 norms, z signs) and the full
    symmetrized sparse H: the same rows, columns and values, to 1e-12."""
    js, ts = _pair(fcidump, time_sym=True, z=z, point_group="d2h",
                   hf_symmetry=2 if z < 0 else None)
    ups, dns = _rep_dets(6, 3, 3)
    if z < 0:
        keep = ~(ups == dns).all(axis=1)
        ups, dns = ups[keep], dns[keep]
    o = j_setalg.lexsort_dets(ups, dns)
    ups, dns = ups[o], dns[o]
    ref = np.arange(0, len(ups), 7)
    eps = np.full(len(ref), 1e-3)
    cu, cd, h, r = JC.generate_connections(js, ups[ref], dns[ref], eps)
    tu, tdn, th, tr = TC.generate_connections(ts, _t(ups[ref]),
                                              _t(dns[ref]),
                                              torch.as_tensor(eps))
    np.testing.assert_array_equal(_u64(tu), cu)
    np.testing.assert_array_equal(_u64(tdn), cd)
    np.testing.assert_array_equal(tr.numpy(), r)
    np.testing.assert_allclose(th.numpy(), h, rtol=0, atol=1e-12)
    assert not j_setalg.keys_less(cd, cu, cu, cd).any()   # representatives

    JHm = JSH.build_sparse_ham(js.table, ups, dns, 3, 3, 6, time_sym=True,
                               z=z)
    THm = TSH.build_sparse_ham(ts.table, _t(ups), _t(dns), 3, 3, 6,
                               time_sym=True, z=z)
    np.testing.assert_array_equal(THm.rows.numpy(), JHm.rows)
    np.testing.assert_array_equal(THm.cols.numpy(), JHm.cols)
    np.testing.assert_allclose(THm.vals.numpy(), JHm.vals, rtol=0, atol=1e-12)
    np.testing.assert_allclose(THm.diag.numpy(), JHm.diag, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(
        TSH.ts_diag_elements(ts.table, _t(ups), _t(dns), 6, z).numpy(),
        JSH.ts_diag_elements(js.table, ups, dns, 6, z), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# HCI, PT, trial constructions
# ---------------------------------------------------------------------------

HCI_KW = dict(eps_var=1e-3, eps_var_sched=[2e-3, 2e-3, 1e-3], n_states=2,
              verbose=False)


@pytest.mark.parametrize("z,hf_symmetry", [(1, 1), (-1, 2)])
def test_run_hci_and_pt_time_sym(fcidump, z, hf_symmetry):
    """HCI with two states (the C2 decks' schedule 2e-3, 2e-3, 1e-3) gives
    the same dets and energies to 1e-10; deterministic PT for each state
    agrees to 1e-12 with the same connection count."""
    js, ts = _pair(fcidump, time_sym=True, z=z, point_group="d2h",
                   hf_symmetry=hf_symmetry)
    jr, tr = JH.run_hci(js, **HCI_KW), TH.run_hci(ts, **HCI_KW)
    np.testing.assert_array_equal(_u64(tr.up), jr.up)
    np.testing.assert_array_equal(_u64(tr.dn), jr.dn)
    np.testing.assert_allclose(tr.energies, jr.energies, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tr.diag, jr.diag, rtol=0, atol=1e-12)
    for s in range(2):
        je, jn = JP.second_order_pt(js, jr.up, jr.dn, jr.wts[:, s],
                                    jr.energies[s], 1e-6, verbose=False)
        te, tn = TP.second_order_pt(ts, tr.up, tr.dn, tr.wts[:, s],
                                    tr.energies[s], 1e-6, verbose=False)
        assert tn == jn
        assert abs(te - je) < 1e-12 and je <= 0


def test_walk_stochastic_spawns_time_sym():
    """A stochastic time-symmetrized walk (D = one det, so every move is a
    spawn through the representative mapping: the kills, the sqrt2 norms,
    the swap with h z) keeps its walkers on representatives and lands
    within 6 sigma + 5e-5 of the exact e0 (the form of
    tests/test_time_sym_walk.py:88-100; the deterministic-limit traces of
    test_torch_timesym_walk.py discard every spawn)."""
    js, ts, e0 = walk_system_pair(1)
    trial = TS.build_trial_wavefunction(ts, eps_var=1e-3, n_psi_t=30,
                                        n_imp=1)
    cfg = TW.WalkConfig(norb=6, nup=2, ndn=2, time_sym=True, z=1,
                        mwalk=4096, cap_spawn=16384, n_words=1, tau=5e-3,
                        w_abs_target=2000.0, has_singles=True,
                        r_initiator=0.0)
    out = TW.run_walk(ts, trial, cfg, nstep=40, nblk=5, nblk_eq=2,
                      w_abs_begin=1000.0, e_trial_initial=e0, verbose=False,
                      seed=3)
    n = int(out.state.nwalk)
    u, d = _u64(out.state.up[:n, 0]), _u64(out.state.dn[:n, 0])
    assert n > 0 and (u <= d).all()
    assert abs(out.e_mixed - e0) < 6 * max(out.e_err, 5e-6) + 5e-5


# ---------------------------------------------------------------------------
# shared with test_torch_timesym_walk.py and test_torch_timesym_trial.py
# ---------------------------------------------------------------------------

def walk_system_pair(z):
    """The 6-orbital random system of tests/test_time_sym_walk.py (2 + 2
    electrons) in both packages, in sector z (z = +1 from the closed-shell
    start, z = -1 from an open-shell one), with the sector's exact ground
    energy from the dense symmetrized H over every representative."""
    norb, nup, ndn = 6, 2, 2
    h, eri, core, _ = random_integrals(norb, seed=3)
    table = JTable.from_dense_arrays(h, eri, core, np.ones(norb, np.int32))
    js = JSystem(name="chem", norb=norb, nup=nup, ndn=ndn, table=table,
                 heatbath=j_hb(table), orb_sym_arr=jnp.ones(norb, jnp.int32),
                 has_singles=True, hf_up=jd.det_from_orbs((0, 1), norb),
                 hf_dn=jd.det_from_orbs((0, 1) if z > 0 else (0, 2), norb),
                 extra={}, time_sym=True, z=z)
    ups, dns = _rep_dets(norb, nup, ndn)
    if z < 0:
        keep = ~(ups == dns).all(axis=1)
        ups, dns = ups[keep], dns[keep]
    n = len(ups)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    b = [jd.to_bits(jnp.asarray(x), norb) for x in (ups, dns)]
    Hts = np.asarray(jsl.pair_matrix_elements_time_sym(
        table, b[0][ii.ravel()], b[1][ii.ravel()], b[0][jj.ravel()],
        b[1][jj.ravel()], z)).reshape(n, n)
    return (js, convert.system_from_numpy(js, device="cpu"),
            float(np.linalg.eigvalsh(Hts)[0]))


def same_trial(tt, jt, tol=1e-10):
    """A port TrialWavefunction equals a JAX one: dets exactly, Psi_T
    coefficients, C(T) cache and e_trial to tol, D-space H to 1e-12."""
    for f in ("psit_up", "psit_dn", "imp_up", "imp_dn", "ct_up", "ct_dn"):
        np.testing.assert_array_equal(_u64(getattr(tt, f)), getattr(jt, f),
                                      err_msg=f)
    np.testing.assert_allclose(tt.psit_coef.numpy(), jt.psit_coef, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(tt.ct_num.numpy(), jt.ct_num, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(tt.ct_den.numpy(), jt.ct_den, rtol=0,
                               atol=tol)
    assert abs(tt.e_trial - jt.e_trial) < tol
    np.testing.assert_array_equal(tt.imp_ham.rows.numpy(), jt.imp_ham.rows)
    np.testing.assert_array_equal(tt.imp_ham.cols.numpy(), jt.imp_ham.cols)
    np.testing.assert_allclose(tt.imp_ham.vals.numpy(), jt.imp_ham.vals,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.imp_ham.diag.numpy(), jt.imp_ham.diag,
                               rtol=0, atol=1e-12)
