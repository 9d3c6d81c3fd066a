"""The port's HCI stack against the JAX package's: connected-determinant
generation, the sparse Hamiltonian, Davidson, run_hci and the trial
wavefunction, on the tiny HEG and on random chem integrals (with
singles).  Det sets and indices compare exactly; float64 elements to
1e-12 (same terms, other summation orders); eigenvalues to 1e-10 (the
Davidson tolerance)."""

import numpy as np
import pytest
import torch

from reference_impl import random_integrals
from sqmc_tpu.algo import semistoch as J_st
from sqmc_tpu.algo.connect import generate_connections as j_gen
from sqmc_tpu.algo.davidson import davidson as j_dav
from sqmc_tpu.algo.hci import run_hci as j_hci
from sqmc_tpu.algo.sparseham import build_sparse_ham as j_bsh
from sqmc_tpu.ops import setalg as j_set
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import semistoch as T_st
from sqmc_tpu_torch.algo.connect import generate_connections as t_gen
from sqmc_tpu_torch.algo.davidson import davidson as t_dav
from sqmc_tpu_torch.algo.hci import run_hci as t_hci
from sqmc_tpu_torch.algo.sparseham import build_sparse_ham as t_bsh
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from sqmc_tpu_torch.systems.heg.system import make_heg_system as t_heg

TOL = 1e-12


def _u64(t):
    return t.numpy().view(np.uint64)


def _t(w):
    return torch.as_tensor(np.ascontiguousarray(w).view(np.int64))


@pytest.fixture(scope="module", params=["heg", "chem"])
def pair(request):
    """(jax system, port system) built independently from the same input."""
    from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
    if request.param == "heg":
        return request.param, j_heg(3, 1.0, 4, 2, 1.6), t_heg(3, 1.0, 4, 2, 1.6, device="cpu")
    import jax.numpy as jnp
    from sqmc_tpu import dets as jd
    from sqmc_tpu.systems.base import FermionSystem
    from sqmc_tpu.systems.chem.integrals import IntegralTable
    from sqmc_tpu.systems.heatbath import build_heatbath
    h, eri, core, _ = random_integrals(6, seed=5)
    table = IntegralTable.from_dense_arrays(h, eri, core, np.ones(6, np.int32))
    js = FermionSystem(name="chem", norb=6, nup=3, ndn=2, table=table,
                       heatbath=build_heatbath(table),
                       orb_sym_arr=jnp.ones(6, jnp.int32), has_singles=True,
                       hf_up=jd.det_from_orbs(range(3), 6),
                       hf_dn=jd.det_from_orbs(range(2), 6), extra={})
    return request.param, js, make_system_from_arrays(h, eri, core, 3, 2, device="cpu")


@pytest.fixture(scope="module")
def hci_pair(pair):
    name, js, ts = pair
    jr = j_hci(js, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
               verbose=False)
    tr = t_hci(ts, eps_var=1e-9, eps_var_sched=[1e-9] * 30, max_iters=60,
               verbose=False)
    return name, js, ts, jr, tr


def test_generate_connections_same_sets(hci_pair):
    _, js, ts, jr, _ = hci_pair
    ref_up, ref_dn = jr.up[:40], jr.dn[:40]
    eps = np.full(40, 1e-3) / np.maximum(np.abs(jr.wts[:40, 0]), 1e-300)
    cj = j_gen(js, ref_up, ref_dn, eps)
    ct = t_gen(ts, _t(ref_up), _t(ref_dn), torch.as_tensor(eps))
    assert len(ct[0]) == len(cj[0]) > 0
    # same candidates row for row (the emission order is the same)
    np.testing.assert_array_equal(_u64(ct[0]), cj[0])
    np.testing.assert_array_equal(_u64(ct[1]), cj[1])
    np.testing.assert_array_equal(ct[3].numpy(), cj[3])
    np.testing.assert_allclose(ct[2].numpy(), cj[2], rtol=0, atol=TOL)


def test_sparse_ham_same_coo(hci_pair):
    _, js, ts, jr, _ = hci_pair
    Hj = j_bsh(js.table, jr.up, jr.dn, js.nup, js.ndn, js.norb)
    Ht = t_bsh(ts.table, _t(jr.up), _t(jr.dn), ts.nup, ts.ndn, ts.norb)
    np.testing.assert_array_equal(Ht.rows.numpy(), Hj.rows)
    np.testing.assert_array_equal(Ht.cols.numpy(), Hj.cols)
    np.testing.assert_allclose(Ht.vals.numpy(), Hj.vals, rtol=0, atol=TOL)
    np.testing.assert_allclose(Ht.diag.numpy(), Hj.diag, rtol=0, atol=TOL)
    # incremental build from the first half of the list equals the full one
    half = len(jr.up) // 2
    H0 = t_bsh(ts.table, _t(jr.up[:half]), _t(jr.dn[:half]), ts.nup, ts.ndn,
               ts.norb)
    Hi = t_bsh(ts.table, _t(jr.up), _t(jr.dn), ts.nup, ts.ndn, ts.norb,
               prev=H0, prev_map=torch.arange(half))
    np.testing.assert_array_equal(Hi.rows.numpy(), Hj.rows)
    np.testing.assert_array_equal(Hi.cols.numpy(), Hj.cols)
    np.testing.assert_allclose(Hi.vals.numpy(), Hj.vals, rtol=0, atol=TOL)


def test_davidson_matches(hci_pair):
    _, js, ts, jr, _ = hci_pair
    Hj = j_bsh(js.table, jr.up, jr.dn, js.nup, js.ndn, js.norb)
    Ht = t_bsh(ts.table, _t(jr.up), _t(jr.dn), ts.nup, ts.ndn, ts.norb)
    assert Ht.n >= 50                   # the iterative path, not dense eigh
    ej, _ = j_dav(Hj, 2)
    et, vt = t_dav(Ht, 2)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-10)
    w = np.linalg.eigvalsh(Ht.dense().numpy())
    np.testing.assert_allclose(et, w[:2], rtol=0, atol=1e-10)


def test_run_hci_same_dets_and_energy(hci_pair):
    _, _, _, jr, tr = hci_pair
    np.testing.assert_array_equal(_u64(tr.up), jr.up)
    np.testing.assert_array_equal(_u64(tr.dn), jr.dn)
    np.testing.assert_allclose(tr.energies, jr.energies, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tr.diag, jr.diag, rtol=0, atol=TOL)


def test_heg14_golden():
    """The in-repo HEG golden (tests/test_hci.py:28-31), built by the port."""
    res = t_hci(t_heg(3, 0.5, 14, 7, 1.49, device="cpu"), eps_var=1e-3,
                eps_var_sched=[1e-3] * 10, verbose=False)
    assert len(res.up) == 9475
    assert abs(res.energies[0] - 58.276906085) < 1e-7


def test_trial_wavefunction_matches_jax(pair, tmp_path):
    name, js, ts = pair
    kw = dict(eps_var=1e-3, n_psi_t=12, n_imp=30)
    jt = J_st.build_trial_wavefunction(js, **kw)
    tt = T_st.build_trial_wavefunction(ts, **kw)
    for f in ("psit_up", "psit_dn", "ct_up", "ct_dn", "imp_up", "imp_dn"):
        np.testing.assert_array_equal(_u64(getattr(tt, f)), getattr(jt, f),
                                      err_msg=f)
    for f in ("psit_coef", "ct_num", "ct_den"):
        np.testing.assert_allclose(getattr(tt, f).numpy(), getattr(jt, f),
                                   rtol=0, atol=1e-10, err_msg=f)
    assert tt.e_trial == pytest.approx(jt.e_trial, abs=1e-10)
    np.testing.assert_array_equal(tt.imp_ham.rows.numpy(), jt.imp_ham.rows)
    np.testing.assert_allclose(tt.imp_ham.vals.numpy(), jt.imp_ham.vals,
                               rtol=0, atol=TOL)
    # either package's npz loads into the port, with the same keys
    J_st.save_trial(jt, str(tmp_path / "j.npz"))
    T_st.save_trial(tt, str(tmp_path / "t.npz"))
    a = convert.trial_from_npz(str(tmp_path / "j.npz"), device="cpu")
    b = T_st.load_trial(str(tmp_path / "t.npz"), device="cpu")
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
    for f in ("ct_up", "imp_dn"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    j_back = J_st.load_trial(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(j_back.ct_up, jt.ct_up)
    assert j_set.search_dets(j_back.ct_up, j_back.ct_dn, jt.psit_up,
                             jt.psit_dn).min() >= 0
