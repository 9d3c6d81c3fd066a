"""build_walk_tables of the port against the JAX package's, for every run
type: the importance-transformed estimator caches and D-space projector
(with the exact fixed-node treatment: violators zeroed or flipped, column
dumps on the diagonal), its block-ELL and dense layouts, the
Cauchy-Schwarz tables, the continuous-time tables of the three modes with
their validation errors, and the C(T)-in-D vectors.  The system, trial
and guiding are built by the JAX package and carried over, so both sides
transform the same numbers; float tables agree to 1e-12, integer tables
exactly."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo import walk as JW
from sqmc_tpu.algo.guiding import make_gutzwiller_guiding as j_gutz
from sqmc_tpu.algo.semistoch import build_trial_wavefunction as j_trial
from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
from sqmc_tpu.systems.hubbard.system import (make_hubbard_k_system as j_hubk,
                                             make_hubbard_real_system as j_real)
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.ops import spmv

torch.set_num_threads(1)

KW = dict(mwalk=512, cap_spawn=1024, n_words=1, tau=1e-2, w_abs_target=300.0)
RUN_TYPES = ["none", "fixed_node1", "fixed_node2", "fixed_node3",
             "fixed_node4", "partial_node", "release_node", "sr"]


@pytest.fixture(scope="module")
def lattice():
    """2x3 open real-space Hubbard, 2 + 2 electrons (gap at the Fermi
    level), Gutzwiller g = 0.7, D = the 60 largest dets of the eps_var =
    1e-3 wavefunction: the transformed projector has sign violators."""
    js = j_real(2, 3, 1.0, 4.0, 2, 2, pbc=False)
    jg = j_gutz(js, g=0.7)
    jt = j_trial(js, eps_var=1e-3, n_psi_t=20, n_imp=60, verbose=False)
    return (js, jg, jt, convert.system_from_numpy(js, device="cpu"),
            convert.guiding_from_numpy(jg, device="cpu"),
            convert.trial_from_npz(jt, device="cpu"))


def _close(a, b, name):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                               atol=1e-14, err_msg=name)


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("run_type", RUN_TYPES)
def test_transformed_tables_match_jax(lattice, run_type, f32):
    js, jg, jt, ts, tg, tt = lattice
    kw = dict(KW, norb=js.norb, nup=2, ndn=2, has_singles=True,
              run_type=run_type, partial_node_eps=0.6, f32_state=f32,
              guiding="gutzwiller")
    jtab = JW.build_walk_tables(js, jt, guide=jg, cfg=JW.WalkConfig(**kw))
    ttab = TW.build_walk_tables(ts, tt, TW.WalkConfig(**kw), guide=tg)
    np.testing.assert_array_equal(ttab.imp_rows.numpy(), np.asarray(jtab.imp_rows))
    np.testing.assert_array_equal(ttab.imp_cols.numpy(), np.asarray(jtab.imp_cols))
    for f in ("imp_vals", "imp_diag", "ct_num", "ct_den"):
        assert getattr(ttab, f).dtype == (
            torch.float32 if f32 and f != "imp_diag" else torch.float64)
        _close(getattr(ttab, f), getattr(jtab, f), f)
    if f32:
        _close(ttab.imp_dense, jtab.imp_dense, "imp_dense")
        assert ttab.imp_ell_vals.numel() == 0
    else:
        np.testing.assert_array_equal(ttab.imp_ell_cols.numpy(),
                                      np.asarray(jtab.imp_ell_cols))
        _close(ttab.imp_ell_vals, jtab.imp_ell_vals, "imp_ell_vals")
        # the layout's pointers and counts describe the same rows
        n = len(tt.imp_up)
        assert ttab.imp_ell_ptr.tolist() == np.concatenate(
            [[0], np.cumsum(np.bincount(np.asarray(jtab.imp_ell_row),
                                        minlength=n)) * 128]).tolist()
    if run_type != "none":
        # the transformed matrix is NOT symmetric: the layouts must take the
        # row-complete COO, not mirror an upper triangle
        n = len(tt.imp_up)
        A = np.zeros((n, n))
        A[ttab.imp_rows.numpy(), ttab.imp_cols.numpy()] = ttab.imp_vals.numpy()
        assert np.abs(A - A.T).max() > 1e-3
        if run_type not in ("fixed_node2",):
            off = A - np.diag(np.diag(A))
            assert (off <= 1e-12).all() or run_type in ("partial_node", "sr")


def test_blockell_from_full_coo_rows():
    """The row-complete layout function on a non-symmetric matrix with an
    empty row and explicit zeros: spmv_plain over it equals the dense
    product to 1e-14, and the empty row owns one block with no entries."""
    rng = np.random.default_rng(0)
    n = 40
    A = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.3)
    A[7] = 0.0
    r, c = np.nonzero(A)
    v = A[r, c]
    r, c, v = np.append(r, 3), np.append(c, 5), np.append(v, 0.0)
    perm = rng.permutation(len(r))
    cols, vals, ell_row, ptr, nnz = spmv.blockell_from_full_coo(
        n, r[perm], c[perm], v[perm], dtype=np.float64)
    assert nnz[7] == 0 and ptr[8] - ptr[7] == 128 and nnz.sum() == len(r)
    x = rng.normal(size=n)
    y = spmv.spmv_plain(torch.as_tensor(x), torch.as_tensor(cols),
                        torch.as_tensor(vals), torch.as_tensor(ptr),
                        torch.as_tensor(nnz))
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=0, atol=1e-14)


def j_chem(norb=5, nup=2, ndn=2, seed=5):
    """A dense random-integral molecule-type system of the JAX package."""
    import jax.numpy as jnp
    from reference_impl import random_integrals
    from sqmc_tpu import dets as jdets
    from sqmc_tpu.systems.base import FermionSystem
    from sqmc_tpu.systems.chem.integrals import IntegralTable
    from sqmc_tpu.systems.heatbath import build_heatbath
    h, eri, core, _ = random_integrals(norb, seed=seed)
    table = IntegralTable.from_dense_arrays(h, eri, core,
                                            np.ones(norb, np.int32))
    return FermionSystem(
        name="chem", norb=norb, nup=nup, ndn=ndn, table=table,
        heatbath=build_heatbath(table), orb_sym_arr=jnp.ones(norb, jnp.int32),
        has_singles=True, hf_up=jdets.det_from_orbs(range(nup), norb),
        hf_dn=jdets.det_from_orbs(range(ndn), norb), extra={})


def test_cs_tables_match_jax():
    """Cauchy-Schwarz bound tables on dense random integrals (on the
    electron gas every (pr|pr) vanishes by momentum conservation, so the
    proposal has no support there): values to 1e-12, alias tables
    exactly."""
    js = j_chem()
    jt = j_trial(js, eps_var=1e-3, n_psi_t=4, n_imp=4, verbose=False)
    kw = dict(KW, norb=js.norb, nup=2, ndn=2, has_singles=True,
              proposal="cauchy_schwarz")
    jtab = JW.build_walk_tables(js, jt, cfg=JW.WalkConfig(**kw))
    ttab = TW.build_walk_tables(convert.system_from_numpy(js, device="cpu"),
                                convert.trial_from_npz(jt, device="cpu"),
                                TW.WalkConfig(**kw))
    for f in ("cs_c", "cs_rowsum", "cs_aliasq"):
        _close(getattr(ttab, f), getattr(jtab, f), f)
    np.testing.assert_array_equal(ttab.cs_aliasJ.numpy(), np.asarray(jtab.cs_aliasJ))
    assert float(ttab.cs_rowsum.min()) > 0


CT_CASES = {
    "hubbardk_2x2": (lambda: j_hubk(2, 2, 1.0, 4.0, 2, 2), 2, "hubbardk"),
    "hubbardk_3x2": (lambda: j_hubk(3, 2, 1.0, 4.0, 2, 2), 2, "hubbardk"),
    "heg": (lambda: j_heg(3, 1.0, 4, 2, 1.6), 2, "heg"),
    "generic_on_heg": (lambda: j_heg(3, 1.0, 4, 2, 1.6), 2, "generic"),
    "generic_on_chem": (j_chem, 2, "generic"),
}


@pytest.mark.parametrize("name", sorted(CT_CASES))
def test_ct_tables_match_jax(name):
    """kmap3 exactly, ct_rate to 1e-12, for the three CT modes."""
    make, ne, mode = CT_CASES[name]
    js = make()
    jt = j_trial(js, eps_var=1e-3, n_psi_t=4, n_imp=1, verbose=False)
    kw = dict(KW, norb=js.norb, nup=ne, ndn=ne, has_singles=js.has_singles,
              semistochastic=False, use_exponential_projector=True,
              ct_mode=mode)
    jtab = JW.build_walk_tables(js, jt, cfg=JW.WalkConfig(**kw))
    ttab = TW.build_walk_tables(convert.system_from_numpy(js, device="cpu"),
                                convert.trial_from_npz(jt, device="cpu"),
                                TW.WalkConfig(**kw))
    np.testing.assert_array_equal(ttab.kmap3.numpy(), np.asarray(jtab.kmap3))
    assert float(ttab.ct_rate) == pytest.approx(float(jtab.ct_rate), rel=1e-12)
    assert float(ttab.ct_rate) > 0


def test_ct_validation_errors():
    """The CT mode is checked against the system as in the JAX package
    (tests/test_ct_walk.py::test_ct_mode_system_validation), and the
    projector refuses semistochastic, fixed-node and time-symmetrized
    runs."""
    heg = convert.system_from_numpy(j_heg(3, 1.0, 4, 2, 1.6), device="cpu")
    hubk = convert.system_from_numpy(j_hubk(2, 2, 1.0, 4.0, 2, 2), device="cpu")
    base = dict(KW, nup=2, ndn=2, has_singles=False, semistochastic=False,
                use_exponential_projector=True)
    ct = TW._ct_tables
    with pytest.raises(NotImplementedError):
        ct(heg, TW.WalkConfig(norb=heg.norb, **base))             # hubbardk on HEG
    for bad in ("heg", "generic"):
        with pytest.raises(NotImplementedError):
            ct(hubk, TW.WalkConfig(norb=hubk.norb, ct_mode=bad, **base))
    with pytest.raises(ValueError):
        ct(hubk, TW.WalkConfig(norb=hubk.norb, ct_mode="other", **base))
    with pytest.raises(ValueError):
        ct(hubk, TW.WalkConfig(norb=hubk.norb, **dict(base, semistochastic=True)))
    with pytest.raises(NotImplementedError):
        ct(hubk, TW.WalkConfig(norb=hubk.norb, run_type="fixed_node1",
                               guiding="gutzwiller", **base))
    with pytest.raises(NotImplementedError):
        ct(hubk, TW.WalkConfig(norb=hubk.norb, **dict(base, has_singles=True)))
    with pytest.raises(ValueError):
        ct(heg, TW.WalkConfig(norb=heg.norb, ct_mode="heg",
                              **dict(base, nup=4, ndn=0)))


def test_ct_in_d_vectors_match_jax(lattice):
    """C(T)-in-D vectors (importance-transformed) to 1e-12, and the error
    when some C(T) det lies outside D."""
    js, jg, jt, ts, tg, tt = lattice
    jfull = j_trial(js, eps_var=1e-9, n_psi_t=400, n_imp=400, verbose=False)
    kw = dict(KW, norb=js.norb, nup=2, ndn=2, has_singles=True, ct_in_d=True,
              guiding="gutzwiller")
    jtab = JW.build_walk_tables(js, jfull, guide=jg, cfg=JW.WalkConfig(**kw))
    ttab = TW.build_walk_tables(ts, convert.trial_from_npz(jfull, device="cpu"),
                                TW.WalkConfig(**kw), guide=tg)
    assert ttab.ct_num_imp.numel() == len(jfull.imp_up) > 0
    _close(ttab.ct_num_imp, jtab.ct_num_imp, "ct_num_imp")
    _close(ttab.ct_den_imp, jtab.ct_den_imp, "ct_den_imp")
    with pytest.raises(ValueError, match="outside D"):
        TW.build_walk_tables(ts, tt, TW.WalkConfig(**kw), guide=tg)


def test_proj_bf16_storage(lattice):
    """proj_bf16 stores the dense projector in bfloat16, the values the
    JAX package's bfloat16 table holds."""
    js, jg, jt, ts, tg, tt = lattice
    kw = dict(KW, norb=js.norb, nup=2, ndn=2, has_singles=True,
              f32_state=True, proj_bf16=True)
    jtab = JW.build_walk_tables(js, jt, cfg=JW.WalkConfig(**kw))
    ttab = TW.build_walk_tables(ts, tt, TW.WalkConfig(**kw))
    assert ttab.imp_dense.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ttab.imp_dense.to(torch.float32).numpy(),
        np.asarray(jtab.imp_dense.astype("float32")))


def test_guiding_needs_a_guide(lattice):
    js, jg, jt, ts, tg, tt = lattice
    cfg = TW.WalkConfig(**dict(KW, norb=js.norb, nup=2, ndn=2,
                               guiding="gutzwiller"))
    with pytest.raises(ValueError, match="guide"):
        TW.build_walk_tables(ts, tt, cfg)
