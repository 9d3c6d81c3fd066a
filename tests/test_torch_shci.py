"""The port's SHCI path against the JAX package's: run_hci with the
device Davidson (float32 block-ELL SpMV + float64 Rayleigh refinement) on
HEG-14 at eps_var 2e-3 (3,265 dets, past the 2,000-det switch), the
eps_var series and its extrapolation, and systems read from an FCIDUMP
written by sqmc_tpu.algo.rdm.write_fcidump.  Det lists compare exactly;
device-Davidson energies to 1e-6 (float32 Davidson to tol 3e-6, refined);
series, extrapolation and PT to 1e-10; integral tables exactly."""

import numpy as np
import pytest

from reference_impl import random_integrals
from sqmc_tpu.algo import hci as JH
from sqmc_tpu.algo import pt as JP
from sqmc_tpu_torch.algo import hci as TH
from sqmc_tpu_torch.algo import pt as TP
from sqmc_tpu_torch.ops import spmv
from sqmc_tpu_torch.systems.base import make_chem_system as t_chem
from sqmc_tpu_torch.systems.heg.system import make_heg_system as t_heg


def _u64(t):
    return t.cpu().numpy().view(np.uint64)


def test_device_davidson_hci_matches_jax(monkeypatch):
    """The port's device Davidson goes through ops.spmv (its plain
    version on CPU tensors, never the kernel)."""
    from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
    kw = dict(eps_var=2e-3, eps_var_sched=[2e-3] * 5, verbose=False,
              device_davidson=True)
    jr = JH.run_hci(j_heg(3, 0.5, 14, 7, 1.49), **kw)
    ts = t_heg(3, 0.5, 14, 7, 1.49, device="cpu")
    calls = []
    plain = spmv.spmv_plain
    monkeypatch.setattr(spmv, "spmv_plain",
                        lambda *a: calls.append(1) or plain(*a))
    spmv.reset_launches()
    tr = TH.run_hci(ts, **kw)
    assert len(calls) > 0 and spmv.launches == 0
    assert len(tr.up) == len(jr.up) == 3265
    np.testing.assert_array_equal(_u64(tr.up), jr.up)
    np.testing.assert_array_equal(_u64(tr.dn), jr.dn)
    np.testing.assert_allclose(tr.energies, jr.energies, rtol=0, atol=1e-6)
    # the refined energy is the float64 Davidson's to the same tolerance
    f64 = TH.run_hci(ts, eps_var=2e-3, eps_var_sched=[2e-3] * 5,
                     verbose=False)
    np.testing.assert_array_equal(_u64(f64.up), _u64(tr.up))
    np.testing.assert_allclose(tr.energies, f64.energies, rtol=0, atol=1e-6)


def test_rayleigh_f64_matches_jax():
    from sqmc_tpu.algo.sparseham import SparseHam
    from sqmc_tpu_torch import convert
    rng = np.random.default_rng(0)
    n = 60
    r, c = np.triu_indices(n, k=1)
    keep = rng.random(len(r)) < 0.2
    H = SparseHam(n=n, rows=r[keep], cols=c[keep],
                  vals=rng.standard_normal(keep.sum()),
                  diag=rng.standard_normal(n))
    x = rng.standard_normal(n)
    assert TH._rayleigh_f64(convert.sparse_ham_from_numpy(H, device="cpu"), x) == \
        pytest.approx(JH._rayleigh_f64(H, x), abs=1e-12)


def test_eps_series_and_extrapolation_match_jax():
    from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
    eps = [1e-2, 3e-3, 1e-3]
    j = JH.run_eps_series(j_heg(3, 1.0, 4, 2, 1.6), eps, eps_pt=1e-6)
    t = TH.run_eps_series(t_heg(3, 1.0, 4, 2, 1.6, device="cpu"), eps, eps_pt=1e-6)
    assert t["eps"] == j["eps"]
    for k in ("e_var", "e_pt", "e_tot"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-10, err_msg=k)
    assert t["e_extrapolated"] == pytest.approx(j["e_extrapolated"], abs=1e-10)
    assert t["slope"] == pytest.approx(j["slope"], abs=1e-10)
    rng = np.random.default_rng(1)
    e_var, e_pt = rng.standard_normal(5), rng.standard_normal(5) * 1e-3
    np.testing.assert_allclose(TH.extrapolate_energy(e_var, e_pt),
                               JH.extrapolate_energy(e_var, e_pt),
                               rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def fcidump(tmp_path_factory):
    """Random integrals on shuffled orbital energies (so the reordering
    permutes), two irreps, 4 electrons in 7 orbitals, written by JAX."""
    from sqmc_tpu.algo.rdm import write_fcidump
    h, eri, core, _ = random_integrals(7, seed=4)
    rng = np.random.default_rng(4)
    h = np.diag(rng.permutation(7).astype(float)) + 0.1 * h
    path = tmp_path_factory.mktemp("fcidump") / "FCIDUMP"
    write_fcidump(str(path), h, 0.1 * eri, core,
                  np.array([1, 2, 1, 1, 2, 1, 2]), nelec=4, ms2=0)
    return str(path)


@pytest.mark.parametrize("occ", [None, ([1, 3], [2, 3])])
def test_fcidump_system_matches_jax(fcidump, occ):
    from sqmc_tpu.systems.base import make_chem_system as j_chem
    kw = {} if occ is None else dict(hf_up_occ_in=occ[0], hf_dn_occ_in=occ[1])
    js = j_chem(fcidump, **kw)
    ts = t_chem(fcidump, device="cpu", **kw)
    assert (ts.norb, ts.nup, ts.ndn) == (js.norb, js.nup, js.ndn) == (7, 2, 2)
    np.testing.assert_array_equal(ts.hf_up.view(np.uint64), js.hf_up)
    np.testing.assert_array_equal(ts.hf_dn.view(np.uint64), js.hf_dn)
    np.testing.assert_array_equal(ts.extra["info"]["perm"],
                                  js.extra["info"]["perm"])
    assert not np.array_equal(ts.extra["info"]["perm"], np.arange(7))
    np.testing.assert_array_equal(ts.table.orb_sym, js.table.orb_sym)
    np.testing.assert_array_equal(ts.orb_sym_arr.numpy(),
                                  np.asarray(js.orb_sym_arr))
    assert ts.table.core_energy == js.table.core_energy
    for f in ("h", "eri", "direct", "exchange", "sing_dir", "sing_exch"):
        np.testing.assert_array_equal(getattr(ts.table, f).numpy(),
                                      np.asarray(getattr(js.table, f)),
                                      err_msg=f)
    for f in ("same_rs", "same_val", "opp_rs", "opp_val", "same_start",
              "opp_start"):
        np.testing.assert_array_equal(getattr(ts.heatbath, f).numpy(),
                                      np.asarray(getattr(js.heatbath, f)),
                                      err_msg=f)


def test_fcidump_hci_and_pt_match_jax(fcidump):
    from sqmc_tpu.systems.base import make_chem_system as j_chem
    js, ts = j_chem(fcidump), t_chem(fcidump, device="cpu")
    kw = dict(eps_var=1e-2, eps_var_sched=[1e-2] * 5, verbose=False)
    jr, tr = JH.run_hci(js, **kw), TH.run_hci(ts, **kw)
    assert 30 < len(tr.up) < 441               # a part of the 21 x 21 space
    np.testing.assert_array_equal(_u64(tr.up), jr.up)
    np.testing.assert_array_equal(_u64(tr.dn), jr.dn)
    np.testing.assert_allclose(tr.energies, jr.energies, rtol=0, atol=1e-10)
    e_j, n_j = JP.second_order_pt(js, jr.up, jr.dn, jr.wts[:, 0],
                                  jr.energies[0], 1e-5, verbose=False)
    e_t, n_t = TP.second_order_pt(ts, tr.up, tr.dn, tr.wts[:, 0],
                                  tr.energies[0], 1e-5, verbose=False)
    assert n_t == n_j > len(jr.up)
    assert e_j < 0 and abs(e_t - e_j) < 1e-10


def test_unported_options_raise(fcidump):
    """Options that stay unported raise ValueError: a mesh argument that is
    not a parallel.dist.Mesh in run_hci, and an unknown diagonalizer (the
    wavefunction cache is ported: an empty cache directory changes
    nothing); in WalkConfig the JAX package's capacity workarounds, ranks
    without an axis name or a spawn capacity that does not split into
    them, and (as in the JAX package) an unknown name, a fixed-node run
    without a guiding function or a sector other than +1 / -1.  The exponential
    projector on a time-symmetrized system is refused where the JAX
    package refuses it, in build_walk_tables."""
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, build_walk_tables
    s = t_heg(3, 1.0, 4, 2, 1.6, device="cpu")
    for kw in (dict(mesh=object()), dict(diagonalizer="lobpcg")):
        with pytest.raises(ValueError):
            TH.run_hci(s, eps_var=1e-3, verbose=False, **kw)
    plain = TH.run_hci(s, eps_var=1e-3, verbose=False)
    cached = TH.run_hci(s, eps_var=1e-3, verbose=False, wf_cache_dir="absent")
    assert cached.n_iters == plain.n_iters > 0
    assert cached.energies[0] == plain.energies[0]
    c = t_chem(fcidump, device="cpu", time_sym=True, point_group="d2h")
    base = dict(norb=c.norb, nup=c.nup, ndn=c.ndn, n_words=1, mwalk=1024,
                cap_spawn=4096, tau=5e-3, w_abs_target=500.0, time_sym=True)
    for kw in (dict(axis_name="d", n_dev=3), dict(n_dev=2),
               dict(cap_compact=512),
               dict(cap_single=512), dict(run_type="fixed_node1"),
               dict(run_type="vmc"), dict(proposal="heat_bath3"),
               dict(guiding="jastrow"), dict(initiator_rule="first"),
               dict(z=2)):
        with pytest.raises(ValueError):
            WalkConfig(**base, **kw)
    trial = build_trial_wavefunction(c, eps_var=1e-2, n_psi_t=4, n_imp=1)
    with pytest.raises(NotImplementedError, match="time-reversal"):
        build_walk_tables(c, trial, WalkConfig(
            **base, semistochastic=False, use_exponential_projector=True,
            ct_mode="generic"))

