"""Two-word determinants in the port against the JAX package, with live
orbitals on both sides of the word boundary: a small random-integral
system placed at orbitals 0-2 and 63-65 of 70 (the rest dead: far up in
energy, irreps of their own), so sorted det lists hold words with bit 63
set and dets that differ only in the second word, the unsigned key order
of ROADMAP C3.  The port's two-word HCI equals the JAX package's (and
the one-word energy), and so do the 1-RDM, the Green's function, the
legacy CI's H application and truncated Lanczos on the same
wavefunction."""

import numpy as np
import pytest
import torch

from reference_impl import random_integrals
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import greens as TG
from sqmc_tpu_torch.algo import legacy_ci as TL
from sqmc_tpu_torch.algo import rdm as TR
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.systems.base import make_system_from_arrays
from test_torch_multiword import NDN, NORB, NPAD, NUP, _hci, _padded

torch.set_num_threads(1)

STRADDLE = [0, 1, 2, 63, 64, 65]   # live orbitals across the word boundary


@pytest.fixture(scope="module")
def straddle():
    """(JAX system, port system, JAX HCI result, the port's) with live
    orbitals on both sides of the word boundary."""
    import jax.numpy as jnp
    from sqmc_tpu import dets as jd
    from sqmc_tpu.algo.hci import run_hci as j_hci
    from sqmc_tpu.systems.base import FermionSystem
    from sqmc_tpu.systems.chem.integrals import IntegralTable
    from sqmc_tpu.systems.heatbath import build_heatbath
    h, eri, core, _ = random_integrals(NORB, seed=13)
    hp, erip, sym = _padded(h, eri, STRADDLE)
    table = IntegralTable.from_dense_arrays(hp, erip, core, sym)
    js = FermionSystem(
        name="chem", norb=NPAD, nup=NUP, ndn=NDN, table=table,
        heatbath=build_heatbath(table), orb_sym_arr=jnp.asarray(sym),
        has_singles=True, hf_up=jd.det_from_orbs(range(NUP), NPAD),
        hf_dn=jd.det_from_orbs(range(NDN), NPAD), extra={})
    ts = make_system_from_arrays(hp, erip, core, NUP, NDN, orb_sym=sym,
                                 device="cpu")
    kw = dict(eps_var=2e-3, eps_var_sched=[2e-3] * 10, verbose=False)
    return js, ts, j_hci(js, **kw), run_hci(ts, **kw)


def test_torch_w2_straddle_hci_matches_jax(straddle):
    js, ts, jr, tr = straddle
    up = tr.up.numpy().view(np.uint64)
    assert ts.n_words == 2 and len(up) > 50
    assert (up[:, 0] >> np.uint64(63)).any() and (up[:, 1] != 0).any()
    np.testing.assert_array_equal(up, jr.up)
    np.testing.assert_array_equal(tr.dn.numpy().view(np.uint64), jr.dn)
    np.testing.assert_allclose(tr.energies, jr.energies, rtol=0, atol=1e-10)
    # the one-word system of the same physics
    h, eri, core, _ = random_integrals(NORB, seed=13)
    r1 = _hci(make_system_from_arrays(h, eri, core, NUP, NDN, device="cpu"),
              2e-3)
    assert tr.energies[0] == pytest.approx(r1.energies[0], abs=1e-9)


def test_torch_w2_straddle_observables_match_jax(straddle):
    """1-RDM and G0(w) of the JAX wavefunction in both packages (1e-12)."""
    from sqmc_tpu.algo import greens as JG
    from sqmc_tpu.algo import rdm as JR
    js, ts, jr, _ = straddle
    tr = convert.hci_result_from_numpy(jr, device="cpu")
    c = jr.wts[:, 0]
    np.testing.assert_allclose(TR.get_1rdm(ts, tr.up, tr.dn, c),
                               JR.get_1rdm(js, jr.up, jr.dn, c), rtol=0,
                               atol=1e-12)
    w = np.array([-1.5, 0.3, 2.0])
    e0 = float(jr.energies[0])
    for t, j in zip(TG.greens_function_g0(ts, tr.up, tr.dn, c, e0, w),
                    JG.greens_function_g0(js, jr.up, jr.dn, c, e0, w)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)


def test_torch_w2_straddle_apply_h_matches_jax(straddle):
    """The legacy CI's H application and truncated Lanczos: the same
    union det list, y within 1e-12, energies within 1e-10."""
    from sqmc_tpu.algo import legacy_ci as JL
    js, ts, jr, _ = straddle
    c = np.random.default_rng(4).standard_normal(len(jr.up))
    for n_init in (None, 10):
        ju, jd, jy, _ = JL.apply_h(js, jr.up, jr.dn, c, n_initiators=n_init)
        tu, td, ty, _ = TL.apply_h(ts, convert.words_to_torch(jr.up, "cpu"),
                                   convert.words_to_torch(jr.dn, "cpu"), c,
                                   n_initiators=n_init)
        np.testing.assert_array_equal(tu.numpy().view(np.uint64), ju)
        np.testing.assert_array_equal(td.numpy().view(np.uint64), jd)
        np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-12)
    jt = JL.perform_truncated_lanczos(js, 4, 20, 40)
    tt = TL.perform_truncated_lanczos(ts, 4, 20, 40)
    np.testing.assert_allclose(tt.energies_per_iter, jt.energies_per_iter,
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tt.up.numpy().view(np.uint64), jt.up)
