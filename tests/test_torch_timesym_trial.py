"""The port's trial-wavefunction constructions and device Davidson in the
time-reversal symmetrized basis, against the JAX package's: the
reference-faithful Psi_T and D from a walk deck's trial_wf cards
(build_trial_from_cards), the diff_from_psi_t cards (build_trial_iterate)
and the hf_to_psit card (ensure_psit_in_imp) give the same dets,
coefficients (1e-10), C(T) cache and D-space H; run_hci with
device_davidson=True past its 2,000-det switch gives the same dets and
energies, with two states (m = 2 right-hand sides per SpMV)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reference_impl import random_integrals
from sqmc_tpu import dets as jd
from sqmc_tpu.algo import hci as JH
from sqmc_tpu.algo import semistoch as JS
from sqmc_tpu.systems.base import FermionSystem as JSystem
from sqmc_tpu.systems.chem.integrals import IntegralTable as JTable
from sqmc_tpu.systems.heatbath import build_heatbath as j_hb
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.algo import hci as TH
from sqmc_tpu_torch.algo import semistoch as TS
from sqmc_tpu_torch.ops import spmv
from test_torch_timesym import _pair, _u64, fcidump, same_trial  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("z,hf_symmetry", [(1, 1), (-1, 2)])
def test_trial_constructions_time_sym(fcidump, z, hf_symmetry):  # noqa: F811
    """The d2h FCIDUMP with time_sym and hf_symmetry, as a C2-curve deck
    would run it."""
    js, ts = _pair(fcidump, time_sym=True, z=z, point_group="d2h",
                   hf_symmetry=hf_symmetry)
    cards = (2, [6, 6], [1, 5], [10, 20], 8)
    same_trial(TS.build_trial_from_cards(ts, *cards),
               JS.build_trial_from_cards(js, *cards))
    it = (2, [1, 4], [6, 15])
    same_trial(TS.build_trial_iterate(ts, *it, norb_active=[5, 6],
                                      n_psi_t=5),
               JS.build_trial_iterate(js, *it, norb_active=[5, 6],
                                      n_psi_t=5))
    small = (2, [6, 6], [1, 5], [10, 20], 3)
    jf = JS.ensure_psit_in_imp(js, JS.build_trial_from_cards(js, *small))
    tf = TS.ensure_psit_in_imp(ts, TS.build_trial_from_cards(ts, *small))
    assert len(tf.imp_up) > 3
    same_trial(tf, jf)
    assert TS.ensure_psit_in_imp(ts, tf) is tf


def test_device_davidson_time_sym():
    """9 orbitals, 3 + 3 electrons, z = +1, two states, past the 2,000-det
    switch: the port's device Davidson (block-ELL SpMV with m = 2, its
    plain version on the CPU; float32 to tol 3e-6, float64 Rayleigh
    refinement) gives the JAX device Davidson's dets and energies to
    1e-10.  (Against a float64 Davidson the refined energies agree only to
    the float32 solve's tolerance, ~5e-7 for the second state.)"""
    norb = 9
    h, eri, core, _ = random_integrals(norb, seed=5)
    h = h * 0.3 + np.diag(np.arange(norb) * 0.5)
    table = JTable.from_dense_arrays(h, eri * 0.1, core,
                                     np.ones(norb, np.int32))
    js = JSystem(name="chem", norb=norb, nup=3, ndn=3, table=table,
                 heatbath=j_hb(table), orb_sym_arr=jnp.ones(norb, jnp.int32),
                 has_singles=True, hf_up=jd.det_from_orbs((0, 1, 2), norb),
                 hf_dn=jd.det_from_orbs((0, 1, 2), norb), extra={},
                 time_sym=True, z=1)
    ts = convert.system_from_numpy(js, device="cpu")
    kw = dict(eps_var=1e-3, eps_var_sched=[1e-3] * 2, verbose=False,
              n_states=2, device_davidson=True)
    jr = JH.run_hci(js, **kw)
    spmv.reset_launches()
    dd = TH.run_hci(ts, **kw)
    assert len(jr.up) >= 2000 and spmv.launches == 0
    np.testing.assert_array_equal(_u64(dd.up), jr.up)
    np.testing.assert_array_equal(_u64(dd.dn), jr.dn)
    np.testing.assert_allclose(dd.energies, jr.energies, rtol=0, atol=1e-10)
