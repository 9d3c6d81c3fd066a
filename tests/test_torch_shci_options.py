"""run_hci's options beyond the plain variational stage, the port against
the JAX package: the variational active space (&active_space), the
ARPACK diagonalizer (scipy eigsh on the float64 block-ELL SpMV), the
JAX package's device HCI driver run_hci_device against the port's
run_hci(device_davidson=True) (ROADMAP A9: folded), and PT with a
reference batch smaller than one reference's connections (ROADMAP C6)."""

import numpy as np
import torch

from sqmc_tpu.algo import hci as JH
from sqmc_tpu_torch.algo import hci as TH
from sqmc_tpu_torch.algo import pt as TP
from sqmc_tpu_torch.ops import spmv
from sqmc_tpu_torch.systems.base import make_chem_system as t_chem
from sqmc_tpu_torch.systems.heg.system import make_heg_system as t_heg
from test_torch_shci import _u64, fcidump  # noqa: F401  (fixture)

torch.set_num_threads(1)


def test_active_space_hci_matches_jax(fcidump):
    """run_hci(active_space=): the frozen core stays occupied and the
    frozen virtuals empty in every selected det; the dets and the energy
    equal the JAX package's (1e-10) and lie above the unrestricted E."""
    from sqmc_tpu.systems.base import make_chem_system as j_chem
    js, ts = j_chem(fcidump), t_chem(fcidump, device="cpu")
    kw = dict(eps_var=1e-3, eps_var_sched=[1e-3] * 5, verbose=False,
              active_space=(1, 1, 4))
    jr, tr = JH.run_hci(js, **kw), TH.run_hci(ts, **kw)
    np.testing.assert_array_equal(_u64(tr.up), jr.up)
    np.testing.assert_array_equal(_u64(tr.dn), jr.dn)
    np.testing.assert_allclose(tr.energies, jr.energies, rtol=0, atol=1e-10)
    bits = tr.up.numpy()[:, 0] | tr.dn.numpy()[:, 0]
    assert ((tr.up.numpy()[:, 0] & 1) == 1).all()
    assert ((tr.dn.numpy()[:, 0] & 1) == 1).all()
    assert (bits >> 5 == 0).all()
    full = TH.run_hci(ts, eps_var=1e-3, eps_var_sched=[1e-3] * 5,
                      verbose=False)
    assert len(tr.up) < len(full.up)
    assert tr.energies[0] > full.energies[0] - 1e-12


def test_arpack_matches_davidson_and_jax(monkeypatch):
    """run_hci(diagonalizer="arpack"): scipy's eigsh on the float64
    block-ELL SpMV (its plain version on CPU tensors) gives the Davidson
    dets and energies and the JAX package's ARPACK run (1e-10)."""
    from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
    kw = dict(eps_var=2e-4, eps_var_sched=[2e-4] * 5, n_states=2,
              verbose=False)
    ts = t_heg(3, 1.0, 4, 2, 1.6, device="cpu")
    calls = []
    plain = spmv.spmv_plain
    monkeypatch.setattr(spmv, "spmv_plain",
                        lambda x, c, v, *a: calls.append(v.dtype)
                        or plain(x, c, v, *a))
    tr = TH.run_hci(ts, diagonalizer="arpack", **kw)
    assert len(tr.up) > 40 and calls and set(calls) == {torch.float64}
    dv = TH.run_hci(ts, **kw)
    jr = JH.run_hci(j_heg(3, 1.0, 4, 2, 1.6), diagonalizer="arpack", **kw)
    for other in (dv, jr):
        np.testing.assert_array_equal(_u64(tr.up), np.asarray(
            other.up if isinstance(other.up, np.ndarray) else _u64(other.up)))
        np.testing.assert_allclose(tr.energies, other.energies, rtol=0,
                                   atol=1e-10)


def test_device_davidson_selects_run_hci_device_dets():
    """ROADMAP A9: the JAX package's device driver run_hci_device folds
    into the port's run_hci(device_davidson=True).  On HEG-14 at eps_var
    5e-3 both select the same 277 dets, with energies within 3e-6, the
    tolerance of run_hci_device's float32 SpMV Davidson (dav_tol; its
    energy is not refined in float64 and reads 1.3e-6 low here).  Below
    2,000 dets the port's run_hci diagonalizes in float64, as sqmc_tpu's
    run_hci does."""
    from sqmc_tpu.algo.devhci import run_hci_device
    from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
    kw = dict(eps_var=5e-3, eps_var_sched=[5e-3] * 5, verbose=False)
    jr = run_hci_device(j_heg(3, 0.5, 14, 7, 1.49), **kw)
    tr = TH.run_hci(t_heg(3, 0.5, 14, 7, 1.49, device="cpu"),
                    device_davidson=True, **kw)
    assert len(tr.up) == len(jr.up) == 277
    np.testing.assert_array_equal(_u64(tr.up), jr.up)
    np.testing.assert_array_equal(_u64(tr.dn), jr.dn)
    np.testing.assert_allclose(tr.energies, jr.energies, rtol=0, atol=3e-6)


def test_pt_batch_smaller_than_one_references_connections():
    """ROADMAP C6, second half: the JAX package's device PT never bounds
    its emission when one reference has more connections than its cap.
    The port's PT batches references and emits every connection of a
    batch: with one reference a batch (each with hundreds of connections)
    it equals the unbatched sum (1e-12)."""
    ts = t_heg(3, 0.5, 14, 7, 1.49, device="cpu")
    r = TH.run_hci(ts, eps_var=2e-2, eps_var_sched=[2e-2] * 3, verbose=False)
    args = (ts, r.up, r.dn, r.wts[:, 0], r.energies[0], 1e-5)
    e1, n1 = TP.second_order_pt(*args, verbose=False, batch=1)
    e2, n2 = TP.second_order_pt(*args, verbose=False, batch=1 << 16)
    assert n1 == n2 > 50 * len(r.up)
    assert abs(e1 - e2) < 1e-12
