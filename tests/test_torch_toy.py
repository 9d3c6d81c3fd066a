"""The port's toy systems (sqmc_tpu_torch/systems/toy.py and the dense
Hubbard constructor) against the JAX package's on the same inputs: the
Rannyu stream, the fictitious matrix bit for bit, the read system on a
file the test writes, the dense ED with its sign convention, tau_optimal,
toy_psi_t and make_hubbard_dense_system (to 1e-12)."""

import numpy as np
import pytest
import torch

from sqmc_tpu.systems import toy as jtoy
from sqmc_tpu.systems.hubbard.system import (
    make_hubbard_dense_system as j_hubbard_dense)
from sqmc_tpu_torch.convert import toy_system_from_numpy
from sqmc_tpu_torch.systems import toy as ttoy
from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_dense_system


def test_rannyu_stream_and_savern():
    """The scalar generator equals the JAX package's draw for draw, the
    bulk stream equals the scalar one bit for bit (across a chunk border),
    and both leave the same state behind."""
    seed = (7, 1234, 99, 4001)
    a, b = ttoy.Rannyu(seed), jtoy.Rannyu(seed)
    assert [a() for _ in range(50)] == [b() for _ in range(50)]
    assert a.savern() == b.savern()
    c = ttoy.Rannyu(seed)
    bulk = ttoy.rannyu_stream(c, 1000, chunk=64)
    d = jtoy.Rannyu(seed)
    assert bulk.tolist() == [d() for _ in range(1000)]
    assert c.savern() == d.savern()
    # the last seed word is forced odd
    assert ttoy.Rannyu((0, 0, 0, 2)).state == jtoy.Rannyu((0, 0, 0, 2)).state


@pytest.mark.parametrize("ndet", [20, 16, 257])
@pytest.mark.parametrize("bosonic", [1, 0])
def test_fictitious_matrix_is_bit_identical(ndet, bosonic):
    """Equal seeds give equal matrices across codes: every bit, for both
    sign conventions, with a non-integer spectrum power."""
    kw = dict(bosonic=bosonic, spectrum_coef=1.0, spectrum_power=1.3,
              ham_diag_fluc=0.5, ham_offdiag_fluc=1.5, seed=(1, 2, 3, 5))
    t = ttoy.make_fictitious_system(ndet, device="cpu", **kw)
    j = jtoy.make_fictitious_system(ndet, **kw)
    assert t.kind == j.kind == "fictitious"
    assert np.array_equal(t.ham.numpy(), j.ham)
    # the densewalk fixtures' parameters too
    kw.update(spectrum_power=1.0, ham_offdiag_fluc=1.0)
    assert np.array_equal(
        ttoy.make_fictitious_system(ndet, device="cpu", **kw).ham.numpy(),
        jtoy.make_fictitious_system(ndet, **kw).ham)


def test_read_system_from_a_written_file(tmp_path):
    j = jtoy.make_fictitious_system(12, bosonic=0, ham_diag_fluc=0.3)
    p = tmp_path / "hamiltonian"
    with open(p, "w") as f:
        f.write("12\n")
        for row in j.ham:
            f.write(" ".join(f"{x:.17g}" for x in row) + "\n")
    t = ttoy.make_read_system(str(p), device="cpu")
    assert t.kind == "read"
    assert np.array_equal(t.ham.numpy(), jtoy.make_read_system(str(p)).ham)
    bad = j.ham.copy()
    bad[0, 1] += 1e-3
    with open(p, "w") as f:
        f.write("12\n" + "\n".join(" ".join(f"{x:.17g}" for x in row)
                                   for row in bad))
    with pytest.raises(ValueError, match="symmetric"):
        ttoy.make_read_system(str(p), device="cpu")


@pytest.mark.parametrize("bosonic,ndet", [(1, 20), (0, 16)])
def test_diagonalize_and_tau_optimal(bosonic, ndet):
    j = jtoy.make_fictitious_system(ndet, bosonic=bosonic, ham_diag_fluc=0.5,
                                    ham_offdiag_fluc=1.0, seed=(1, 2, 3, 5))
    t = toy_system_from_numpy(j, device="cpu")
    wj, gj = j.diagonalize()
    wt, gt = t.diagonalize()
    np.testing.assert_allclose(wt.numpy(), wj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-10)
    assert float(gt[gt.abs().argmax()]) > 0
    assert t.energy_exact == pytest.approx(j.energy_exact, abs=1e-12)
    for mult in (1.0, 0.5):
        np.testing.assert_allclose(t.tau_optimal(mult), j.tau_optimal(mult),
                                   rtol=0, atol=1e-10)
    # a fresh system diagonalizes itself when asked for tau
    t2 = ttoy.make_dense_system(j.ham, device="cpu")
    assert t2.kind == "dense" and t2.eigvals is None
    np.testing.assert_allclose(t2.tau_optimal(), j.tau_optimal(), atol=1e-10)


def test_toy_psi_t_matches():
    for iw, c in (([1, 3], [0.8, 0.4]), ([2, 5, 9], [-0.9, 0.2, 0.1])):
        pt, pg = ttoy.toy_psi_t(10, iw, c)
        jt, jg = jtoy.toy_psi_t(10, iw, c)
        assert np.array_equal(pt, jt) and np.array_equal(pg, jg)


@pytest.mark.parametrize("shape", [(2, 2, 1, 1, True), (2, 3, 2, 1, True),
                                   (2, 3, 2, 2, False)])
def test_hubbard_dense_system_matches(shape):
    """det index = iup * len(dns) + idn in both packages, so the matrices
    agree entry for entry."""
    l_x, l_y, nup, ndn, pbc = shape
    t = make_hubbard_dense_system(l_x, l_y, 1.0, 4.0, nup, ndn, pbc=pbc,
                                  device="cpu")
    j = j_hubbard_dense(l_x, l_y, 1.0, 4.0, nup, ndn, pbc=pbc)
    assert t.kind == j.kind == "hubbard-dense"
    np.testing.assert_allclose(t.ham.numpy(), j.ham, rtol=0, atol=1e-12)


def test_toy_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        ttoy.make_fictitious_system(8)
    with pytest.raises((RuntimeError, AssertionError)):
        make_hubbard_dense_system(2, 2, 1.0, 4.0, 1, 1)
