"""The port's SpMV (ops/spmv.py) against the JAX package's
(sqmc_tpu/ops/spmv_pallas.py): the ELL and block-ELL layouts equal JAX's
exactly; the plain version matches the TPU kernel's body run in interpret
mode (ELL) and the XLA block-ELL form within 1e-5 x sum_k |v_k x_k| per
row (float32, other summation order); m right-hand sides equal m single
calls exactly; each row's entry count equals the count the JAX layout
functions make (capped at K for ELL), and reading only those entries
gives the product over every slot.  Inputs are a symmetric sparse matrix
with skewed row lengths made from a numpy seed."""

import numpy as np
import pytest
import torch

from sqmc_tpu.ops import spmv_pallas as J
from sqmc_tpu_torch import convert
from sqmc_tpu_torch.ops import spmv as S

RTOL32 = 1e-5


def _coo(n=1100, seed=0):
    """Strictly-upper COO + diagonal: most rows short, a few long (up to
    ~300 entries), so ELL pads heavily and block-ELL rows span blocks."""
    rng = np.random.default_rng(seed)
    per_row = np.minimum(rng.geometric(0.08, n), 300)
    per_row[rng.integers(0, n, 3)] = 300
    r = np.repeat(np.arange(n), per_row)
    c = rng.integers(0, n, len(r))
    lo, hi = np.minimum(r, c), np.maximum(r, c)
    key = np.unique(lo[lo < hi] * n + hi[lo < hi])
    rows, cols = key // n, key % n
    return n, rows, cols, rng.standard_normal(len(rows)), rng.standard_normal(n)


@pytest.fixture(scope="module")
def coo():
    return _coo()


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _within(got, ref, bound, rtol):
    assert got.shape == ref.shape
    assert np.all(np.abs(np.asarray(got, np.float64) - ref) <= rtol * bound)


@pytest.mark.parametrize("k_max", [None, 40])
def test_ell_layout_equals_jax(coo, k_max):
    n = coo[0]
    cj, vj, Kj = J.ell_from_coo(*coo, k_max=k_max)
    ct, vt, Kt, ptr, nnz = S.ell_from_coo(*coo, k_max=k_max)
    assert Kt == Kj and ct.dtype == cj.dtype and vt.dtype == vj.dtype
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ptr, np.arange(n + 1) * Kt)
    assert nnz.dtype == np.int32
    np.testing.assert_array_equal(nnz, np.minimum(_row_counts(coo), Kj))


def test_blockell_layout_equals_jax(coo):
    n = coo[0]
    cj, vj, rj = J.blockell_from_coo(*coo)
    ct, vt, rt, ptr, nnz = S.blockell_from_coo(*coo)
    for a, b in ((ct, cj), (vt, vj), (rt, rj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ptr.dtype == np.int64 and ptr[0] == 0 and ptr[-1] == len(ct)
    np.testing.assert_array_equal(np.repeat(np.arange(n), np.diff(ptr) // 128),
                                  rj)
    assert nnz.dtype == np.int32
    np.testing.assert_array_equal(nnz, _row_counts(coo))
    # past each row's count only padding (column 0, value 0)
    pad = np.arange(len(ct)) >= np.repeat(ptr[:-1] + nnz, np.diff(ptr))
    assert not cj[pad].any() and not vj[pad].any()
    # float64 values for the walk's f64 state
    _, v64, _, _, _ = S.blockell_from_coo(*coo, dtype=np.float64)
    np.testing.assert_array_equal(v64.astype(np.float32), vj)


def _row_counts(coo):
    """Entries per row of the symmetric matrix (both orientations of the
    upper COO plus the diagonal), counted as the JAX layout functions
    count them."""
    n, rows, cols, _, _ = coo
    return np.bincount(np.concatenate([rows, cols, np.arange(n)]),
                       minlength=n)


def _abs_bound(cols2d, vals2d, xp):
    """sum_k |v_k x_k| per row and column, [rows, m]."""
    return np.einsum("rk,rkm->rm", np.abs(vals2d).astype(np.float64),
                     np.abs(xp[cols2d]).astype(np.float64))


@pytest.mark.parametrize("m", [1, 3])
def test_ell_spmv_matches_pallas_interpret(coo, m):
    """The port's plain ELL SpMV against K2's body, _spmv_pallas in
    interpret mode (as tests/test_spmv_pallas.py runs it on the CPU)."""
    n = coo[0]
    cols, vals, K, ptr, nnz = S.ell_from_coo(*coo)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, m)).astype(np.float32)
    xp = np.zeros((cols.shape[0], m), np.float32)
    xp[:n] = x
    ref = np.stack([np.asarray(J._spmv_pallas(xp[:, j], cols, vals,
                                              interpret=True))
                    for j in range(m)], axis=1)[:n]
    got = S.spmv(_t(x), _t(cols.reshape(-1)), _t(vals.reshape(-1)), _t(ptr),
                 _t(nnz))
    assert got.dtype == torch.float32 and got.shape == (n, m)
    _within(got.numpy(), ref, _abs_bound(cols, vals, xp)[:n], RTOL32)


def test_blockell_spmv_matches_jax(coo):
    n = coo[0]
    cols, vals, row, ptr, nnz = S.blockell_from_coo(*coo)
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    ref = np.asarray(J._spmv_blockell(x, cols, vals, row, n))
    got = S.spmv(_t(x), _t(cols), _t(vals), _t(ptr), _t(nnz))
    bound = np.zeros(n)
    np.add.at(bound, np.repeat(row, 128),
              np.abs(vals.astype(np.float64) * x[cols]))
    _within(got.numpy(), ref, bound, RTOL32)


@pytest.mark.parametrize("layout", ["ell", "blockell"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_multi_column_equals_column_by_column(coo, layout, dtype):
    n = coo[0]
    if layout == "ell":
        cols, vals, _, ptr, nnz = S.ell_from_coo(*coo)
        cols, vals = cols.reshape(-1), vals.reshape(-1)
    else:
        cols, vals, _, ptr, nnz = S.blockell_from_coo(*coo, dtype=np.float64)
    c, v, p, k = _t(cols), _t(vals).to(dtype), _t(ptr), _t(nnz)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((n, 4)),
                        dtype=dtype)
    y = S.spmv(x, c, v, p, k)
    assert y.dtype == dtype
    for j in range(4):
        assert torch.equal(y[:, j], S.spmv(x[:, j].contiguous(), c, v, p, k))


@pytest.mark.parametrize("layout", ["ell", "blockell"])
def test_row_counts_leave_the_product_unchanged(coo, layout):
    """spmv_plain over each row's first row_nnz slots equals it over every
    slot the row owns (counts = the row_ptr widths): the slots past the
    count are padding."""
    n = coo[0]
    if layout == "ell":
        cols, vals, _, ptr, nnz = S.ell_from_coo(*coo)
        cols, vals = cols.reshape(-1), vals.reshape(-1)
    else:
        cols, vals, _, ptr, nnz = S.blockell_from_coo(*coo)
    c, v, p = _t(cols), _t(vals), _t(ptr)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((n, 2)),
                        dtype=torch.float32)
    widths = p.diff().to(torch.int32)
    assert bool((_t(nnz) <= widths).all())
    assert torch.equal(S.spmv_plain(x, c, v, p, _t(nnz)),
                       S.spmv_plain(x, c, v, p, widths))


def test_float64_accumulates_in_float64(coo):
    """float64 inputs against the dense float64 product to 1e-13 of the
    row's absolute sum (float32 accumulation would miss by ~1e-7)."""
    n, rows, cols_, vals_, diag = coo
    cols, vals, _, ptr, nnz = S.blockell_from_coo(*coo, dtype=np.float64)
    M = np.zeros((n, n))
    M[rows, cols_] = vals_
    M = M + M.T + np.diag(diag)
    x = np.random.default_rng(4).standard_normal(n)
    got = S.spmv(torch.as_tensor(x), _t(cols), _t(vals), _t(ptr),
                 _t(nnz)).numpy()
    _within(got, M @ x, np.abs(M) @ np.abs(x), 1e-13)


def test_matvec_objects_match_jax(coo):
    """EllSpmv / BlockEllSpmv on a SparseHam carried over from JAX: [n]
    and [n, m] float64 inputs come back in float64, float32 inside."""
    class H:                           # the JAX SparseHam's fields
        n, rows, cols, vals, diag = coo
    Ht = convert.sparse_ham_from_numpy(H, device="cpu")
    x = np.random.default_rng(5).standard_normal((coo[0], 2))
    for jcls, tcls in ((J.EllSpmv, S.EllSpmv), (J.BlockEllSpmv, S.BlockEllSpmv)):
        ref = np.asarray(jcls(H)(x))
        mv = tcls(Ht)
        got = mv(torch.as_tensor(x))
        assert got.dtype == torch.float64 and got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-5)
        assert torch.equal(mv(torch.as_tensor(x[:, 1])), got[:, 1])


def test_wrapper_raises_off_cpu_and_cuda(coo):
    cols, vals, _, ptr, nnz = S.blockell_from_coo(*coo)
    x = torch.zeros(coo[0], device="meta")
    with pytest.raises(ValueError):
        S.spmv(x, *(_t(a).to("meta") for a in (cols, vals, ptr, nnz)))


def test_wrapper_checks_types(coo):
    cols, vals, _, ptr, nnz = S.blockell_from_coo(*coo)
    x = torch.zeros(coo[0])
    with pytest.raises(ValueError):            # int64 row counts
        S.spmv(x, _t(cols), _t(vals), _t(ptr), _t(nnz).long())
    with pytest.raises(ValueError):            # float64 x, float32 vals
        S.spmv(x.double(), _t(cols), _t(vals), _t(ptr), _t(nnz))
    with pytest.raises(ValueError):            # int64 column indices
        S.spmv(x, _t(cols).long(), _t(vals), _t(ptr), _t(nnz))
    with pytest.raises(ValueError):            # [n, m, k] x
        S.spmv(x[:, None, None], _t(cols), _t(vals), _t(ptr), _t(nnz))
