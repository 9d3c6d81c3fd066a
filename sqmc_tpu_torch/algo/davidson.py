"""Block Davidson eigensolver on the sparse COO Hamiltonian (port of
sqmc_tpu/algo/davidson.py; ref: more_tools.f90 davidson_sparse:2018).

The matvec is a float64 ordered scatter-add over the symmetric COO on the
Hamiltonian's device (both orientations of the stored upper triangle plus
the diagonal), or the caller's ``matvec_fn`` (device HCI passes the
float32 block-ELL SpMV); the small Rayleigh-Ritz algebra runs on the host
in numpy, exactly as in the JAX package.

:func:`arpack_diagonalize` is the ARPACK alternative (scipy ``eigsh``,
the library the reference's optional PARPACK build wraps): its operator
is the float64 block-ELL SpMV, the hand kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import timers
from ..utils.precision import full_fp32_matmul
from .sparseham import SparseHam


def matvec(H: SparseHam, v: torch.Tensor) -> torch.Tensor:
    """y = H v for the symmetric COO. v: [n] or [n, k] float64."""
    single = v.dim() == 1
    if single:
        v = v[:, None]
    y = H.diag[:, None] * v
    # index_put_(accumulate=True) sums duplicates in a sorted, fixed order
    # on the card (index_add_ uses atomics): the same H and v give the same
    # bits in every run, so the selection that follows repeats
    y.index_put_((H.rows,), H.vals[:, None] * v[H.cols], accumulate=True)
    y.index_put_((H.cols,), H.vals[:, None] * v[H.rows], accumulate=True)
    return y[:, 0] if single else y


def davidson(H: SparseHam, n_states: int = 1,
             initial: np.ndarray | None = None,
             tol: float = 1e-10, max_iter: int = 200,
             m_max: int | None = None, verbose: bool = False,
             matvec_fn=None):
    """Lowest n_states eigenpairs.  Returns (evals [k], evecs [n,k]) as
    float64 numpy arrays.  initial: optional [n, k] starting vectors.
    matvec_fn: optional replacement for the COO matvec, called on a
    float64 [n, k] tensor on H's device - e.g. ops.spmv.BlockEllSpmv, the
    device-Davidson matvec.  Traced (utils/timers), it counts
    davidson_iters and matvecs (vectors multiplied by H) on the open
    span."""
    full_fp32_matmul()
    n = H.n
    k = n_states
    if matvec_fn is None and (n <= k or n < 50):
        w, U = np.linalg.eigh(H.dense().cpu().numpy())     # tiny problems
        return w[:k], U[:, :k]
    dev = H.vals.device
    mv = matvec_fn if matvec_fn is not None else (lambda V: matvec(H, V))

    def apply(V):
        timers.count("matvecs", V.shape[1])
        return mv(torch.as_tensor(V, device=dev)).cpu().numpy()

    if m_max is None:
        m_max = max(8 * k, 48)
    diag_np = H.diag.cpu().numpy()

    rng = np.random.default_rng(0)
    if initial is not None and initial.shape[1] >= 1:
        V = initial[:, :k].astype(np.float64).copy()
    else:
        V = np.zeros((n, k))
        order = np.argsort(diag_np)
        for i in range(k):
            V[order[i], i] = 1.0
    V, _ = np.linalg.qr(V)
    if V.shape[1] < k:
        V = np.concatenate([V, rng.normal(size=(n, k - V.shape[1]))], axis=1)
        V, _ = np.linalg.qr(V)

    W = apply(V)
    theta_old = np.full(k, np.inf)
    evals = None
    X = V[:, :k]
    it = -1
    for it in range(max_iter):
        G = V.T @ W
        G = 0.5 * (G + G.T)
        w_r, S = np.linalg.eigh(G)
        evals = w_r[:k]
        X = V @ S[:, :k]
        HX = W @ S[:, :k]
        if np.max(np.abs(evals - theta_old)) < tol:
            break
        theta_old = evals.copy()
        if verbose:
            print(f"davidson iter {it}: " + " ".join(f"{e:.9f}" for e in evals))
        R = HX - X * evals[None, :]
        denom = evals[None, :] - diag_np[:, None]
        denom = np.where(np.abs(denom) < 1e-8, -1.0, denom)
        T = R / denom
        for _ in range(2):
            T = T - V @ (V.T @ T)
        keep = []
        for i in range(T.shape[1]):
            nrm = np.linalg.norm(T[:, i])
            if nrm > 1e-8:
                T[:, i] /= nrm
                for j_ in keep:
                    T[:, i] -= T[:, j_] * (T[:, j_] @ T[:, i])
                nrm2 = np.linalg.norm(T[:, i])
                if nrm2 > 1e-6:
                    T[:, i] /= nrm2
                    keep.append(i)
        if not keep:
            break
        T = T[:, keep]
        if V.shape[1] + T.shape[1] > m_max:
            V = X.copy()          # restart on the current Ritz vectors
            W = HX.copy()
            T = T - V @ (V.T @ T)
            nrms = np.linalg.norm(T, axis=0)
            T = T[:, nrms > 1e-8] / np.maximum(nrms[nrms > 1e-8], 1e-30)
            if T.shape[1] == 0:
                break
        HT = apply(T)
        V = np.concatenate([V, T], axis=1)
        W = np.concatenate([W, HT], axis=1)
    timers.count("davidson_iters", it + 1)
    return np.asarray(evals), np.asarray(X)


def arpack_diagonalize(H: SparseHam, n_states: int = 1,
                       initial: np.ndarray | None = None, tol: float = 0.0):
    """ARPACK alternative diagonalizer (ref: parpack_diagonalize,
    more_tools.f90:2869; scipy bundles the same ARPACK library), with the
    contract of davidson(): returns (evals [k], evecs [n, k]).  The
    operator's matvec is ops.spmv.BlockEllSpmv in float64 on H's device
    (the kernel on the card, its plain version on the CPU), called once
    per ARPACK step from the host."""
    from scipy.sparse.linalg import LinearOperator, eigsh
    from ..ops.spmv import BlockEllSpmv

    n, k = H.n, n_states
    if n <= max(2 * k + 1, 16):
        w, v = np.linalg.eigh(H.dense().cpu().numpy())
        return w[:k], v[:, :k]
    mv = BlockEllSpmv(H, dtype=np.float64)
    dev = H.vals.device

    def apply(x):
        return mv(torch.as_tensor(np.asarray(x, np.float64),
                                  device=dev)).cpu().numpy()

    A = LinearOperator((n, n), matvec=apply, matmat=apply, dtype=np.float64)
    v0 = None
    if initial is not None and initial.shape[0] == n:
        v0 = np.asarray(initial[:, 0], np.float64)
        nrm = np.linalg.norm(v0)
        v0 = v0 / nrm if nrm > 0 else None
    w, v = eigsh(A, k=k, which="SA", v0=v0, tol=tol)
    order = np.argsort(w)
    return w[order], v[:, order]
