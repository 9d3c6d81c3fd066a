"""The lowest eigenpair of H over a set of determinants, worked out by
the reference alone: the dense block H(D, D) from its own matrix
elements, then Lanczos with full reorthogonalization, restarted from the
Ritz vector until the residual is below `tol`."""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def dense(H, up, dn, block: int = 1024) -> torch.Tensor:
    """H(i, j) over the dets (words up, dn [n]) as a dense [n, n] matrix
    in the system's basis, built in blocks of rows."""
    n = len(up)
    out = torch.empty((n, n), dtype=F64, device=up.device)
    for a in range(0, n, block):
        out[a:a + block] = H.rows(up[a:a + block], dn[a:a + block], up, dn)
    return out


def lowest(A: torch.Tensor, tol: float = 1e-9, steps: int = 120,
           restarts: int = 30):
    """(eigenvalue, unit eigenvector) of the lowest eigenpair of the
    symmetric A; raises when the residual does not fall below tol."""
    n = A.shape[0]
    if n <= steps:
        w, v = torch.linalg.eigh(A)
        return float(w[0]), v[:, 0]
    x = torch.ones(n, dtype=F64, device=A.device)
    x[torch.argmin(torch.diagonal(A))] += n ** 0.5   # near the lowest det
    x /= torch.linalg.norm(x)
    for _ in range(restarts):
        V = torch.zeros((steps, n), dtype=F64, device=A.device)
        alpha, beta = np.zeros(steps), np.zeros(steps)
        V[0] = x
        m = steps
        for k in range(steps):
            w = A @ V[k]
            alpha[k] = float(V[k] @ w)
            w -= V[:k + 1].T @ (V[:k + 1] @ w)       # full reorthogonalization
            w -= V[:k + 1].T @ (V[:k + 1] @ w)
            b = float(torch.linalg.norm(w))
            if k + 1 == steps or b < 1e-14:
                m = k + 1
                break
            beta[k] = b
            V[k + 1] = w / b
        T = np.diag(alpha[:m]) + np.diag(beta[:m - 1], 1) \
            + np.diag(beta[:m - 1], -1)
        theta, y = np.linalg.eigh(T)
        x = torch.as_tensor(y[:, 0], device=A.device) @ V[:m]
        x /= torch.linalg.norm(x)
        res = float(torch.linalg.norm(A @ x - theta[0] * x))
        if res < tol:
            return float(theta[0]), x
    raise RuntimeError(f"Lanczos did not converge: residual {res:.3e}")
