"""Walker alias tables (port of sqmc_tpu/ops/alias.py; ref:
more_tools.f90 setup_alias:5603, sample_alias:5665).

The tables are built on the host (numpy Vose); :func:`sample_alias` draws
from them on their device with an explicit ``torch.Generator`` (the
semistochastic PT's reference sampler).  The walk samples its heat-bath
tables inline in ``algo/walk.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def setup_alias_np(prob: np.ndarray):
    """Alias tables for a discrete distribution.  prob: [K] nonnegative,
    sums to 1.  Returns (J [K] int32 alias index, q [K] float64 acceptance
    threshold): draw slot k uniformly, keep it with probability q[k],
    else take J[k]."""
    prob = np.asarray(prob, np.float64)
    K = len(prob)
    q = prob * K
    J = np.arange(K, dtype=np.int32)
    small = [i for i in range(K) if q[i] < 1.0]
    large = [i for i in range(K) if q[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        J[s] = l
        q[l] = q[l] - (1.0 - q[s])
        if q[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    return J, q


def alias_probabilities(J: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The distribution a pair of alias tables samples (for tests and
    checks): p[i] = (q[i] + sum_{k: J[k]=i} (1 - q[k])) / K."""
    J = np.asarray(J, np.int64)
    q = np.minimum(np.asarray(q, np.float64), 1.0)
    K = len(q)
    p = q.copy()
    np.add.at(p, J, 1.0 - q)
    return p / K


def sample_alias(gen: torch.Generator, J: torch.Tensor, q: torch.Tensor,
                 n: int) -> torch.Tensor:
    """n iid draws from alias tables J (int) and q (float64) on their
    device: a uniform slot, kept with probability q[slot], else its alias.
    gen must live on the tables' device.  Returns int32 [n]."""
    K = J.shape[0]
    idx = torch.randint(0, K, (n,), generator=gen, device=J.device)
    u = torch.rand(n, dtype=torch.float64, generator=gen, device=J.device)
    return torch.where(u < q[idx], idx, J[idx].to(idx.dtype)).to(torch.int32)
