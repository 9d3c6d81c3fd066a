"""Sorted set algebra over packed determinant keys (port of
sqmc_tpu/ops/setalg.py).

Determinant sets are kept sorted by the (up, dn) key, up-major and most
significant word first - the JAX package's unsigned order, reached here
by comparing flipped int64 words (``dets.flip``).  Every index array these
functions return equals the JAX package's: the sorts are stable, as
``np.lexsort`` is.

All functions take int64 word tensors [n, W] on any device and return
tensors on the same device; result sizes are data dependent, so these
are setup-path helpers (one host sync each), not walk-step code.
"""

from __future__ import annotations

import torch

from ..dets import flip


def lexsort_dets(up: torch.Tensor, dn: torch.Tensor) -> torch.Tensor:
    """Stable sort order of packed dets by (up, dn). [n,W]x2 -> perm [n]."""
    n, W = up.shape
    perm = torch.arange(n, device=up.device)
    # least significant key first: dn words low->high, then up words
    for col in [dn[:, w] for w in range(W)] + [up[:, w] for w in range(W)]:
        perm = perm[torch.argsort(flip(col)[perm], stable=True)]
    return perm


def dets_equal_adjacent(up: torch.Tensor, dn: torch.Tensor) -> torch.Tensor:
    """Bool [n]: row equals the previous row (for sorted arrays)."""
    same = torch.zeros(len(up), dtype=torch.bool, device=up.device)
    if len(up) > 1:
        same[1:] = ((up[1:] == up[:-1]).all(dim=1)
                    & (dn[1:] == dn[:-1]).all(dim=1))
    return same


def unique_dets(up, dn, payloads=None, sum_payloads: bool = True):
    """Sort by key and merge duplicates.

    payloads: list of [n]- or [n,k]-shaped tensors; numeric duplicates are
    summed in sorted order (sum_payloads=True) or the first occurrence is
    kept.  Returns (up_u, dn_u, payloads_u, inverse)."""
    order = lexsort_dets(up, dn)
    up_s, dn_s = up[order], dn[order]
    dup = dets_equal_adjacent(up_s, dn_s)
    group = torch.cumsum((~dup).to(torch.int64), 0) - 1
    first = torch.nonzero(~dup).reshape(-1)
    n_u = len(first)
    outs = []
    for p in payloads or []:
        p_s = p[order]
        if sum_payloads and p_s.dtype != torch.bool:
            acc = p_s.new_zeros((n_u,) + tuple(p_s.shape[1:]))
            # ordered on the card (no atomics): sums repeat bit for bit
            acc.index_put_((group,), p_s, accumulate=True)
            outs.append(acc)
        else:
            outs.append(p_s[first])
    inverse = torch.empty(len(up), dtype=torch.int64, device=up.device)
    inverse[order] = group
    return up_s[first], dn_s[first], outs, inverse


def lex_less_eq(a_up, a_dn, b_up, b_dn):
    """(a < b, a == b) elementwise in the det order, for [..., W] pairs."""
    lt = torch.zeros(a_up.shape[:-1], dtype=torch.bool, device=a_up.device)
    eq = torch.ones_like(lt)
    for arr_a, arr_b in ((a_up, b_up), (a_dn, b_dn)):
        for w in range(a_up.shape[-1] - 1, -1, -1):
            aw, bw = flip(arr_a[..., w]), flip(arr_b[..., w])
            lt = lt | (eq & (aw < bw))
            eq = eq & (aw == bw)
    return lt, eq


def keys_less(up_a, dn_a, up_b, dn_b) -> torch.Tensor:
    """Elementwise (up_a, dn_a) < (up_b, dn_b) in the JAX package's
    unsigned det order (up-major, most significant word first), on flipped
    words: a raw int64 compare would invert every word with bit 63 set.
    The time-reversal representative of a det is the orientation with
    ``not keys_less(dn, up, up, dn)``."""
    return lex_less_eq(up_a, dn_a, up_b, dn_b)[0]


def lower_bound_dets(list_up, list_dn, q_up, q_dn) -> torch.Tensor:
    """Count of list entries whose key is < each query (bisection over a
    sorted list; works for any word count)."""
    n = len(list_up)
    lo = torch.zeros(len(q_up), dtype=torch.int64, device=q_up.device)
    hi = torch.full_like(lo, n)
    for _ in range(max(n, 1).bit_length() + 1):
        mid = (lo + hi) // 2
        mc = mid.clamp(0, max(n - 1, 0))
        less, _ = lex_less_eq(list_up[mc], list_dn[mc], q_up, q_dn)
        go = less & (lo < hi)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return lo


def search_dets(up_sorted, dn_sorted, up_q, dn_q) -> torch.Tensor:
    """Index of each query in a sorted det list, -1 if absent (int64)."""
    n = len(up_sorted)
    if n == 0:
        return torch.full((len(up_q),), -1, dtype=torch.int64,
                          device=up_q.device)
    idx = lower_bound_dets(up_sorted, dn_sorted, up_q, dn_q).clamp(0, n - 1)
    _, found = lex_less_eq(up_sorted[idx], dn_sorted[idx], up_q, dn_q)
    return torch.where(found, idx, torch.full_like(idx, -1))


def setdiff_dets(up_a, dn_a, up_b, dn_b) -> torch.Tensor:
    """Bool mask over a: rows of a not present in b (b in any order)."""
    if len(up_b) == 0:
        return torch.ones(len(up_a), dtype=torch.bool, device=up_a.device)
    order = lexsort_dets(up_b, dn_b)
    return search_dets(up_b[order], dn_b[order], up_a, dn_a) < 0
