"""Plain Slater-Condon matrix elements between determinants, in PyTorch.

The benchmark's own reference: it imports nothing of the program.  A
determinant is a pair of int64 bit strings (bit o set = spatial orbital o
occupied), one word a spin, so at most 62 orbitals.  The order of the
spin-orbitals is all up orbitals, then all down orbitals, so an
excitation's sign counts only the occupied orbitals of its own spin
string that lie between the two orbitals it moves.

Integrals are a dense one-body matrix ``h[p, q]`` and a dense two-body
tensor ``eri[p, q, r, s] = (pq|rs)`` in chemists' notation, built by the
caller from the raw FCIDUMP or from the electron gas's k-vectors.

In the time-reversal symmetrized basis of sector z (a representative
det i with up <= down stands for (|i> + z |rev i>) / sqrt 2, or |i> when
its two strings are equal), the element is

    norm_i * norm_j^-1 * (H(i, j) + z H(rev i, j))

with norm = sqrt 2 for a self-symmetric det and 1 otherwise, H(rev i, j)
replaced by H(i, j) when j is self-symmetric and dropped when i is (the
reference code's hamiltonian_chem_time_sym).
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
I64 = torch.int64
SQRT2 = math.sqrt(2.0)

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_H01 = 0x0101010101010101


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word (SWAR; the product wraps as intended)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * _H01) >> 56) & 0x7F


def lowest_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of each nonzero word."""
    return popcount((x & -x) - 1)


def _between(s: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Occupied orbitals of string s strictly between orbitals a and b."""
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    one = torch.ones_like(s)
    mask = ((one << hi) - 1) & ~((one << (lo + 1)) - 1)
    return popcount(s & mask)


def _sign(n: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 * (n & 1).to(F64)


class Hamiltonian:
    """H over determinants of `norb` orbitals from dense integrals."""

    def __init__(self, h, eri, core: float, norb: int, time_sym=False,
                 z: int = 1, device="cpu"):
        if norb > 62:
            raise ValueError("one word a spin: at most 62 orbitals")
        self.norb, self.core = norb, float(core)
        self.time_sym, self.z = bool(time_sym), int(z)
        self.h = torch.as_tensor(h, dtype=F64, device=device)
        self.eri = torch.as_tensor(eri, dtype=F64, device=device)
        idx = torch.arange(norb, device=device)
        self.J = self.eri[idx[:, None], idx[:, None], idx[None, :],
                          idx[None, :]]                      # (ii|jj)
        self.K = self.eri[idx[:, None], idx[None, :], idx[None, :],
                          idx[:, None]]                      # (ij|ji)
        self.orbs = idx.to(I64)

    # -- plain determinants -------------------------------------------------
    def occ(self, s: torch.Tensor) -> torch.Tensor:
        return ((s[:, None] >> self.orbs[None, :]) & 1).to(F64)

    def diag(self, up, dn) -> torch.Tensor:
        """<i|H|i> for dets given by words up, dn [n]."""
        ou, od = self.occ(up), self.occ(dn)
        hd = torch.diagonal(self.h)
        ot = ou + od
        two = ((ot @ self.J) * ot).sum(1) - ((ou @ self.K) * ou).sum(1) \
            - ((od @ self.K) * od).sum(1)
        return self.core + ot @ hd + 0.5 * two

    def _single(self, s_i, o_same, o_other, x):
        """A single excitation within string s_i (moving orbital p to r,
        x = s_i ^ s_j), the other spin's occupations o_other."""
        p = lowest_bit(s_i & x)
        r = lowest_bit(x & ~s_i)
        k = self.orbs[None, :]
        pp, rr = p[:, None], r[:, None]
        Jk = self.eri[pp, rr, k, k]
        Kk = self.eri[pp, k, k, rr]
        o_s = o_same.clone()
        o_s[torch.arange(len(p), device=p.device), p] = 0.0
        val = self.h[p, r] + (o_s * (Jk - Kk)).sum(1) + (o_other * Jk).sum(1)
        return _sign(_between(s_i, p, r)) * val

    def _double_same(self, s_i, x):
        rem, add = s_i & x, x & ~s_i
        p = lowest_bit(rem)
        q = lowest_bit(rem & (rem - 1))
        r = lowest_bit(add)
        s = lowest_bit(add & (add - 1))
        one = torch.ones_like(s_i)
        s1 = _between(s_i, p, r)
        mid = s_i ^ (one << p) ^ (one << r)
        s2 = _between(mid, q, s)
        val = self.eri[p, r, q, s] - self.eri[p, s, q, r]
        return _sign(s1 + s2) * val

    def _double_opp(self, ui, di, xu, xd):
        p, r = lowest_bit(ui & xu), lowest_bit(xu & ~ui)
        q, s = lowest_bit(di & xd), lowest_bit(xd & ~di)
        sg = _sign(_between(ui, p, r) + _between(di, q, s))
        return sg * self.eri[p, r, q, s]

    def plain_pairs(self, ui, di, uj, dj) -> torch.Tensor:
        """<i|H|j> for pairs of plain dets (words [n] each)."""
        xu, xd = ui ^ uj, di ^ dj
        eu, ed = popcount(xu) // 2, popcount(xd) // 2
        out = torch.zeros(len(ui), dtype=F64, device=ui.device)
        cases = (
            ((eu == 0) & (ed == 0), lambda m: self.diag(ui[m], di[m])),
            ((eu == 1) & (ed == 0), lambda m: self._single(
                ui[m], self.occ(ui[m]), self.occ(di[m]), xu[m])),
            ((eu == 0) & (ed == 1), lambda m: self._single(
                di[m], self.occ(di[m]), self.occ(ui[m]), xd[m])),
            ((eu == 2) & (ed == 0), lambda m: self._double_same(ui[m], xu[m])),
            ((eu == 0) & (ed == 2), lambda m: self._double_same(di[m], xd[m])),
            ((eu == 1) & (ed == 1), lambda m: self._double_opp(
                ui[m], di[m], xu[m], xd[m])),
        )
        for mask, fn in cases:
            m = torch.nonzero(mask).flatten()
            if len(m):
                out[m] = fn(m)
        return out

    # -- the system's basis -------------------------------------------------
    def pairs(self, ui, di, uj, dj) -> torch.Tensor:
        """<i|H|j> in the system's basis (plain or time-symmetrized)."""
        m1 = self.plain_pairs(ui, di, uj, dj)
        if not self.time_sym:
            return m1
        sym_i, sym_j = ui == di, uj == dj
        m2 = torch.where(sym_j, m1, self.plain_pairs(di, ui, uj, dj))
        m2 = torch.where(sym_i, torch.zeros_like(m2), m2)
        one = torch.ones_like(m1)
        norm = torch.where(sym_i, SQRT2 * one, one) * torch.where(
            sym_j, one / SQRT2, one)
        return norm * (m1 + self.z * m2)

    def connected(self, ui, di, uj, dj) -> torch.Tensor:
        """Whether <i|H|j> can be nonzero in the system's basis: at most a
        double excitation apart (for either orientation of i)."""
        lvl = popcount(ui ^ uj) + popcount(di ^ dj)
        ok = lvl <= 4
        if self.time_sym:
            ok = ok | (popcount(di ^ uj) + popcount(ui ^ dj) <= 4)
        return ok

    def matvec(self, row_up, row_dn, col_up, col_dn, vec,
               block: int = 1 << 22) -> torch.Tensor:
        """sum_j H(row_i, col_j) vec_j for every row (float64), over all
        pairs in blocks of rows, each screened by excitation level."""
        n_r, n_c = len(row_up), len(col_up)
        out = torch.zeros(n_r, dtype=F64, device=row_up.device)
        vec = vec.to(F64)
        step = max(1, block // max(n_c, 1))
        for a in range(0, n_r, step):
            ru, rd = row_up[a:a + step], row_dn[a:a + step]
            ok = self.connected(ru[:, None], rd[:, None], col_up[None, :],
                                col_dn[None, :])
            i, j = torch.nonzero(ok, as_tuple=True)
            if len(i):
                el = self.pairs(ru[i], rd[i], col_up[j], col_dn[j])
                out[a:a + step].index_add_(0, i, el * vec[j])
        return out

    def rows(self, row_up, row_dn, col_up, col_dn) -> torch.Tensor:
        """The dense block H(row_i, col_j) [n_r, n_c] (for a few rows)."""
        ok = self.connected(row_up[:, None], row_dn[:, None], col_up[None, :],
                            col_dn[None, :])
        i, j = torch.nonzero(ok, as_tuple=True)
        out = torch.zeros(ok.shape, dtype=F64, device=row_up.device)
        out[i, j] = self.pairs(row_up[i], row_dn[i], col_up[j], col_dn[j])
        return out
