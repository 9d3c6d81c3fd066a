"""Plain Slater-Condon matrix elements between determinants of W int64
words a spin, in PyTorch: the reference for dets past one word a spin
(reference/slater.py reads one word, at most 62 orbitals).

The benchmark's own reference: it imports nothing of the program.  A spin
string is an int64 tensor [..., W]; spatial orbital o is bit o % 64 of
word o // 64, all 64 bits of a word in use (the sign bit too).  Every
operation on a word is a bitwise one, a shift by 0 to 63, or a popcount,
so the sign bit needs no care.  The order of the spin-orbitals is all up
orbitals, then all down orbitals, so an excitation's sign counts only the
occupied orbitals of its own spin string that lie between the two
orbitals it moves.

Integrals are a dense one-body matrix ``h[p, q]`` and a dense two-body
tensor ``eri[p, q, r, s] = (pq|rs)`` in chemists' notation, as for
slater.Hamiltonian.  Plain determinants only: no time-reversal basis.
Everything is float64; no matrix product runs in TF32.
"""

from __future__ import annotations

import torch

from .slater import lowest_bit, popcount

F64 = torch.float64
I64 = torch.int64
BITS = 64
NONE = 1 << 20                  # "no set bit": past every orbital


def n_words(norb: int) -> int:
    return (norb + BITS - 1) // BITS


def count(x: torch.Tensor) -> torch.Tensor:
    """Set bits over the word axis: [..., W] -> [...]."""
    return popcount(x).sum(-1)


def _below(k: torch.Tensor) -> torch.Tensor:
    """The word whose bits [0, k) are set, for 0 <= k <= 64."""
    one = torch.ones_like(k)
    return torch.where(k >= BITS, -one, (one << k.clamp(max=BITS - 1)) - 1)


def onehot(o: torch.Tensor, W: int) -> torch.Tensor:
    """The string [..., W] with only orbital o set."""
    w = torch.arange(W, dtype=I64, device=o.device)
    return torch.where(w == (o // BITS)[..., None],
                       torch.ones_like(o)[..., None] << (o % BITS)[..., None],
                       torch.zeros((), dtype=I64, device=o.device))


def lowest(x: torch.Tensor) -> torch.Tensor:
    """The lowest set orbital of each string [..., W] (NONE when empty)."""
    W = x.shape[-1]
    base = BITS * torch.arange(W, dtype=I64, device=x.device)
    at = torch.where(x != 0, lowest_bit(x) + base, NONE)
    return at.min(-1).values


def between(s: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Set orbitals of each string s [n, W] strictly between a and b."""
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    W = s.shape[-1]
    base = BITS * torch.arange(W, dtype=I64, device=s.device)
    top = (hi[:, None] - base).clamp(0, BITS)
    bot = (lo[:, None] + 1 - base).clamp(0, BITS)
    return popcount(s & _below(top) & ~_below(bot)).sum(-1)


def past(s: torch.Tensor, norb: int) -> torch.Tensor:
    """Whether a string [n, W] has a bit set at orbital norb or above."""
    W = s.shape[-1]
    base = BITS * torch.arange(W, dtype=I64, device=s.device)
    keep = _below((norb - base).clamp(0, BITS))
    return ((s & ~keep) != 0).any(-1)


def bits(s: torch.Tensor, norb: int) -> torch.Tensor:
    """The occupations [..., norb] (0 or 1, int64) of strings [..., W]."""
    o = torch.arange(norb, dtype=I64, device=s.device)
    return (s[..., o // BITS] >> (o % BITS)) & 1


def _sign(n: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 * (n & 1).to(F64)


class Hamiltonian:
    """H over plain determinants of `norb` orbitals, W words a spin, from
    dense integrals."""

    time_sym, z = False, 1

    def __init__(self, h, eri, core: float, norb: int, device="cpu"):
        self.norb, self.core = norb, float(core)
        self.W = n_words(norb)
        self.h = torch.as_tensor(h, dtype=F64, device=device)
        self.eri = torch.as_tensor(eri, dtype=F64, device=device)
        idx = torch.arange(norb, device=device)
        self.J = self.eri[idx[:, None], idx[:, None], idx[None, :],
                          idx[None, :]]                      # (ii|jj)
        self.K = self.eri[idx[:, None], idx[None, :], idx[None, :],
                          idx[:, None]]                      # (ij|ji)
        self.orbs = idx.to(I64)

    def occ(self, s: torch.Tensor) -> torch.Tensor:
        return bits(s, self.norb).to(F64)

    def diag(self, up, dn) -> torch.Tensor:
        """<i|H|i> for dets given by strings up, dn [n, W]."""
        ou, od = self.occ(up), self.occ(dn)
        hd = torch.diagonal(self.h)
        ot = ou + od
        two = ((ot @ self.J) * ot).sum(1) - ((ou @ self.K) * ou).sum(1) \
            - ((od @ self.K) * od).sum(1)
        return self.core + ot @ hd + 0.5 * two

    def _single(self, s_i, o_same, o_other, x):
        """A single excitation within string s_i (orbital p to r, x = s_i ^
        s_j), the other spin's occupations o_other."""
        p = lowest(s_i & x)
        r = lowest(x & ~s_i)
        k = self.orbs[None, :]
        pp, rr = p[:, None], r[:, None]
        Jk = self.eri[pp, rr, k, k]
        Kk = self.eri[pp, k, k, rr]
        o_s = o_same.clone()
        o_s[torch.arange(len(p), device=p.device), p] = 0.0
        val = self.h[p, r] + (o_s * (Jk - Kk)).sum(1) + (o_other * Jk).sum(1)
        return _sign(between(s_i, p, r)) * val

    def _double_same(self, s_i, x):
        rem, add = s_i & x, x & ~s_i
        p = lowest(rem)
        q = lowest(rem ^ onehot(p, self.W))
        r = lowest(add)
        s = lowest(add ^ onehot(r, self.W))
        s1 = between(s_i, p, r)
        mid = s_i ^ onehot(p, self.W) ^ onehot(r, self.W)
        s2 = between(mid, q, s)
        return _sign(s1 + s2) * (self.eri[p, r, q, s] - self.eri[p, s, q, r])

    def _double_opp(self, ui, di, xu, xd):
        p, r = lowest(ui & xu), lowest(xu & ~ui)
        q, s = lowest(di & xd), lowest(xd & ~di)
        sg = _sign(between(ui, p, r) + between(di, q, s))
        return sg * self.eri[p, r, q, s]

    def pairs(self, ui, di, uj, dj) -> torch.Tensor:
        """<i|H|j> for pairs of dets (strings [n, W] each)."""
        xu, xd = ui ^ uj, di ^ dj
        eu, ed = count(xu) // 2, count(xd) // 2
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

    def connected(self, ui, di, uj, dj) -> torch.Tensor:
        """Whether <i|H|j> can be nonzero: at most a double apart."""
        return count(ui ^ uj) + count(di ^ dj) <= 4

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
            ok = self.connected(ru[:, None], rd[:, None], col_up[None],
                                col_dn[None])
            i, j = torch.nonzero(ok, as_tuple=True)
            if len(i):
                el = self.pairs(ru[i], rd[i], col_up[j], col_dn[j])
                out[a:a + step].index_add_(0, i, el * vec[j])
        return out

    def rows(self, row_up, row_dn, col_up, col_dn) -> torch.Tensor:
        """The dense block H(row_i, col_j) [n_r, n_c] (for a few rows)."""
        ok = self.connected(row_up[:, None], row_dn[:, None], col_up[None],
                            col_dn[None])
        i, j = torch.nonzero(ok, as_tuple=True)
        out = torch.zeros(ok.shape, dtype=F64, device=row_up.device)
        out[i, j] = self.pairs(row_up[i], row_dn[i], col_up[j], col_dn[j])
        return out
