"""Packed Slater-determinant bit strings (torch port of sqmc_tpu/dets.py).

A spin component is a bit string over ``norb`` spatial orbitals packed
into ``W = ceil(norb/64)`` words, shape [..., W]: bit ``o`` (word
``o//64``, bit ``o%64``) set means orbital ``o`` is occupied.

Words are stored as **int64** (the JAX package uses uint64; torch has no
uint64 shifts or searchsorted).  The bit patterns are identical, so
``np.ndarray.view`` moves words between the two packages.  Sorting and
searching use :func:`flip` (``w ^ (1 << 63)``), which maps unsigned order
onto signed order; the all-ones sentinel (-1) flips to the int64 maximum
and still sorts last.

Only bitwise ops and shifts by amounts in [0, 63] touch full words, so no
signed overflow occurs anywhere in this module.
"""

from __future__ import annotations

import numpy as np
import torch

BITS_PER_WORD = 64
SIGN_BIT = -(1 << 63)            # int64 with only bit 63 set
SENTINEL = -1                    # all-ones word: empty walker slot

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_LO32 = 0xFFFFFFFF


def n_words(norb: int) -> int:
    """Number of 64-bit words needed for norb orbitals."""
    return (norb + BITS_PER_WORD - 1) // BITS_PER_WORD


def flip(words: torch.Tensor) -> torch.Tensor:
    """Order-preserving map from unsigned to signed word order."""
    return words ^ SIGN_BIT


# ---------------------------------------------------------------------------
# Host-side constructors (numpy int64)
# ---------------------------------------------------------------------------

def det_from_orbs(occ, norb: int) -> np.ndarray:
    """Pack occupied orbital indices (0-based) into int64 words [W]."""
    words = np.zeros(n_words(norb), dtype=np.uint64)
    for o in occ:
        if not 0 <= o < norb:
            raise ValueError(f"orbital index {o} out of range [0,{norb})")
        words[o // BITS_PER_WORD] |= np.uint64(1) << np.uint64(o % BITS_PER_WORD)
    return words.view(np.int64)


def orbs_from_det(words, norb: int) -> list:
    """Occupied orbital indices (ascending) of a single packed det."""
    w = np.asarray(words, dtype=np.int64).view(np.uint64)
    return [o for o in range(norb)
            if (int(w[o // BITS_PER_WORD]) >> (o % BITS_PER_WORD)) & 1]


def host_u64(words) -> np.ndarray:
    """Det words (int64 or uint64, tensor or array) as a host uint64 array
    with the same bits: the JAX package's and the reference files' type."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    w = np.ascontiguousarray(words)
    return w.view(np.uint64) if w.dtype == np.int64 else w.astype(np.uint64)


# ---------------------------------------------------------------------------
# Batched tensor ops
# ---------------------------------------------------------------------------

def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set-bit count of each int64 element (SWAR; every intermediate stays
    non-negative, so the arithmetic shifts behave as logical ones)."""
    x = (x & _M1) + ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set-bit count over the word axis. [..., W] -> [...] int32."""
    return popcount64(words).sum(dim=-1).to(torch.int32)


def to_bits(words: torch.Tensor, norb: int) -> torch.Tensor:
    """Unpack words [..., W] to a dense occupancy uint8[..., norb] (only
    the norb bits in use are expanded)."""
    parts = []
    for w in range(words.shape[-1]):
        nb = min(BITS_PER_WORD, norb - BITS_PER_WORD * w)
        if nb <= 0:
            break
        shifts = torch.arange(nb, dtype=torch.int64, device=words.device)
        parts.append((words[..., w, None] >> shifts) & 1)
    bits = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return bits.to(torch.uint8)


def from_bits(bits: torch.Tensor, norb: int) -> torch.Tensor:
    """Pack a dense occupancy uint8[..., norb] into int64 words [..., W]
    (distinct bits never carry, so the sum is the bitwise or)."""
    W = n_words(norb)
    pad = W * BITS_PER_WORD - norb
    b = bits.to(torch.int64)
    if pad:
        b = torch.cat([b, b.new_zeros((*b.shape[:-1], pad))], dim=-1)
    b = b.reshape(*b.shape[:-1], W, BITS_PER_WORD)
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int64, device=b.device)
    return (b << shifts).sum(dim=-1)


def occ_orbitals(bits: torch.Tensor, n_elec: int) -> torch.Tensor:
    """Ascending indices of the n_elec set bits: [..., norb] -> int64
    [..., n_elec] (stable argsort on 1-bit, as sqmc_tpu.dets)."""
    order = torch.argsort(1 - bits.to(torch.int32), dim=-1, stable=True)
    return order[..., :n_elec]


def _bit_words(W: int, orb: torch.Tensor) -> torch.Tensor:
    """[..., W] one-hot word mask of orbital `orb`."""
    orb = orb.to(torch.int64)
    bit = torch.ones_like(orb) << (orb % BITS_PER_WORD)
    if W == 1:
        return bit[..., None]
    widx = torch.arange(W, dtype=torch.int64, device=orb.device)
    on = (orb[..., None] // BITS_PER_WORD) == widx
    return torch.where(on, bit[..., None], torch.zeros_like(bit[..., None]))


def set_orb(words: torch.Tensor, orb: torch.Tensor) -> torch.Tensor:
    return words | _bit_words(words.shape[-1], orb)


def clear_orb(words: torch.Tensor, orb: torch.Tensor) -> torch.Tensor:
    return words & ~_bit_words(words.shape[-1], orb)


def get_orb(words: torch.Tensor, orb: torch.Tensor) -> torch.Tensor:
    """Test bit `orb` of words [..., W] -> bool[...]."""
    return ((words & _bit_words(words.shape[-1], orb)) != 0).any(dim=-1)


def _mask_lt(x: torch.Tensor) -> torch.Tensor:
    """int64 mask of bit positions < x, for x in [0, 64]."""
    xc = x.clamp(0, 63)
    m = ~(torch.full_like(xc, -1) << xc)
    return torch.where(x >= 64, torch.full_like(m, -1), m)


def count_below(words: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """Number of set bits at positions in [min(lo,hi), max(lo,hi)) of
    words [..., W] (window masks + popcount, per word)."""
    a = torch.minimum(lo, hi).to(torch.int64)
    b = torch.maximum(lo, hi).to(torch.int64)
    W = words.shape[-1]
    total = None
    for w in range(W):
        base = BITS_PER_WORD * w
        win = _mask_lt((b - base).clamp(0, 64)) ^ _mask_lt((a - base).clamp(0, 64))
        c = popcount64(words[..., w] & win)
        total = c if total is None else total + c
    return total.to(torch.int32)


def _low_bit_pos32(x: torch.Tensor) -> torch.Tensor:
    """Position of the lowest set bit of non-negative x < 2**32 (x != 0)."""
    return popcount64((x & (-x)) - 1)


def diff2_words(w_a: torch.Tensor, w_b: torch.Tensor):
    """Ascending positions of the (at most 2) set bits of a & ~b straight
    from the words, scanning 32-bit halves so no step can overflow.
    [..., W] x2 -> (pos0, pos1, count) int64; absent positions = 32767."""
    d = w_a & ~w_b
    W = d.shape[-1]
    big = torch.full(d.shape[:-1], 32767, dtype=torch.int64, device=d.device)
    p0, p1 = big, big.clone()
    nf = torch.zeros(d.shape[:-1], dtype=torch.int64, device=d.device)
    for w in range(W):
        for half in range(2):
            x = (d[..., w] >> (32 * half)) & _LO32
            for _ in range(2):
                have = x != 0
                q = _low_bit_pos32(x) + (64 * w + 32 * half)
                p0 = torch.where(have & (nf == 0), q, p0)
                p1 = torch.where(have & (nf == 1), q, p1)
                nf = nf + have.to(torch.int64)
                x = x & (x - 1).clamp(min=0)
    return p0, p1, nf


def double_sign_same_spin_words(wi, wj, p, q, r, s) -> torch.Tensor:
    """Fermion sign of a same-spin double {p,q}->{r,s}:
    (-1)^popcount(wi & wj & (M(p)^M(r)^M(q)^M(s))), M(b) = bits < b."""
    common = wi & wj
    n = None
    W = wi.shape[-1]
    for w in range(W):
        base = BITS_PER_WORD * w
        m = None
        for o in (p, r, q, s):
            mo = _mask_lt((o.to(torch.int64) - base).clamp(0, 64))
            m = mo if m is None else m ^ mo
        c = popcount64(common[..., w] & m)
        n = c if n is None else n + c
    return torch.where(n % 2 == 0, 1.0, -1.0).to(torch.float64)


def single_sign_words(wi: torch.Tensor, p, r) -> torch.Tensor:
    """Fermion sign of a single p->r (p occupied, r empty) from the source
    words: (-1)^(occupied strictly between p and r)."""
    n = count_below(wi, p, r) - (p < r).to(torch.int32)
    return torch.where(n % 2 == 0, 1.0, -1.0).to(torch.float64)


def single_excite_sign(bits: torch.Tensor, p: torch.Tensor,
                       r: torch.Tensor) -> torch.Tensor:
    """(-1)^(# occupied strictly between p and r) from dense bits."""
    pos = torch.arange(bits.shape[-1], device=bits.device)
    lo = torch.minimum(p, r).to(torch.int64)[..., None]
    hi = torch.maximum(p, r).to(torch.int64)[..., None]
    n = (bits.to(torch.int64) * ((pos > lo) & (pos < hi))).sum(dim=-1)
    return torch.where(n % 2 == 0, 1.0, -1.0).to(torch.float64)


def double_excite_sign_same_spin(bits_i, p, q, r, s) -> torch.Tensor:
    """Same-spin double {p,q}->{r,s} sign from dense source bits
    (ref: tools.f90 permutation_factor2:1342)."""
    pos = torch.arange(bits_i.shape[-1], device=bits_i.device)

    def maskr(b):
        return (pos < b.to(torch.int64)[..., None]).to(torch.int64)

    m = maskr(p) ^ maskr(r) ^ maskr(q) ^ maskr(s)
    common = bits_i.to(torch.int64)
    for o in (p, q, r, s):
        common = common * (pos != o.to(torch.int64)[..., None])
    n = (common * m).sum(dim=-1)
    return torch.where(n % 2 == 0, 1.0, -1.0).to(torch.float64)
