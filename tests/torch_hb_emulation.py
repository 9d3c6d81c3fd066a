"""numpy emulation of the arithmetic of the heat-bath selection that the
proposal kernel K3b runs (sqmc_tpu_torch/csrc/hbselect.cu), and the inputs
that test it.

The kernel adds every running sum in float32 as the sum before it plus
the next spin-orbital's value, in ascending spin-orbital order (empty
spin-orbitals add +0, so the kernel leaves them out), and every mu[a] as a
sequential float32 sum over the occupied q in ascending order.  That is
``np.cumsum(bits * x, axis=1, dtype=np.float32)`` (numpy accumulates in
order) and the loop of :func:`emulate_hb_select`.  Draws, cells, targets
and the p_pair quotients follow the plain version (ops/hbselect.py).

tests/test_torch_cuda.py holds K3b bit for bit to this emulation (through
tests/torch_spawn_emulation.py) on the card; tests/test_torch_spawn_ops.py
checks the emulation itself on the CPU (flat over empty spin-orbitals, a
target on a sum draws an occupied spin-orbital, integer R2 equal to the
plain version and the JAX package).
This module imports numpy only, so the card (no jax) can use it too.
"""

import numpy as np

F32 = np.float32
TINY = F32(1e-30)


def random_dets(rng, cap, norb, nel):
    """[cap, W] int64 words, nel random orbitals occupied per row; the
    first 7 rows empty and the next 7 the walk's empty-slot sentinel (-1:
    every bit set, as the walk hands the slots past the spawn total)."""
    W = (norb + 63) // 64
    occ = np.argsort(rng.random((cap, norb)), axis=1)[:, :nel]
    words = np.zeros((cap, W), np.uint64)
    for w in range(W):
        sh = np.clip(occ - 64 * w, 0, 63).astype(np.uint64)
        hit = (occ >= 64 * w) & (occ < 64 * (w + 1))
        words[:, w] = np.bitwise_or.reduce(
            np.where(hit, np.left_shift(np.uint64(1), sh), np.uint64(0)),
            axis=1)
    words[:7] = 0
    words[7:14] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return words.view(np.int64)


def np_bits(words, norb):
    """[cap, norb] float32 occupancy of int64 det words."""
    u = words.view(np.uint64)
    k = np.arange(norb)
    return ((u[:, k // 64] >> (k % 64).astype(np.uint64)) & np.uint64(1)
            ).astype(F32)


def emulate_rows(v):
    """Running sums of [cap, n2] float32 values as the kernel adds them:
    each the sum before it plus the next value, in order.  Returns (rows,
    totals)."""
    rows = np.cumsum(v.astype(F32), axis=1, dtype=F32)
    return rows, rows[:, -1].copy()


def emulate_mu(bits, R2):
    """mu[a] = sum over occupied q of R2[q, a], added in ascending q in
    float32 (empty q add +0)."""
    mu = np.zeros(bits.shape, F32)
    for q in range(bits.shape[1]):
        mu = mu + bits[:, q:q + 1] * R2[q][None, :]
    return mu


def emulate_hb_select(up, dn, norb, R2, u_rowsum, u_pick, u_entry):
    """The kernel's outputs ({name: array}, the fields of
    hbselect.Selection that are not None), each row set ({"s", "m", "1",
    "2"}: rows) and the [cap, 2 norb] occupancy."""
    bits = np.concatenate([np_bits(up, norb), np_bits(dn, norb)], axis=1)
    cap, n2 = bits.shape
    ar = np.arange(cap)

    def draw(rows, u, tot):
        t = (u * tot.astype(np.float64)).astype(F32)
        return np.minimum((rows <= t[:, None]).sum(axis=1), n2 - 1)

    def cell(rows, i):
        return np.where(i > 0, rows[ar, i] - rows[ar, np.maximum(i - 1, 0)],
                        rows[ar, i])

    out, rows = {}, {}
    if u_rowsum is not None:
        u2 = np.tile(u_rowsum.astype(F32), 2)
        rows["s"], out["utot"] = emulate_rows(bits * u2[None, :])
        out["o_s"] = draw(rows["s"], u_pick, out["utot"])
        out["c_s"] = cell(rows["s"], out["o_s"])
    rows["m"], m_tot = emulate_rows(bits * emulate_mu(bits, R2))
    o1 = draw(rows["m"], u_pick, m_tot)
    rows["1"], s1q = emulate_rows(R2[o1] * bits)
    o2 = draw(rows["1"], u_entry, s1q)
    rows["2"], s2q = emulate_rows(R2[o2] * bits)
    p = ((cell(rows["m"], o1) * cell(rows["1"], o2)) / np.maximum(s1q, TINY)
         + (cell(rows["m"], o2) * cell(rows["2"], o1)) / np.maximum(s2q, TINY)
         ) / np.maximum(m_tot, TINY)
    out.update(o1=o1, o2=o2, m_tot=m_tot, s1q=s1q, s2q=s2q, p_pair_q=p)
    return out, rows, bits


def _plateau(rng, rows, bits, tot):
    """u putting the target on the sum at a random occupied spin-orbital
    below the row's total (0.5 where there is none)."""
    ar = np.arange(len(tot))
    cand = (bits > 0) & (rows < tot[:, None])
    pick = np.where(cand, rng.random(bits.shape), -1.0).argmax(axis=1)
    return np.where(cand[ar, pick], rows[ar, pick].astype(np.float64)
                    / np.maximum(tot, 1e-30), 0.5)


def on_sum_inputs(norb, nup, ndn, singles, cap, seed):
    """Inputs whose targets lie exactly on the emulated running sums for
    half of the slots (u_pick on a sum of the mu row, u_entry on a sum of
    the R2[o1] row), with R2 spanning six decades, the diagonal 0.
    Returns (inputs, emulated outputs, rows, bits); inputs is (up, dn,
    norb, R2, u_rowsum, u_pick, u_entry) as numpy arrays."""
    n2 = 2 * norb
    rng = np.random.default_rng(seed)
    R2 = (10.0 ** rng.uniform(-6, 0, (n2, n2))).astype(F32)
    np.fill_diagonal(R2, 0.0)
    u_rowsum = 10.0 ** rng.uniform(-3, 0, norb) if singles else None
    up, dn = random_dets(rng, cap, norb, nup), random_dets(rng, cap, norb, ndn)
    u_pick, u_entry = rng.random(cap), rng.random(cap)
    half = rng.random(cap) < 0.5
    out, rows, bits = emulate_hb_select(up, dn, norb, R2, None, u_pick,
                                        u_entry)
    u_pick = np.where(half, _plateau(rng, rows["m"], bits, out["m_tot"]),
                      u_pick)
    out, rows, _ = emulate_hb_select(up, dn, norb, R2, None, u_pick, u_entry)
    u_entry = np.where(half, _plateau(rng, rows["1"], bits, out["s1q"]),
                       u_entry)
    inputs = (up, dn, norb, R2, u_rowsum, u_pick, u_entry)
    out, rows, bits = emulate_hb_select(*inputs)
    return inputs, out, rows, bits


def below(u, tot):
    """Slots whose target u * tot (rounded to float32) is below the total."""
    return (u * tot.astype(np.float64)).astype(F32) < tot


def compare(got, ref):
    """Raise unless `got` meets the criteria of two selections that
    associate their float32 sums differently against `ref` (dicts of numpy
    outputs, float R2): the draws agree on >= 99.99% of slots, and there the totals agree to 1e-5
    relative, the singles cell to 1e-6 of its row's total and p_pair_q to
    4e-6 + 3e-5 p.  Returns the share of slots whose draws agree."""
    same = (got["o1"] == ref["o1"]) & (got["o2"] == ref["o2"])
    if "o_s" in ref:
        same &= got["o_s"] == ref["o_s"]
    for k in ("m_tot", "s1q", "s2q", "utot"):
        if k in ref:
            a = np.asarray(got[k])[same].astype(np.float64)
            b = np.asarray(ref[k])[same].astype(np.float64)
            assert np.all(np.abs(a - b) <= 1e-5 * np.abs(b)), k
    p = np.asarray(got["p_pair_q"])[same].astype(np.float64)
    q = np.asarray(ref["p_pair_q"])[same].astype(np.float64)
    assert np.all(np.abs(p - q) <= 4e-6 + 3e-5 * np.abs(q))
    if "c_s" in ref:
        c = np.asarray(got["c_s"])[same].astype(np.float64)
        d = np.asarray(ref["c_s"])[same].astype(np.float64)
        assert np.all(np.abs(c - d)
                      <= 1e-6 * np.asarray(ref["utot"])[same])
    share = float(same.mean())
    assert share >= 0.9999, share
    return share
