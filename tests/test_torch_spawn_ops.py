"""The walk's two spawn ops of the port against the JAX package's own
arithmetic, on the CPU: the heat-bath selection (sqmc_tpu_torch/ops/
hbselect.py, plain PyTorch; on the card it runs inside the kernel K3b,
csrc/hbselect.cu) and the slot -> parent expand (ops/slotpar.py,
csrc/slotpar.cu).  On the CPU each op runs its plain version;
tests/test_torch_cuda.py holds the kernels to these, and K3b bit for bit
to the numpy emulation of its association (tests/torch_hb_emulation.py,
tests/torch_spawn_emulation.py), which the tests here check against the
plain version and the JAX package.

The JAX side is written out here from sqmc_tpu/algo/walk.py (the row
cumsums are sqmc_tpu.ops.prefix.cumsum_rows, the count and cell lines of
:1524, :1563-1633 and the singles draw of :1538-1540, :1812-1815,
:1866-1871; the expand of :1459-1467); nothing in sqmc_tpu changes.
Inputs come from numpy seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_hb_emulation as emu

from sqmc_tpu.algo.walk import TINY
from sqmc_tpu.ops import prefix
from sqmc_tpu_torch.ops import hbselect, slotpar

torch.set_num_threads(1)

CAP = 16384


def _dets(rng, cap, norb, nel):
    """[cap, W] int64 words with nel random orbitals occupied per row."""
    W = (norb + 63) // 64
    occ = np.argsort(rng.random((cap, norb)), axis=1)[:, :nel]
    words = np.zeros((cap, W), np.uint64)
    for w in range(W):
        sh = np.clip(occ - 64 * w, 0, 63).astype(np.uint64)
        hit = (occ >= 64 * w) & (occ < 64 * (w + 1))
        words[:, w] = np.bitwise_or.reduce(
            np.where(hit, np.left_shift(np.uint64(1), sh), np.uint64(0)),
            axis=1)
    return words.view(np.int64)


def _bits(words, norb):
    u = words.view(np.uint64)
    k = np.arange(norb)
    return ((u[:, k // 64] >> (k % 64).astype(np.uint64)) & np.uint64(1)
            ).astype(np.float32)


@jax.jit
def _jax_rows(bits2, R2, up_, ue):
    """The fast_heatbath selection of the JAX generation."""
    n2 = bits2.shape[1]
    iota2 = jnp.arange(n2, dtype=jnp.int32)[None, :]

    def sel_cell(rows, idx):
        prev = jnp.concatenate(
            [jnp.zeros((rows.shape[0], 1), rows.dtype), rows[:, :-1]],
            axis=1)
        return jnp.sum(jnp.where(iota2 == idx[:, None], rows - prev, 0.0),
                       axis=1)

    def draw(rows, targ):
        return jnp.minimum(
            jnp.sum(rows <= targ[:, None], axis=1).astype(jnp.int32), n2 - 1)

    mu = jnp.einsum("mo,oq->mq", bits2, R2)
    mu_rows = prefix.cumsum_rows(mu * bits2)
    m_tot = mu_rows[:, -1]
    o1 = draw(mu_rows, (up_ * m_tot).astype(jnp.float32))
    r1_rows = prefix.cumsum_rows(R2[o1] * bits2)
    s1q = r1_rows[:, -1]
    o2 = draw(r1_rows, (ue * s1q).astype(jnp.float32))
    r2_rows = prefix.cumsum_rows(R2[o2] * bits2)
    s2q = r2_rows[:, -1]
    p_pair_q = (sel_cell(mu_rows, o1) * sel_cell(r1_rows, o2)
                / jnp.maximum(s1q, TINY)
                + sel_cell(mu_rows, o2) * sel_cell(r2_rows, o1)
                / jnp.maximum(s2q, TINY)) / jnp.maximum(m_tot, TINY)
    return dict(o1=o1, o2=o2, m_tot=m_tot, s1q=s1q, s2q=s2q,
                p_pair_q=p_pair_q)


@jax.jit
def _jax_singles(bits2, u_rowsum, up_):
    n2 = bits2.shape[1]
    u2 = jnp.tile(u_rowsum.astype(jnp.float32), 2)
    sing_rows = prefix.cumsum_rows(bits2 * u2[None, :])
    utot = sing_rows[:, -1]
    o_s = jnp.minimum(jnp.sum(sing_rows <= (up_ * utot).astype(
        jnp.float32)[:, None], axis=1).astype(jnp.int32), n2 - 1)
    prev = jnp.concatenate([jnp.zeros((sing_rows.shape[0], 1),
                                      sing_rows.dtype), sing_rows[:, :-1]],
                           axis=1)
    hit = jnp.arange(n2, dtype=jnp.int32)[None, :] == o_s[:, None]
    c_s = jnp.sum(jnp.where(hit, sing_rows - prev, 0.0), axis=1)
    return dict(o_s=o_s, utot=utot, c_s=c_s)


def _both(words_up, words_dn, norb, R2, u_rowsum, seed):
    """(port plain, JAX) outputs as numpy dicts for one input."""
    rng = np.random.default_rng(seed)
    up_, ue = rng.random(CAP), rng.random(CAP)
    bits2 = np.concatenate([_bits(words_up, norb), _bits(words_dn, norb)],
                           axis=1)
    sel = hbselect.hb_select_plain(torch.as_tensor(words_up),
                                   torch.as_tensor(words_dn), norb,
                                   torch.as_tensor(R2),
                                   None if u_rowsum is None
                                   else torch.as_tensor(u_rowsum),
                                   torch.as_tensor(up_), torch.as_tensor(ue))
    port = {k: v.numpy() for k, v in sel._asdict().items() if v is not None}
    ref = {k: np.asarray(v) for k, v in _jax_rows(
        jnp.asarray(bits2), jnp.asarray(R2), jnp.asarray(up_),
        jnp.asarray(ue)).items()}
    if u_rowsum is not None:
        ref.update({k: np.asarray(v) for k, v in _jax_singles(
            jnp.asarray(bits2), jnp.asarray(u_rowsum),
            jnp.asarray(up_)).items()})
    assert set(port) == set(ref)
    return port, ref


def _input(norb, nup, ndn, seed):
    rng = np.random.default_rng(seed)
    up, dn = _dets(rng, CAP, norb, nup), _dets(rng, CAP, norb, ndn)
    up[:7], dn[:7] = 0, 0          # slots past the spawn total: no electrons
    return rng, up, dn


@pytest.mark.parametrize("singles", [False, True], ids=["doubles", "singles"])
@pytest.mark.parametrize("norb,nup,ndn", [(19, 7, 7), (70, 6, 5)],
                         ids=["norb19", "norb70_two_words"])
def test_hb_select_integer_r2_matches_jax_bitwise(norb, nup, ndn, singles):
    """Integer-valued R2 and u_rowsum keep every running sum exact (all
    below 2^24), so the draws, totals, cells and probabilities of the two
    packages are the same bits whatever the summation order."""
    rng, up, dn = _input(norb, nup, ndn, norb)
    n2 = 2 * norb
    R2 = rng.integers(0, 16, (n2, n2)).astype(np.float32)
    np.fill_diagonal(R2, 0.0)
    u_rowsum = rng.integers(1, 9, norb).astype(np.float64) if singles else None
    port, ref = _both(up, dn, norb, R2, u_rowsum, seed=norb + 1)
    for k in ref:
        a, b = port[k], ref[k]
        if a.dtype.kind == "f":
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), k
        else:
            assert np.array_equal(a, b.astype(np.int64)), k
    if norb > 64:
        assert (up.view(np.uint64)[:, 0] >> np.uint64(63)).any()
    assert (port["m_tot"][:7] == 0).all() and (port["m_tot"][7:] > 0).all()


@functools.lru_cache(maxsize=1)
def _heg14_r2():
    """R2 of HEG-14's walk tables (it does not depend on the trial)."""
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, build_walk_tables
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    s = make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=5e-2, n_psi_t=5, n_imp=5)
    cfg = WalkConfig(mwalk=1024, cap_spawn=1024, norb=s.norb, nup=7, ndn=7,
                     n_words=1, tau=2e-3, w_abs_target=1e3, has_singles=False)
    return build_walk_tables(s, trial, cfg).R2.numpy()


@pytest.mark.parametrize("singles", [False, True], ids=["doubles", "singles"])
def test_hb_select_heg14_r2_matches_jax(singles):
    """HEG-14's walk-table R2 (float rowsums): the packages sum in other
    orders (sequential torch.cumsum against the triangular matmul), so a
    draw can differ where its target lies within an ulp of a cell edge.
    The draws agree on >= 99.99% of slots; there the row totals agree to
    1e-5 relative, the singles cell to 1e-6 of its row's total, and
    p_pair_q to 4e-6 + 3e-5 p, the bound that follows from each of its
    four cells agreeing to 1e-6 of its row's total and the totals to
    1e-5."""
    R2 = _heg14_r2()
    assert R2.shape == (38, 38) and R2.max() > 0
    rng, up, dn = _input(19, 7, 7, 3)
    u_rowsum = rng.random(19) * 2.0 if singles else None
    port, ref = _both(up, dn, 19, R2, u_rowsum, seed=4)
    same = (port["o1"] == ref["o1"]) & (port["o2"] == ref["o2"])
    if singles:
        same &= port["o_s"] == ref["o_s"]
    assert same.mean() >= 0.9999, same.mean()
    for k in ("m_tot", "s1q", "s2q") + (("utot",) if singles else ()):
        a, b = port[k][same].astype(np.float64), ref[k][same].astype(np.float64)
        assert np.all(np.abs(a - b) <= 1e-5 * np.abs(b)), k
    p, q = port["p_pair_q"][same].astype(np.float64), ref["p_pair_q"][same]
    assert np.all(np.abs(p - q) <= 4e-6 + 3e-5 * np.abs(q))
    if singles:
        c, d = port["c_s"][same], ref["c_s"][same]
        assert np.all(np.abs(c.astype(np.float64) - d)
                      <= 1e-6 * ref["utot"][same])


# ---------------------------------------------------------------------------
# The numpy emulation of the selection's arithmetic
# (tests/torch_hb_emulation.py), which tests/test_torch_cuda.py holds K3b
# to bit for bit (through tests/torch_spawn_emulation.py)
# ---------------------------------------------------------------------------

EMU_SHAPES = [(19, 7, 7, False), (26, 4, 4, True), (70, 6, 5, True)]
EMU_IDS = ["norb19", "norb26_singles", "norb70_two_words"]


@pytest.mark.parametrize("norb,nup,ndn,singles", EMU_SHAPES, ids=EMU_IDS)
def test_emulated_rows_are_flat_over_empty_spin_orbitals(norb, nup, ndn,
                                                         singles):
    """The emulated running sums never decrease and repeat exactly across
    every empty spin-orbital (float R2 spanning six decades), so an empty
    spin-orbital's cell is exactly 0; the dead slots' rows are all 0."""
    _, out, rows, bits = emu.on_sum_inputs(norb, nup, ndn, singles, 4096,
                                           seed=2 * norb)
    assert set(rows) == ({"s", "m", "1", "2"} if singles else {"m", "1", "2"})
    for key, r in rows.items():
        d = np.diff(r, axis=1)
        assert (d >= 0).all(), key
        assert (d[bits[:, 1:] == 0] == 0).all(), key
        assert (r[bits[:, 0] == 0, 0] == 0).all(), key
        assert (r[:7] == 0).all(), key
    assert (out["m_tot"][7:] > 0).all()


@pytest.mark.parametrize("norb,nup,ndn,singles", EMU_SHAPES, ids=EMU_IDS)
def test_emulated_target_on_a_sum_draws_an_occupied_spin_orbital(
        norb, nup, ndn, singles):
    """Half of the targets lie exactly on an emulated running sum: every
    draw whose target is below its row's total lands on an occupied
    spin-orbital, those on a sum included (the draw counts the sums <= the
    target, so it lands on the next occupied spin-orbital), and the cell it
    reports is that spin-orbital's value (> 0)."""
    inputs, out, rows, bits = emu.on_sum_inputs(norb, nup, ndn, singles,
                                                4096, seed=2 * norb)
    _, _, _, _, _, u_pick, u_entry = inputs
    ar = np.arange(len(u_pick))
    on1 = emu.below(u_pick, out["m_tot"])
    checks = [("o1", "m", on1),
              ("o2", "1", on1 & emu.below(u_entry, out["s1q"]))]
    if singles:
        checks.append(("o_s", "s", emu.below(u_pick, out["utot"])))
    for key, row, on in checks:
        assert on.mean() > 0.99, key
        o = out[key]
        assert (bits[ar, o][on] == 1).all(), key
        r = rows[row]
        cell = np.where(o > 0, r[ar, o] - r[ar, np.maximum(o - 1, 0)],
                        r[ar, o])
        assert (cell[on] > 0).all(), key
    # the targets placed on a sum: the drawn row value at the draw is
    # above the target, the one before it equal to it
    t = (u_pick * out["m_tot"].astype(np.float64)).astype(np.float32)
    r, o = rows["m"], out["o1"]
    placed = on1 & (o > 0) & (r[ar, np.maximum(o - 1, 0)] == t)
    assert placed.mean() > 0.3
    assert (r[ar, o][placed] > t[placed]).all()


@pytest.mark.parametrize("singles", [False, True], ids=["doubles", "singles"])
@pytest.mark.parametrize("norb,nup,ndn", [(19, 7, 7), (70, 6, 5)],
                         ids=["norb19", "norb70_two_words"])
def test_emulation_integer_r2_matches_plain_and_jax_bitwise(norb, nup, ndn,
                                                            singles):
    """With integer R2 and u_rowsum every sum is exact, so the emulation
    of the kernel's order, hb_select_plain and the JAX package's selection
    give the same bits in every output."""
    rng, up, dn = _input(norb, nup, ndn, norb)
    n2 = 2 * norb
    R2 = rng.integers(0, 16, (n2, n2)).astype(np.float32)
    np.fill_diagonal(R2, 0.0)
    u_rowsum = rng.integers(1, 9, norb).astype(np.float64) if singles else None
    port, ref = _both(up, dn, norb, R2, u_rowsum, seed=norb + 1)
    u = np.random.default_rng(norb + 1)
    up_, ue = u.random(CAP), u.random(CAP)
    got, _, _ = emu.emulate_hb_select(up, dn, norb, R2, u_rowsum, up_, ue)
    assert set(got) == set(ref)
    for k in ref:
        for other in (port[k], ref[k]):
            a, b = got[k], other
            if a.dtype.kind == "f":
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), k
            else:
                assert np.array_equal(a, b.astype(np.int64)), k


@pytest.mark.parametrize("singles", [False, True], ids=["doubles", "singles"])
def test_emulation_heg14_r2_agrees_with_plain_and_jax(singles):
    """HEG-14's float R2: the emulation's association (sequential adds,
    mu over the occupied q) against hb_select_plain (torch.cumsum, mu by
    a matmul) and the JAX package (triangular matmuls): the draws agree on
    >= 99.99% of slots and, there, the totals, cells and p_pair_q within
    the tolerances of torch_hb_emulation.compare."""
    R2 = _heg14_r2()
    rng, up, dn = _input(19, 7, 7, 3)
    u_rowsum = rng.random(19) * 2.0 if singles else None
    port, ref = _both(up, dn, 19, R2, u_rowsum, seed=4)
    u = np.random.default_rng(4)
    up_, ue = u.random(CAP), u.random(CAP)
    got, _, _ = emu.emulate_hb_select(up, dn, 19, R2, u_rowsum, up_, ue)
    assert emu.compare(got, port) >= 0.9999
    assert emu.compare(got, ref) >= 0.9999


def _jax_expand(nchild, cap):
    nchild = jnp.asarray(nchild, jnp.int32)
    M = nchild.shape[0]
    cum_child = prefix.cumsum_i32(nchild)
    off_child = cum_child - nchild
    seed_par = jnp.full(cap, -1, jnp.int32).at[
        jnp.clip(off_child, 0, cap - 1)].max(
        jnp.arange(M, dtype=jnp.int32), mode="drop",
        indices_are_sorted=True)
    return np.asarray(jnp.clip(jax.lax.cummax(seed_par), 0, M - 1))


def _nchild(case, rng, M, cap):
    if case == "one_walker":
        return np.array([5])
    n = rng.poisson(3.0, M) * (rng.random(M) < 0.5)
    n[100:400] = 0                            # a long run of no children
    n[50] = 700                               # one walker owns many slots
    n[-300:] = 0                              # dead walkers at the end
    if case == "none":
        return np.zeros(M, np.int64)
    goal = {"below": cap // 3, "at": cap, "above": 2 * cap}[case]
    cum = np.cumsum(n)
    assert cum[-1] >= goal
    i = int(np.searchsorted(cum, goal))
    n[i] -= cum[i] - goal
    n[i + 1:] = 0
    return n


@pytest.mark.parametrize("case", ["below", "at", "above", "none",
                                  "one_walker"])
def test_slot_parents_matches_jax_bitwise(case):
    """slot_parents against the JAX package's scatter-max + cummax + clip
    on every slot: spawn totals below, at and above CAP (the clip puts
    every walker whose first slot is at or past the last slot on it, so
    that slot holds walker M - 1 even at a total of exactly CAP), no
    spawns, one walker."""
    rng = np.random.default_rng(11)
    M, cap = 6000, 4096
    nchild = _nchild(case, rng, M, cap)
    if case == "one_walker":
        cap = 8
    cum = torch.cumsum(torch.as_tensor(nchild, dtype=torch.int64), 0)
    b = slotpar.slot_parents(cum, cap).numpy()
    ref = _jax_expand(nchild, cap)
    assert b.dtype == np.int64 and b.shape == (cap,)
    assert np.array_equal(b, ref.astype(np.int64))
    # below the last slot every spawn slot holds its owner; the last slot
    # holds walker M - 1 whenever the spawns reach it (the clip)
    owner = np.repeat(np.arange(len(nchild)), nchild)
    k = min(len(owner), cap - 1)
    assert np.array_equal(b[:k], owner[:k])
    assert b[-1] == len(nchild) - 1


def test_spawn_ops_raise_on_other_devices():
    """Only CPU tensors take the plain version: a tensor on any device
    other than the CPU or a card is refused (the heat-bath proposal's
    refusal is test_torch_hbspawn.py's)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        slotpar.slot_parents(torch.zeros(4, dtype=torch.int64, device=meta), 8)


def test_spawn_kernel_sources_have_no_atomics():
    """Every output of K3b (the heat-bath proposal, hbselect.cu) and K4
    has one writer: their sources use no atomic operation, so two runs
    give the same bits."""
    import pathlib

    from sqmc_tpu_torch.ops import hbspawn
    csrc = pathlib.Path(slotpar.__file__).resolve().parent.parent / "csrc"
    assert hbspawn._SOURCE == "hbselect.cu"
    assert "sqmc_hb_spawn(" in (csrc / "hbselect.cu").read_text()
    for name in ("hbselect.cu", "slotpar.cu"):
        assert "atomic" not in (csrc / name).read_text().lower(), name


# ---------------------------------------------------------------------------
# The rows of the uniform / Cauchy-Schwarz proposals (ops/hbselect.py
# flat_cumsum) and the singles guard of the port's _propose
# ---------------------------------------------------------------------------

def _zero_run_weights(rng, B, n, dtype, decades=6):
    """[B, n] non-negative weights spanning `decades` decades, with zero
    runs at the start, in the middle and at the end of every row,
    scattered zeros and one row of zeros only."""
    w = 10.0 ** rng.uniform(-decades / 2, decades / 2, (B, n))
    w[rng.random((B, n)) < 0.3] = 0.0
    w[:, :3] = 0.0
    w[:, n // 2:n // 2 + 5] = 0.0
    w[:, -4:] = 0.0
    w[0] = 0.0
    return torch.as_tensor(w.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_flat_cumsum_is_torch_cumsum_bitwise_on_cpu(dtype):
    """On the CPU torch.cumsum adds in order, so it is already flat over
    zero weights: flat_cumsum returns its bits, and every CPU parity test
    of the walk against the JAX package keeps its numbers."""
    w = _zero_run_weights(np.random.default_rng(31), 4096, 52, dtype)
    got, ref = hbselect.flat_cumsum(w), torch.cumsum(w, dim=1)
    iview = torch.int32 if dtype == np.float32 else torch.int64
    assert torch.equal(got.view(iview), ref.view(iview))


def _tree_cumsum(v):
    """Running sums in float32 associated as a parallel scan does
    (Hillis-Steele: log2 n rounds, each adding the value d places back)."""
    x = v.astype(np.float32)
    d = 1
    while d < x.shape[1]:
        x = np.concatenate([x[:, :d], x[:, d:] + x[:, :-d]], axis=1)
        d *= 2
    return x


def test_flat_rows_make_tree_sums_flat_over_zero_weights():
    """Tree-associated running sums leave nonzero (ulp-wide) cells at zero
    weights; flat_rows gives every zero weight a cell of exactly 0 and
    keeps the sums at the positive weights.  With weights over two decades
    (the synthetic C2 file's nonzero u_rowsum spans 1.6-4.4) each positive
    weight exceeds the sums' rounding, so the rows never decrease."""
    w = _zero_run_weights(np.random.default_rng(32), 4096, 52, np.float32,
                          decades=2)
    tree = _tree_cumsum(w.numpy())
    zero = w.numpy() == 0

    def cells(r):
        return np.diff(r, axis=1, prepend=np.zeros((r.shape[0], 1), r.dtype))

    assert (cells(tree)[zero] != 0).sum() > 100        # the hazard is real
    flat = hbselect.flat_rows(torch.as_tensor(tree), w).numpy()
    assert (cells(flat)[zero] == 0).all()
    assert np.array_equal(flat[~zero], tree[~zero])
    assert (cells(flat) >= 0).all()


@functools.lru_cache(maxsize=1)
def _c2_cs_tables():
    """The synthetic C2-shaped system (26 orbitals, 4 + 4) and its walk
    tables with the Cauchy-Schwarz proposal and singles."""
    import tempfile
    from sqmc_tpu_torch.algo.walk import WalkConfig, build_walk_tables
    from sqmc_tpu_torch.parallel.dryrun import small_c2
    from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/FCIDUMP"
        write_c2_fcidump(path)
        s, trial = small_c2(path, "cpu")
    cfg = WalkConfig(mwalk=1024, cap_spawn=64, norb=s.norb, nup=s.nup,
                     ndn=s.ndn, n_words=s.n_words, tau=1e-3, w_abs_target=1e3,
                     has_singles=True, proposal="cauchy_schwarz")
    return s, cfg, build_walk_tables(s, trial, cfg)


def test_singles_guard_rejects_a_draw_past_the_last_occupied_orbital():
    """A singles target that rounds up to its row's total (u_pick * utot
    -> utot in float32) draws the capped last spin-orbital; on a det whose
    last dn orbital is empty that spin-orbital is unoccupied and its cell
    is 0.  The child the proposal writes there would carry 9 electrons;
    the port's sng_ok (a realized cell > 0 and an occupied p_s) rejects
    it, where the JAX package's check (an empty r_s, U[p_s, r_s] > 0)
    would not.  Ordinary draws on the same dets are kept."""
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.algo.walk import _propose
    s, cfg, tables = _c2_cs_tables()
    n = 64
    up = torch.as_tensor(np.repeat(s.hf_up[None, :], n, 0))
    dn = torch.as_tensor(np.repeat(s.hf_dn[None, :], n, 0))
    assert not bool(dets.get_orb(dn, torch.full((n,), 25)).any())
    rng = np.random.default_rng(33)
    u_pick = rng.random(n)
    u_pick[::2] = 1.0 - 1e-9                       # rounds up to utot
    streams = tuple(torch.as_tensor(x) for x in (
        np.zeros(n), u_pick, rng.random(n), rng.random(n), rng.random(n)))
    gen = torch.Generator().manual_seed(0)
    tau = torch.tensor(1e-3, dtype=torch.float64)
    sp_up, sp_dn, factor, ok = _propose(cfg, tables, up, dn, tau,
                                        torch.float32, streams, gen)
    nel = (dets.to_bits(sp_up, 26).sum(1) + dets.to_bits(sp_dn, 26).sum(1))
    forced = torch.arange(n) % 2 == 0
    # the child sets an empty r_s and clears nothing: 9 electrons, with
    # U[25, r_s] > 0, so the JAX package's check would accept it
    bad = forced & (nel == 9)
    assert int(bad.sum()) >= 8
    r_s = dets.to_bits(sp_dn[bad] & ~dn[bad], 26).argmax(1)
    assert bool((tables.u_table[25, r_s] > 0).all())
    assert not bool(ok[forced].any())
    assert bool((nel[~forced] == 8).all()) and bool(ok[~forced].any())
