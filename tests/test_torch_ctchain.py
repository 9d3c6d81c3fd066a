"""The CT chain of the exponential projector (sqmc_tpu_torch/ops/ctchain.py)
on the CPU: its plain version against the upstream's loop written out slot
by slot (tests/torch_ctchain_cases.py: K7's specification) and against the
JAX package's _ct_chain (sqmc_tpu/algo/walk.py:1089) on the same uniforms,
and the chain as algo/walk.py runs it now (every move's uniforms drawn
first into one buffer) against the loop it ran before, bit for bit from
one seed, in the three CT modes.  The kernel (csrc/ctchain.cu) is held to
the plain version on the card by tests/test_torch_cuda.py."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_ctchain_cases as cases

from sqmc_tpu_torch import dets
from sqmc_tpu_torch.algo import walk as TW
from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
from sqmc_tpu_torch.ops import ctchain
from sqmc_tpu_torch.ops.hbspawn import in_window, parity_sign
from sqmc_tpu_torch.systems.chem import slater

torch.set_num_threads(1)

F64, I32, I64 = torch.float64, torch.int32, torch.int64


@pytest.mark.parametrize("name", cases.CASES)
def test_ct_chain_plain_is_the_upstream_loop(name):
    """chain_plain with the hubbardk move against the slot-by-slot loop:
    the words, flags, jumps and cut chains equal, the factor within 1e-12
    of its size (the diagonal's sums and the libm's last bits differ).
    Each case has undrawn slots, chains that cross tau, proposals that
    die on an occupied s and first times that wrap; the *_cut cases have
    chains cut at their small n_moves."""
    c = cases.make_case(name)
    up, dn, f, ok, n_jumps, n_cut = cases.plain(c)
    ref = cases.scalar_chain(c)
    assert np.array_equal(up.numpy(), ref["up"])
    assert np.array_equal(dn.numpy(), ref["dn"])
    assert np.array_equal(ok.numpy(), ref["ok"])
    assert float(n_jumps) == ref["n_jumps"] and float(n_cut) == ref["n_cut"]
    assert n_jumps.dtype == n_cut.dtype == F64 and n_jumps.shape == ()
    assert np.allclose(f.numpy(), ref["f"], rtol=1e-12, atol=0.0)
    assert np.array_equal(f.numpy() != 0, ref["f"] != 0)
    ends = {e: int((ref["end"] == e).sum()) for e in
            ("undrawn", "cross", "dead", "cut")}
    assert ends["undrawn"] and ends["cross"] and ends["dead"], ends
    assert ref["wrapped"].any()
    if name.endswith("_cut"):
        assert ends["cut"] > 0, ends
    # an undrawn slot keeps its parent's words, factor 0 and flag false
    und = ~c["slot_valid"]
    assert torch.equal(up[und], c["up_w"][und])
    assert not bool(ok[und].any()) and bool((f[und] == 0).all())


HUBBARDK_CASES = tuple(n for n in cases.CASES if n.startswith("hubk"))


@pytest.mark.parametrize("name", HUBBARDK_CASES)
def test_ct_chain_plain_is_the_jax_chain(name, monkeypatch):
    """chain_plain with the hubbardk move against the JAX package's
    _ct_chain on the same inputs: the JAX system's own tables (its kmap3
    and rate equal the port's), the parents, drawn slots, tau and E_T of
    the case, and its move i drawing the case's u[i] (jax.random's
    fold_in and uniform stand in for the buffer).  Words and flags
    equal, the factor within 1e-12 of its size."""
    import jax
    import jax.numpy as jnp

    from sqmc_tpu.algo import walk as JW
    from sqmc_tpu.algo.semistoch import build_trial_wavefunction as jax_trial
    from sqmc_tpu.systems.hubbard.system import make_hubbard_k_system
    c = cases.make_case(name)
    (lx, ly), nup, ndn = cases._SPECS[name][:3]
    n_moves, _, S = c["u"].shape
    s = make_hubbard_k_system(lx, ly, 1.0, 4.0, nup, ndn)
    cfg = JW.WalkConfig(mwalk=8, cap_spawn=8, norb=s.norb, nup=nup, ndn=ndn,
                        n_words=1, tau=float(c["tau"]), w_abs_target=1.0,
                        has_singles=False, semistochastic=False,
                        use_exponential_projector=True, ct_max_jumps=n_moves)
    trial = jax_trial(s, eps_var=1.0, n_psi_t=1, n_imp=1)
    tables = JW.build_walk_tables(s, trial, cfg=cfg)
    assert np.array_equal(np.asarray(tables.kmap3), c["kmap3"].numpy())
    assert float(tables.ct_rate) == float(c["rate"])
    u = c["u"].numpy()
    monkeypatch.setattr(jax.random, "fold_in", lambda key, i: i)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda i, shape: jnp.asarray(u[i].reshape(shape)))
    words = lambda w: jnp.asarray(w.numpy().view(np.uint64))  # noqa: E731
    state = SimpleNamespace(up=words(c["up_w"]), dn=words(c["dn_w"]))
    cu, cd, f, ok = JW._ct_chain(
        cfg, tables, state, jnp.arange(S), jnp.asarray(c["slot_valid"].numpy()),
        None, jnp.asarray(float(c["tau"])), jnp.asarray(float(c["e_trial"])))
    up, dn, f_t, ok_t, _, _ = cases.plain(c)
    assert np.array_equal(np.asarray(cu).view(np.int64), up.numpy())
    assert np.array_equal(np.asarray(cd).view(np.int64), dn.numpy())
    assert np.array_equal(np.asarray(ok), ok_t.numpy())
    f = np.asarray(f)
    assert f.dtype == np.float64 and np.array_equal(f != 0, f_t.numpy() != 0)
    assert np.allclose(f_t.numpy(), f, rtol=1e-12, atol=0.0)
    assert ok.any() and (~np.asarray(ok) & c["slot_valid"].numpy()).any()


def test_ct_chain_dispatch_on_the_cpu():
    """chain() on CPU tensors is chain_plain with the hubbardk move, bit for
    bit, and launches nothing; a device with no path raises."""
    c = cases.make_case("hubk2x4")
    before = ctchain.launches
    got = ctchain.chain(c["u"], c["up_w"], c["dn_w"], c["slot_valid"],
                        c["table"], c["kmap3"], c["rate"], c["tau"],
                        c["e_trial"], c["norb"], c["nup"], c["ndn"])
    for a, b in zip(got, cases.plain(c)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ctchain.launches == before
    meta = c["up_w"].to("meta")
    with pytest.raises(ValueError):
        ctchain.chain(c["u"], meta, meta, c["slot_valid"], c["table"],
                      c["kmap3"], c["rate"], c["tau"], c["e_trial"],
                      c["norb"], c["nup"], c["ndn"])


def test_draw_uniforms_is_the_stream_of_draws_in_turn():
    """The buffer's rows are what n_moves calls of torch.rand((6, S)) draw
    from the same generator, and leave it in the same state."""
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    u = ctchain.draw_uniforms(g1, 4, 1001, "cpu")
    assert u.shape == (4, 6, 1001) and u.dtype == F64
    for i in range(4):
        assert torch.equal(u[i], torch.rand((6, 1001), dtype=F64,
                                            generator=g2))
    assert torch.equal(g1.get_state(), g2.get_state())


# ---------------------------------------------------------------------------
# the chain as the parent ran it: each move's uniforms drawn inside the loop
# ---------------------------------------------------------------------------

def _old_ct_chain(cfg, tables, up_w, dn_w, slot_valid, gen, tau, e_trial):
    """algo/walk.py's _ct_chain before the uniforms moved into one buffer
    and the hubbardk move into ops/ctchain.py, unchanged."""
    S = up_w.shape[0]
    dev = up_w.device
    norb, nup, ndn = cfg.norb, cfg.nup, cfg.ndn
    rate = tables.ct_rate
    cu, cd = up_w, dn_w
    one = torch.ones((), dtype=F64, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)
    f = torch.where(slot_valid, one, zero)
    t = torch.zeros(S, dtype=F64, device=dev)
    done = ~slot_valid
    n_jumps = torch.zeros(S, dtype=I32, device=dev)
    sl = torch.arange(S, device=dev)
    for i in range(cfg.ct_max_jumps):
        u6 = torch.rand((6, S), dtype=F64, device=dev, generator=gen)
        t_inc = -torch.log(u6[0].clamp(min=TW.TINY)) / rate
        if i == 0:
            t_inc = torch.remainder(t_inc, tau)
        t_new = t + t_inc
        cross = t_new > tau
        bits_cu = dets.to_bits(cu, norb)
        bits_cd = dets.to_bits(cd, norb)
        diag_cur = slater.diag_elements(tables.table, bits_cu, bits_cd)
        seg = torch.where(cross, tau - t, t_inc)
        seg_f = torch.exp(seg * (e_trial - diag_cur + rate))
        if cfg.ct_mode == "hubbardk":
            occ_u = dets.occ_orbitals(bits_cu, nup)
            occ_d = dets.occ_orbitals(bits_cd, ndn)
            unocc_u = dets.occ_orbitals(1 - bits_cu, norb - nup)
            p = occ_u[sl, (u6[1] * nup).to(I64).clamp(max=nup - 1)]
            q = occ_d[sl, (u6[2] * ndn).to(I64).clamp(max=ndn - 1)]
            r = unocc_u[sl, (u6[3] * (norb - nup)).to(I64).clamp(
                max=norb - nup - 1)]
            s_ = tables.kmap3[(p * norb + q) * norb + r]
            s_occ = dets.get_orb(cd, s_)
            cu_cnt = dets.count_below(cu, p, r) - in_window(p, p, r)
            cd_cnt = dets.count_below(cd, q, s_) - in_window(q, q, s_)
            jump_f = torch.where(s_occ, zero, -parity_sign(cu_cnt + cd_cnt))
            nxt_up = dets.set_orb(dets.clear_orb(cu, p), r)
            nxt_dn = dets.set_orb(dets.clear_orb(cd, q), s_)
        else:
            jump_f, nxt_up, nxt_dn = TW._ct_jump_move(
                cfg, tables, cu, cd, bits_cu, bits_cd, u6, sl)
        act = ~done
        dead = jump_f == 0.0
        f = torch.where(act, f * seg_f * torch.where(cross, one, jump_f), f)
        jumped = act & ~cross & ~dead
        n_jumps += jumped
        cu = torch.where(jumped[:, None], nxt_up, cu)
        cd = torch.where(jumped[:, None], nxt_dn, cd)
        t = torch.where(act, t_new, t)
        done = done | (act & (cross | dead))
    f = torch.where(done, f, zero)
    return (cu, cd, f, slot_valid & (f != 0.0), n_jumps.sum(dtype=F64),
            (~done).sum(dtype=F64))


def _ct_walk_tables(mode):
    """(cfg, tables) of tests/test_torch_walk_ct.py's CT systems."""
    from sqmc_tpu_torch.systems.base import make_system_from_arrays
    from sqmc_tpu_torch.systems.chem.integrals import n_eri
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system
    if mode == "hubbardk":
        s, tau = make_hubbard_k_system(2, 4, 1.0, 4.0, 3, 3, device="cpu"), 0.05
    elif mode == "heg":
        s, tau = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu"), 0.02
    else:
        rng = np.random.default_rng(3)
        h = rng.normal(size=(5, 5)) * 0.3
        h = 0.5 * (h + h.T) + np.diag(np.arange(5) * 1.0)
        eri = rng.normal(size=n_eri(5)) * 0.1
        s = make_system_from_arrays(h, eri, 0.0, 2, 2, name="toy",
                                    device="cpu")
        tau = 0.05
    trial = build_trial_wavefunction(s, eps_var=1e-4, n_psi_t=20, n_imp=1)
    cfg = TW.WalkConfig(mwalk=1024, cap_spawn=2048, norb=s.norb, nup=s.nup,
                        ndn=s.ndn, n_words=1, tau=tau, w_abs_target=1000.0,
                        has_singles=s.has_singles, semistochastic=False,
                        use_exponential_projector=True, ct_mode=mode)
    return cfg, TW.build_walk_tables(s, trial, cfg), trial


@pytest.mark.parametrize("mode", ["hubbardk", "heg", "generic"])
def test_ct_chain_is_the_parents_chain_bit_for_bit(mode):
    """walk._ct_chain (uniforms drawn first; hubbardk through
    ops/ctchain.py) against the loop it replaced, from one seed: the
    words, factors, flags, both counters and the generator's state after
    it equal bit for bit."""
    cfg, tables, trial = _ct_walk_tables(mode)
    rng = np.random.default_rng(4)
    S = 2500
    up = torch.as_tensor(cases.random_words(rng, S, cfg.norb, cfg.nup))
    dn = torch.as_tensor(cases.random_words(rng, S, cfg.norb, cfg.ndn))
    valid = torch.as_tensor(rng.random(S) < 0.6)
    tau = torch.tensor(cfg.tau, dtype=F64)
    e_t = torch.tensor(float(trial.e_trial), dtype=F64)
    g_old = torch.Generator().manual_seed(9)
    g_new = torch.Generator().manual_seed(9)
    old = _old_ct_chain(cfg, tables, up, dn, valid, g_old, tau, e_t)
    new = TW._ct_chain(cfg, tables, up, dn, valid, g_new, tau, e_t)
    for a, b in zip(old, new):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert torch.equal(g_old.get_state(), g_new.get_state())
    assert float(new[4]) > 0 and bool(new[3].any())
