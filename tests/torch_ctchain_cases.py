"""Inputs of the CT-chain tests (sqmc_tpu_torch/ops/ctchain.py), shared by
the CPU tests and the card tests; torch, numpy and the port only.

A case is a dict of the chain's inputs on the CPU: the uniform buffer u
[n_moves, 6, S] (ctchain.draw_uniforms from a seeded generator), the
parents' words, slot_valid, the IntegralTable, kmap3, rate, tau and E_T
(0-d float64), norb, nup and ndn.  The Hubbard-k cases take their
kmap3 and rate from algo/walk.py's _ct_tables on 2x2, 2x4 and 4x4
clusters; ``wide48`` (one word a spin, most of it used) and
``two_word72`` (two words a spin) use synthetic tables: a symmetric
direct table whose diagonal the exchange table shares, and a kmap3 of
random orbitals.  Slots are drawn at random
(undrawn ones keep random words or the walk's empty-slot sentinel, -1),
and tau rate is large enough that first moves wrap (the first time is
past tau before the remainder), proposals die on an occupied s, and, in
the ``*_cut`` cases, chains run past a small n_moves.  ``cell`` is
hubbardk4x4.walk-ct's shape: 262,144 slots, the first 40% drawn, 12
moves, tau 5e-3.

``scalar_chain`` is the upstream's move_uniform_exponential_projector
loop (do_walk.f90:3803, deterministic-diagonal variant) written out slot
by slot on Python integers and floats: K7's specification."""

import math
from types import SimpleNamespace

import numpy as np
import torch

from sqmc_tpu_torch.ops import ctchain

F64 = torch.float64
CASES = ("hubk2x2", "hubk2x4", "hubk4x4", "hubk4x4_cut", "hubk2x4_cut",
         "wide48", "two_word72")
# (lattice or synthetic norb, nup, ndn, slots, n_moves, tau, drawn share)
_SPECS = {"hubk2x2": ((2, 2), 2, 2, 3000, 12, 0.08, 0.6),
          "hubk2x4": ((2, 4), 3, 3, 3000, 12, 0.02, 0.6),
          "hubk4x4": ((4, 4), 5, 5, 4000, 12, 5e-3, 0.6),
          "hubk4x4_cut": ((4, 4), 5, 5, 3000, 2, 0.03, 0.7),
          "hubk2x4_cut": ((2, 4), 3, 3, 3000, 2, 0.1, 0.7),
          "wide48": (48, 6, 5, 3000, 6, 0.02, 0.6),
          "two_word72": (72, 7, 6, 3000, 6, 0.02, 0.6),
          "cell": ((4, 4), 5, 5, 262_144, 12, 5e-3, 0.4)}


def _hubbardk(lx, ly, nup, ndn, tau):
    from sqmc_tpu_torch.algo import walk as TW
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_k_system
    s = make_hubbard_k_system(lx, ly, 1.0, 4.0, nup, ndn, device="cpu")
    cfg = TW.WalkConfig(mwalk=8, cap_spawn=8, norb=s.norb, nup=nup, ndn=ndn,
                        n_words=s.n_words, tau=tau, w_abs_target=1.0,
                        has_singles=False, semistochastic=False,
                        use_exponential_projector=True)
    kmap3, rate = TW._ct_tables(s, cfg)
    return s.table, np.asarray(kmap3, np.int64), float(rate)


def _synthetic(norb, nup, ndn, rng):
    """Tables of a made-up Hamiltonian over norb orbitals: random band
    energies, a symmetric direct table and an exchange table with the
    same diagonal, kmap3 uniform over the orbitals."""
    h = np.diag(rng.uniform(-2.0, 2.0, norb))
    d = rng.uniform(0.05, 0.3, (norb, norb))
    d = 0.5 * (d + d.T)
    x = rng.uniform(0.0, 0.1, (norb, norb))
    x = 0.5 * (x + x.T)
    np.fill_diagonal(x, np.diag(d))
    table = SimpleNamespace(
        norb=norb, core_energy=0.75, h=torch.as_tensor(h),
        direct=torch.as_tensor(d), exchange=torch.as_tensor(x))
    kmap3 = rng.integers(0, norb, norb ** 3).astype(np.int64)
    rate = nup * ndn * (norb - nup) * 0.02
    return table, kmap3, rate


def random_words(rng, S, norb, n_el):
    """[S, W] int64 words of S dets with n_el of norb orbitals occupied."""
    occ = np.argsort(rng.random((S, norb)), axis=1)[:, :n_el]
    W = (norb + 63) // 64
    words = np.zeros((S, W), np.uint64)
    for w in range(W):
        o = occ - 64 * w
        on = (o >= 0) & (o < 64)
        words[:, w] = np.bitwise_or.reduce(
            np.where(on, np.left_shift(np.uint64(1),
                                       np.clip(o, 0, 63).astype(np.uint64)),
                     np.uint64(0)), axis=1)
    return words.view(np.int64)


def make_case(name, seed=0):
    """The chain's inputs of case ``name`` on the CPU (see the module)."""
    shape, nup, ndn, S, n_moves, tau, drawn = _SPECS[name]
    rng = np.random.default_rng(seed + 7)
    if isinstance(shape, tuple):
        table, kmap3, rate = _hubbardk(*shape, nup, ndn, tau)
    else:
        table, kmap3, rate = _synthetic(shape, nup, ndn, rng)
    norb = table.norb
    up = random_words(rng, S, norb, nup)
    dn = random_words(rng, S, norb, ndn)
    if name == "cell":
        valid = np.arange(S) < int(drawn * S)
    else:
        valid = rng.random(S) < drawn
        sent = ~valid & (rng.random(S) < 0.5)
        up[sent], dn[sent] = -1, -1
    # E_T: the mean diagonal of the drawn parents, so factors stay O(1)
    from sqmc_tpu_torch import dets
    from sqmc_tpu_torch.systems.chem import slater
    up_t, dn_t = torch.as_tensor(up), torch.as_tensor(dn)
    v = torch.as_tensor(valid)
    diag = slater.diag_elements(table, dets.to_bits(up_t[v], norb),
                                dets.to_bits(dn_t[v], norb))
    gen = torch.Generator().manual_seed(seed + 11)
    return dict(u=ctchain.draw_uniforms(gen, n_moves, S, "cpu"),
                up_w=up_t, dn_w=dn_t, slot_valid=v, table=table,
                kmap3=torch.as_tensor(kmap3),
                rate=torch.tensor(rate, dtype=F64),
                tau=torch.tensor(tau, dtype=F64),
                e_trial=diag.mean().to(F64), norb=norb, nup=nup, ndn=ndn)


def plain(c, device="cpu"):
    """ctchain.chain_plain with the hubbardk move on ``device``."""
    t = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
         for k, v in c.items()}
    if device != "cpu":
        tb = c["table"]
        t["table"] = SimpleNamespace(
            norb=tb.norb, core_energy=tb.core_energy, h=tb.h.to(device),
            direct=tb.direct.to(device), exchange=tb.exchange.to(device))
    return ctchain.chain_plain(
        t["u"], t["up_w"], t["dn_w"], t["slot_valid"], t["table"], t["rate"],
        t["tau"], t["e_trial"], c["norb"],
        ctchain.hubbardk_move(t["kmap3"], c["norb"], c["nup"], c["ndn"]))


def scalar_chain(c):
    """The upstream's loop slot by slot: (up, dn, f, ok, n_jumps, n_cut)
    as numpy arrays and ints, and each slot's end: 'undrawn', 'cross',
    'dead' or 'cut', and whether its first time wrapped."""
    norb, nup, ndn = c["norb"], c["nup"], c["ndn"]
    u = c["u"].numpy()
    rate, tau, e_t = float(c["rate"]), float(c["tau"]), float(c["e_trial"])
    tb = c["table"]
    hpp = np.diag(tb.h.numpy()).tolist()
    dd, xx = tb.direct.numpy().tolist(), tb.exchange.numpy().tolist()
    core = float(tb.core_energy)
    kmap3 = c["kmap3"].numpy().tolist()
    W = c["up_w"].shape[1]
    mask = (1 << 64) - 1

    def to_int(row):
        return sum((int(x) & mask) << (64 * i) for i, x in enumerate(row))

    def to_words(x):
        return [((x >> (64 * i)) & mask) for i in range(W)]

    def orbs(x):
        return [o for o in range(norb) if (x >> o) & 1]

    def diag(ou, od):
        e = core + sum(hpp[p] for p in ou + od)
        for occ in (ou, od):
            for a, p in enumerate(occ):
                for q in occ[a + 1:]:
                    e += dd[p][q] - xx[p][q]
        return e + sum(dd[p][q] for p in ou for q in od)

    def between(x, a, b):
        lo, hi = min(a, b), max(a, b)
        return bin((x >> (lo + 1)) & ((1 << max(hi - lo - 1, 0)) - 1)).count("1")

    S = u.shape[2]
    up_in, dn_in = c["up_w"].numpy(), c["dn_w"].numpy()
    valid = c["slot_valid"].numpy()
    up_o, dn_o = np.zeros((S, W), np.uint64), np.zeros((S, W), np.uint64)
    f_o, end, wrapped = np.zeros(S), [], np.zeros(S, bool)
    n_jumps = 0
    for sl in range(S):
        cu, cd = to_int(up_in[sl]), to_int(dn_in[sl])
        f, why = 0.0, "undrawn"
        if valid[sl]:
            f, t, why = 1.0, 0.0, "cut"
            for i in range(u.shape[0]):
                u0, u1, u2, u3 = (float(u[i, k, sl]) for k in range(4))
                dt = -math.log(max(u0, 1e-30)) / rate
                if i == 0:
                    wrapped[sl] = dt > tau
                    dt = math.fmod(dt, tau)
                ou, od = orbs(cu), orbs(cd)
                e_ii = diag(ou, od)
                if t + dt > tau:
                    f *= math.exp((tau - t) * (e_t - e_ii + rate))
                    why = "cross"
                    break
                f *= math.exp(dt * (e_t - e_ii + rate))
                emp = [o for o in range(norb) if not (cu >> o) & 1]
                p = ou[min(int(u1 * nup), nup - 1)]
                q = od[min(int(u2 * ndn), ndn - 1)]
                r = emp[min(int(u3 * (norb - nup)), norb - nup - 1)]
                s = kmap3[(p * norb + q) * norb + r]
                if (cd >> s) & 1:
                    f, why = 0.0, "dead"
                    break
                n = between(cu, p, r) + between(cd, q, s)
                f *= -1.0 if n % 2 == 0 else 1.0
                cu ^= (1 << p) | (1 << r)
                cd ^= (1 << q) | (1 << s)
                t += dt
                n_jumps += 1
            if why == "cut":
                f = 0.0
        up_o[sl], dn_o[sl] = to_words(cu), to_words(cd)
        f_o[sl] = f
        end.append(why)
    end = np.array(end)
    return dict(up=up_o.view(np.int64), dn=dn_o.view(np.int64), f=f_o,
                ok=valid & (f_o != 0), n_jumps=n_jumps,
                n_cut=int((end == "cut").sum()), end=end, wrapped=wrapped)
