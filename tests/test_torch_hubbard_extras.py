"""The port's Hubbard extras against the JAX package's on the same inputs:
mean field (1e-12), the batched VMC pieces on a state from init_vmc and
run_vmc against the brute-force Gutzwiller energy, the CPMC set-up,
overlaps and Green's functions (1e-10) and run_cpmc against dense ED
with tests/test_cpmc.py's tolerances, the lattice symmetry maps, orbits,
representatives and symmetrized spectra (also for a det with bit 63 set),
and the density-matrix block basis (1e-9)."""

import itertools

import numpy as np
import pytest
import torch

from sqmc_tpu.systems.hubbard import cpmc as jcp
from sqmc_tpu.systems.hubbard import dmbasis as jdm
from sqmc_tpu.systems.hubbard import meanfield as jmf
from sqmc_tpu.systems.hubbard import symmetry as jsym
from sqmc_tpu.systems.hubbard import vmc as jvmc
from sqmc_tpu.systems.hubbard.system import (
    make_hubbard_k_system as j_hubbard_k)
from sqmc_tpu_torch import dets
from sqmc_tpu_torch.convert import cpmc_state_from_numpy, vmc_state_from_numpy
from sqmc_tpu_torch.systems.hubbard import cpmc as tcp
from sqmc_tpu_torch.systems.hubbard import dmbasis as tdm
from sqmc_tpu_torch.systems.hubbard import meanfield as tmf
from sqmc_tpu_torch.systems.hubbard import symmetry as tsym
from sqmc_tpu_torch.systems.hubbard import vmc as tvmc
from sqmc_tpu_torch.systems.hubbard.system import (make_hubbard_dense_system,
                                                   make_hubbard_k_system)

torch.set_num_threads(1)
F64 = torch.float64


# ---------------------------------------------------------------------------
# mean field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 2, True), (2, 2, True), (1, 6, False),
                                   (4, 4, True)])
def test_meanfield_matches_jax(shape):
    l_x, l_y, pbc = shape
    np.testing.assert_array_equal(tmf.hopping_matrix(l_x, l_y, 1.3, pbc),
                                  jmf.hopping_matrix(l_x, l_y, 1.3, pbc))
    for m in (0.0, 0.3):
        a = tmf.hartree_fock(l_x, l_y, 1.0, 4.0, 2, 1, pbc, m)
        b = jmf.hartree_fock(l_x, l_y, 1.0, 4.0, 2, 1, pbc, m)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    (ra, ba), (rb, bb) = (f(l_x, l_y, 1.0, 4.0, 2, 2, pbc)
                          for f in (tmf.uhf_scan, jmf.uhf_scan))
    np.testing.assert_allclose(ra, rb, rtol=0, atol=1e-12)
    assert ba[3] == bb[3] and ba[2] == pytest.approx(bb[2], abs=1e-12)


# ---------------------------------------------------------------------------
# VMC
# ---------------------------------------------------------------------------

LX, LY, T, U = 3, 2, 1.0, 4.0


@pytest.fixture(scope="module")
def vmc_pair():
    """Orbitals and a 24-walker start state in both packages (nup != ndn,
    so the two spins' matrices differ in size)."""
    pu, pd, _ = jmf.hartree_fock(LX, LY, T, U, 3, 2, pbc=True, m=0.2)
    sj = jvmc.init_vmc(pu, pd, LX, LY, n_walkers=24, seed=3)
    st = tvmc.init_vmc(pu, pd, LX, LY, n_walkers=24, seed=3, device="cpu")
    return pu, pd, sj, st


def test_vmc_state_and_neighbor_table_match_jax(vmc_pair):
    pu, pd, sj, st = vmc_pair
    for shape in ((3, 2, True), (2, 2, True), (1, 8, False), (4, 4, True)):
        np.testing.assert_array_equal(tvmc.neighbor_table(*shape),
                                      jvmc.neighbor_table(*shape))
    conv = vmc_state_from_numpy(sj, device="cpu")
    for a, b, c in zip(st[:4], sj[:4], conv[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
        assert torch.equal(a, c.to(a.dtype)) or torch.allclose(a, c)
    assert st.r_up.dtype == torch.int64


def test_sm_row_update_matches_jax(vmc_pair):
    import jax.numpy as jnp
    pu, pd, sj, st = vmc_pair
    rng = np.random.default_rng(1)
    nw = st.r_up.shape[0]
    k = rng.integers(0, 3, nw)
    v = pu[rng.integers(0, LX * LY, nw)]
    ratio, new = tvmc._sm_row_update(st.minv_up, torch.as_tensor(k),
                                     torch.as_tensor(v))
    for w in range(nw):
        rj, nj = jvmc._sm_row_update(sj.minv_up[w], jnp.asarray(k[w]),
                                     jnp.asarray(v[w]))
        assert float(ratio[w]) == pytest.approx(float(rj), abs=1e-12)
        if abs(float(rj)) < 1e-8:
            continue              # a move onto a node: no inverse to compare
        np.testing.assert_allclose(new[w].numpy(), np.asarray(nj), rtol=1e-9,
                                   atol=1e-10)
    # the update IS the inverse of the matrix with row k replaced
    a = pu[st.r_up.numpy()[0]].copy()
    a[k[0]] = v[0]
    if abs(float(ratio[0])) > 1e-3:
        np.testing.assert_allclose(new[0].numpy(), np.linalg.inv(a),
                                   atol=1e-8)


def test_local_energy_matches_jax(vmc_pair):
    import jax
    import jax.numpy as jnp
    pu, pd, sj, st = vmc_pair
    nbr = tvmc.neighbor_table(LX, LY, True)
    for g in (1.0, 0.7):
        e_t = tvmc._local_energy(
            st.r_up, st.r_dn, st.minv_up, st.minv_dn, torch.as_tensor(pu),
            torch.as_tensor(pd), torch.as_tensor(nbr, dtype=torch.int64),
            torch.tensor(g, dtype=F64), U, T, LX * LY)
        e_j = jax.vmap(jvmc._local_energy_one,
                       in_axes=(0, 0, 0, 0) + (None,) * 7)(
            sj.r_up, sj.r_dn, sj.minv_up, sj.minv_dn, jnp.asarray(pu),
            jnp.asarray(pd), jnp.asarray(nbr), g, U, T, LX * LY)
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0,
                                   atol=1e-10)


def test_sweep_keeps_inverses_and_exclusion(vmc_pair):
    """After 40 Metropolis steps the running inverses still match the
    recomputed ones, no two like-spin electrons share a site, and the
    stream continues from the state's generator state."""
    pu, pd, _, st = vmc_pair
    nbr = torch.as_tensor(tvmc.neighbor_table(LX, LY, True), dtype=torch.int64)
    args = (torch.as_tensor(pu), torch.as_tensor(pd), nbr, 0.8, U, T)
    s1, e1 = tvmc.vmc_sweep(st, *args, 40, LX * LY)
    assert not torch.equal(s1.r_up, st.r_up)
    np.testing.assert_allclose(s1.minv_up.numpy(),
                               np.linalg.inv(pu[s1.r_up.numpy()]), atol=1e-8)
    np.testing.assert_allclose(s1.minv_dn.numpy(),
                               np.linalg.inv(pd[s1.r_dn.numpy()]), atol=1e-8)
    for r in (s1.r_up.numpy(), s1.r_dn.numpy()):
        assert all(len(set(row)) == len(row) for row in r)
    assert e1.shape == (24,) and bool(torch.isfinite(e1).all())
    s2, _ = tvmc.vmc_sweep(st, *args, 20, LX * LY)
    s2, e2 = tvmc.vmc_sweep(s2, *args, 20, LX * LY)
    assert torch.equal(s2.r_up, s1.r_up) and torch.equal(e1, e2)


@pytest.mark.parametrize("g", [1.0, 0.7])
def test_run_vmc_lands_on_the_exact_gutzwiller_energy(g):
    pu, pd, _ = tmf.hartree_fock(2, 2, T, U, 2, 1, pbc=True, m=0.2)
    e_exact = tvmc.exact_vmc_energy(2, 2, T, U, 2, 1, g, pu, pd)
    assert e_exact == pytest.approx(
        jvmc.exact_vmc_energy(2, 2, T, U, 2, 1, g, pu, pd), abs=1e-12)
    e, err = tvmc.run_vmc(2, 2, T, U, 2, 1, g, phi_up=pu, phi_dn=pd,
                          n_walkers=256, n_sweeps=150, n_eq=50,
                          steps_per_sweep=12, seed=1, device="cpu")
    assert abs(e - e_exact) < max(5 * err, 0.02), (e, e_exact, err)


# ---------------------------------------------------------------------------
# CPMC
# ---------------------------------------------------------------------------

def test_cpmc_setup_overlap_greens_match_jax():
    import jax.numpy as jnp
    kw = dict(l_x=3, l_y=2, t=1.0, U=4.0, nup=2, ndn=1, tau=0.05,
              n_walkers=8)
    sj, stj = jcp.init_cpmc(jcp.CpmcConfig(**kw), seed=0)
    st_, stt = tcp.init_cpmc(tcp.CpmcConfig(**kw), seed=0, device="cpu")
    for k in ("exp_half_k", "phi_t_up", "phi_t_dn", "K"):
        np.testing.assert_allclose(st_[k].numpy(), np.asarray(sj[k]), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert st_["gamma"] == sj["gamma"] and st_["ns"] == sj["ns"]
    assert st_["e_trial"] == pytest.approx(sj["e_trial"], abs=1e-12)
    conv = cpmc_state_from_numpy(stj, device="cpu")
    assert torch.allclose(conv.phi_up, stt.phi_up) and bool(conv.alive.all())

    rng = np.random.default_rng(2)
    phi = np.asarray(stj.phi_up) + 0.3 * rng.standard_normal((8, 6, 2))
    s_t, l_t = tcp._overlap(st_["phi_t_up"], torch.as_tensor(phi))
    s_j, l_j = jcp._overlap(sj["phi_t_up"], jnp.asarray(phi))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-12)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-10)
    np.testing.assert_allclose(
        tcp._greens(st_["phi_t_up"], torch.as_tensor(phi)).numpy(),
        np.asarray(jcp._greens(sj["phi_t_up"], jnp.asarray(phi))), rtol=0,
        atol=1e-10)


@pytest.mark.parametrize("method", ["cholesky", "qr"])
def test_orthonormalize_keeps_the_column_space(method):
    rng = np.random.default_rng(5)
    p = torch.as_tensor(rng.standard_normal((10, 6, 3)))
    q = tcp._orthonormalize(p, method)
    eye = torch.eye(3, dtype=F64).expand(10, 3, 3)
    assert torch.allclose(q.transpose(1, 2) @ q, eye, atol=1e-12)
    # same span: projecting p onto q loses nothing
    assert torch.allclose(q @ (q.transpose(1, 2) @ p), p, atol=1e-12)


def test_cpmc_free_projection_agrees_at_small_u():
    """At U = 1 the constrained-path bias is negligible: the constrained
    and the free projection both land on dense ED."""
    e0 = _e_exact(1.0)
    for constrained in (True, False):
        cfg = tcp.CpmcConfig(2, 2, 1.0, 1.0, 1, 1, tau=0.05, n_walkers=128,
                             constrained=constrained)
        e, err = tcp.run_cpmc(cfg, n_blocks=20, nstep=20, n_eq=6, seed=2,
                              device="cpu")
        assert abs(e - e0) < max(5 * err, 0.05), (constrained, e, e0, err)


def _e_exact(U_):
    toy = make_hubbard_dense_system(2, 2, 1.0, U_, 1, 1, pbc=True,
                                    device="cpu")
    return float(torch.linalg.eigvalsh(toy.ham)[0])


@pytest.mark.parametrize("U_", [0.0, 4.0])
def test_run_cpmc_lands_on_dense_ed(U_):
    e0 = _e_exact(U_)
    cfg = tcp.CpmcConfig(2, 2, 1.0, U_, 1, 1, tau=0.05, n_walkers=128)
    e, err = tcp.run_cpmc(cfg, n_blocks=24, nstep=20, n_eq=8, seed=1,
                          device="cpu")
    assert abs(e - e0) < max(5 * err, 0.05 if U_ > 0 else 1e-6), (e, e0, err)


# ---------------------------------------------------------------------------
# lattice symmetry
# ---------------------------------------------------------------------------

L, NUP, NDN = 2, 2, 2


@pytest.fixture(scope="module")
def sym_setup():
    jh = j_hubbard_k(L, L, 1.0, 4.0, NUP, NDN)
    th = make_hubbard_k_system(L, L, 1.0, 4.0, NUP, NDN, device="cpu")
    ups = np.stack([dets.det_from_orbs(c, 4)
                    for c in itertools.combinations(range(4), NUP)])
    up = np.repeat(ups, len(ups), axis=0)
    dn = np.tile(ups, (len(ups), 1))
    return jh, th, up, dn


@pytest.mark.parametrize("l", [2, 4])
def test_k_symmetry_maps_match_jax(l):
    (c4, refl), (jc4, jrefl) = tsym.k_symmetry_maps(l, l), \
        jsym.k_symmetry_maps(l, l)
    np.testing.assert_array_equal(c4, jc4)
    np.testing.assert_array_equal(refl, jrefl)
    with pytest.raises(ValueError, match="l_x == l_y"):
        tsym.k_symmetry_maps(2, 4)


@pytest.mark.parametrize("z,p", [(1, 1), (-1, 1), (1, -1)])
def test_orbits_and_representatives_match_jax(sym_setup, z, p):
    jh, th, up, dn = sym_setup
    c4, refl = tsym.k_symmetry_maps(L, L)
    uu, du = up.view(np.uint64), dn.view(np.uint64)
    ou, od, ph = tsym.orbit(up, dn, NUP, NDN, 4, c4, refl, z, p)
    jou, jod, jph = jsym.orbit(uu, du, NUP, NDN, 4, c4, refl, z, p)
    assert ou.dtype == np.int64
    np.testing.assert_array_equal(ou.view(np.uint64), jou)
    np.testing.assert_array_equal(od.view(np.uint64), jod)
    np.testing.assert_array_equal(ph, jph)
    a = tsym.representatives(torch.as_tensor(up), torch.as_tensor(dn), NUP,
                             NDN, 4, c4, refl, z, p)
    b = jsym.representatives(uu, du, NUP, NDN, 4, c4, refl, z, p)
    np.testing.assert_array_equal(a[0].view(np.uint64), b[0])
    np.testing.assert_array_equal(a[1].view(np.uint64), b[1])
    np.testing.assert_allclose(a[2], b[2], atol=1e-14)
    np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("z,p", [(1, 1), (-1, 1), (1, -1)])
def test_symmetrized_spectrum_matches_jax(sym_setup, z, p):
    jh, th, up, dn = sym_setup
    c4, refl = tsym.k_symmetry_maps(L, L)
    uu, du = up.view(np.uint64), dn.view(np.uint64)
    reps = np.nonzero(tsym.representatives(up, dn, NUP, NDN, 4, c4, refl,
                                           z, p)[3])[0]
    jreps = np.nonzero(jsym.representatives(uu, du, NUP, NDN, 4, c4, refl,
                                            z, p)[3])[0]
    np.testing.assert_array_equal(reps, jreps)      # possibly both empty
    n = len(reps)
    Ht, Hj = np.zeros((n, n)), np.zeros((n, n))
    for i, a in enumerate(reps):
        for j, b in enumerate(reps[i:], start=i):
            Ht[i, j] = Ht[j, i] = tsym.symmetrized_matrix_element(
                th.table, up[a], dn[a], up[b], dn[b], NUP, NDN, 4, c4, refl,
                z, p)
            Hj[i, j] = Hj[j, i] = jsym.symmetrized_matrix_element(
                jh.table, uu[a], du[a], uu[b], du[b], NUP, NDN, 4, c4, refl,
                z, p)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.linalg.eigvalsh(Ht), np.linalg.eigvalsh(Hj),
                               atol=1e-10)


def test_representative_of_a_det_with_bit_63_set():
    """8x8 lattice: 64 orbitals, so a det can occupy orbital 63 and its
    int64 word is negative.  The representative is the orbit member with
    the largest key in UNSIGNED order, as in the JAX package's uint64."""
    c4, refl = tsym.k_symmetry_maps(8, 8)
    rng = np.random.default_rng(7)
    ups, dns = [], []
    for _ in range(12):
        ups.append(dets.det_from_orbs([63] + sorted(
            rng.choice(63, 2, replace=False).tolist()), 64))
        dns.append(dets.det_from_orbs(sorted(
            rng.choice(64, 3, replace=False).tolist()), 64))
    up, dn = np.stack(ups), np.stack(dns)
    assert (up < 0).all()
    a = tsym.representatives(up, dn, 3, 3, 64, c4, refl, 1, 1)
    b = jsym.representatives(up.view(np.uint64), dn.view(np.uint64), 3, 3,
                             64, c4, refl, 1, 1)
    np.testing.assert_array_equal(a[0].view(np.uint64), b[0])
    np.testing.assert_array_equal(a[1].view(np.uint64), b[1])
    np.testing.assert_array_equal(a[3], b[3])
    # signed order would pick another member for at least one of them
    ou, od, _ = tsym.orbit(up, dn, 3, 3, 64, c4, refl, 1, 1)
    signed = (ou[..., 0].astype(object) << 64) | od[..., 0].view(
        np.uint64).astype(object)
    pick = np.argmax(signed, axis=1)
    assert any(not np.array_equal(ou[i, pick[i]], a[0][i])
               for i in range(len(up)))


# ---------------------------------------------------------------------------
# density-matrix block basis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rho_pair():
    args = (jdm.CROSS_BONDS, jdm.CROSS_NSITES, 1.0, 4.0)
    return (jdm.patch_density_matrix(*args, nup_emb=2, ndn_emb=2),
            tdm.patch_density_matrix(*args, nup_emb=2, ndn_emb=2,
                                     device="cpu"))


def test_patch_density_matrix_and_rotation_match_jax(rho_pair):
    rj, rt = rho_pair
    assert tdm.CROSS_BONDS == jdm.CROSS_BONDS
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-9)
    assert np.trace(rt) == pytest.approx(1.0, abs=1e-10)
    a, b = tdm.block_rotation(rj), jdm.block_rotation(rj)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    assert np.allclose(a[0] @ a[0].T, np.eye(256), atol=1e-10)


@pytest.mark.parametrize("keep", [None, 3])
def test_dm_basis_hamiltonian_matches_jax(rho_pair, keep):
    rj, _ = rho_pair
    u, su, sd, _ = jdm.block_rotation(rj)
    Ht, bt = tdm.dm_basis_hamiltonian(4, 2, 1.0, 4.0, 2, 2, u, su, sd,
                                      keep_per_sector=keep, device="cpu")
    Hj, bj = jdm.dm_basis_hamiltonian(4, 2, 1.0, 4.0, 2, 2, u, su, sd,
                                      keep_per_sector=keep)
    assert bt == bj
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=0, atol=1e-9)
    toy = make_hubbard_dense_system(4, 2, 1.0, 4.0, 2, 2, device="cpu")
    w_real = torch.linalg.eigvalsh(toy.ham).numpy()
    w_dm = torch.linalg.eigvalsh(Ht).numpy()
    if keep is None:                  # the exact rotation keeps the spectrum
        assert Ht.shape[0] == toy.ndet
        np.testing.assert_allclose(w_dm, w_real, atol=1e-9)
    else:                             # the truncated basis is variational
        assert Ht.shape[0] < toy.ndet and w_dm[0] >= w_real[0] - 1e-10


def test_make_hubbarddm_dense_is_a_toy_system():
    sys_, info = tdm.make_hubbarddm_dense(4, 2, 1.0, 4.0, 1, 1, device="cpu")
    toy = make_hubbard_dense_system(4, 2, 1.0, 4.0, 1, 1, device="cpu")
    assert sys_.kind == "hubbarddm" and sys_.ndet == toy.ndet
    assert float(torch.linalg.eigvalsh(sys_.ham)[0]) == pytest.approx(
        float(torch.linalg.eigvalsh(toy.ham)[0]), abs=1e-8)
    assert set(info) == {"rho", "u", "weights", "basis"}
    with pytest.raises(ValueError, match="embedding"):
        tdm.make_hubbarddm_dense(4, 2, 1.0, 4.0, 1, 1, embedding="square",
                                 device="cpu")


def test_hubbard_extras_default_to_the_card():
    """Every entry point of these modules builds on the card unless told
    otherwise, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pu, pd, _ = tmf.hartree_fock(2, 2, 1.0, 4.0, 1, 1)
    calls = (
        lambda: tvmc.init_vmc(pu, pd, 2, 2, n_walkers=2),
        lambda: tvmc.run_vmc(2, 2, 1.0, 4.0, 1, 1, g=1.0, n_sweeps=1, n_eq=0),
        lambda: tcp.init_cpmc(tcp.CpmcConfig(2, 2, 1.0, 4.0, 1, 1)),
        lambda: tcp.run_cpmc(tcp.CpmcConfig(2, 2, 1.0, 4.0, 1, 1), n_blocks=1),
        lambda: tdm.make_hubbarddm_dense(4, 2, 1.0, 4.0, 1, 1),
        lambda: make_hubbard_dense_system(2, 2, 1.0, 4.0, 1, 1),
    )
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
