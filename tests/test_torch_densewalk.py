"""The port's dense-vector walk engine (sqmc_tpu_torch/algo/densewalk.py)
against the JAX package's on the fixtures of tests/test_densewalk.py:

  * ``_projector_parts`` and every field of ``build_dense_tables`` for all
    ten run types, with and without importance sampling (1e-12; the
    exponential projector 1e-9);
  * the deterministic limit: with min_wt = 0 the step draws nothing, so 40
    generations (two equilibration blocks, two measured ones, the block
    sums rolled in between) of w, e_trial, e_est, reweight_factor_inv and
    the per-generation statistics match ``dense_walk_block`` to 1e-10 for
    eight run types, release_node across its release step;
  * the comb against a numpy transcription at a given offset;
  * stochastic runs against dense ED within max(4 sigma, 2e-3) (the two
    packages cannot share a random stream)."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo import densewalk as jdw
from sqmc_tpu.systems.toy import make_fictitious_system as j_fictitious
from sqmc_tpu_torch.algo import densewalk as tdw
from sqmc_tpu_torch.convert import (dense_state_from_numpy,
                                    dense_tables_from_numpy,
                                    toy_system_from_numpy)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def boson():
    """Sign-problem-free fictitious matrix (bosonic=1), in both packages."""
    j = j_fictitious(20, bosonic=1, spectrum_coef=1.0, spectrum_power=1.0,
                     ham_diag_fluc=0.5, ham_offdiag_fluc=1.0)
    return j, toy_system_from_numpy(j, device="cpu")


@pytest.fixture(scope="module")
def fermi():
    """Sign-problem fictitious matrix (bosonic=0), in both packages."""
    j = j_fictitious(16, bosonic=0, spectrum_coef=1.0, spectrum_power=1.0,
                     ham_diag_fluc=0.5, ham_offdiag_fluc=1.5,
                     seed=(1, 2, 3, 5))
    return j, toy_system_from_numpy(j, device="cpu")


def _guide(j):
    """A guiding vector with the wrong nodes in places: violators exist."""
    g = j.diagonalize()[1]
    rng = np.random.default_rng(0)
    g = g + 0.25 * rng.standard_normal(g.shape) * np.abs(g).mean()
    g[np.abs(g) < 1e-3] = 1e-3
    return g


def _cfgs(ndet, run_type, imp, **kw):
    base = dict(ndet=ndet, tau=0.02, w_abs_target=1000.0, run_type=run_type,
                importance_sampling=imp, partial_node_eps=0.6, **kw)
    return jdw.DenseWalkConfig(**base), tdw.DenseWalkConfig(**base)


def test_run_types_and_config_agree():
    assert tdw.RUN_TYPES == jdw.RUN_TYPES
    with pytest.raises(ValueError, match="unknown run_type"):
        tdw.DenseWalkConfig(ndet=4, tau=0.1, w_abs_target=1.0, run_type="hci")


@pytest.mark.parametrize("imp", [0, 1])
@pytest.mark.parametrize("run_type", jdw.RUN_TYPES)
def test_projector_parts_and_tables_match_jax(fermi, run_type, imp):
    j, t = fermi
    g = _guide(j)
    psi_t = j.diagonalize()[1]
    pj, dj = jdw._projector_parts(j.ham, 0.02, run_type, g, imp, 0.6)
    pt, dt = tdw._projector_parts(t.ham, 0.02, run_type, g, imp, 0.6)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-12)
    if imp and run_type == "fixed_node1":
        assert (pj == 0).sum() > len(g)          # violators were removed
    if run_type == "sr" and not imp:
        return                                   # raises: tested below
    cj, ct = _cfgs(j.ndet, run_type, imp)
    tj = jdw.build_dense_tables(j, cj, psi_t, g)
    tt = tdw.build_dense_tables(t, ct, psi_t, g)
    for name in tdw.DenseTables._fields:
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(tj, name)), rtol=0,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("run_type,imp", [("none", 0), ("fixed_node1", 1),
                                          ("partial_node", 1)])
def test_exponential_projector_tables_match_jax(fermi, run_type, imp):
    j, t = fermi
    g = _guide(j)
    psi_t = j.diagonalize()[1]
    cj, ct = _cfgs(j.ndet, run_type, imp, use_exponential_projector=True)
    tj = jdw.build_dense_tables(j, cj, psi_t, g)
    tt = tdw.build_dense_tables(t, ct, psi_t, g)
    for name in tdw.DenseTables._fields:
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(tj, name)), rtol=0,
                                   atol=1e-9, err_msg=name)
    # it is the exponential: the exact one equals expm(-tau H~) at e_trial 0
    if run_type == "none":
        w, v = np.linalg.eigh(j.ham)
        expm = v @ np.diag(np.exp(-0.02 * w)) @ v.T
        full = tt.p_off.numpy() + np.diag(tt.p_diag0.numpy())
        np.testing.assert_allclose(full, expm, rtol=0, atol=1e-10)


def test_sr_without_importance_sampling_raises(fermi):
    _, t = fermi
    cfg = tdw.DenseWalkConfig(ndet=t.ndet, tau=0.02, w_abs_target=100.0,
                              run_type="sr", importance_sampling=0)
    with pytest.raises(ValueError, match="importance sampling"):
        tdw.build_dense_tables(t, cfg, np.ones(t.ndet), None)


TRACE_CASES = {
    "none": ("none", 0, {}),
    "fixed_node1": ("fixed_node1", 1, {}),
    "fixed_node2": ("fixed_node2", 1, {}),
    "fixed_node3": ("fixed_node3", 1, {}),
    "fixed_node4": ("fixed_node4", 1, {}),
    "partial_node": ("partial_node", 1, {}),
    "release_node": ("release_node", 1, dict(release_step=15)),
    "vmc": ("vmc", 1, {}),
    "exponential": ("none", 0, dict(use_exponential_projector=True)),
}


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
def test_dense_deterministic_limit_trace_matches_jax(fermi, name):
    """min_wt = 0: no draw, so both packages follow one trajectory."""
    import jax.numpy as jnp
    j, t = fermi
    run_type, imp, kw = TRACE_CASES[name]
    g = _guide(j)
    psi_t = j.diagonalize()[1]
    cj, ct = _cfgs(j.ndet, run_type, imp, min_wt=0.0, **kw)
    tj = jdw.build_dense_tables(j, cj, psi_t, g)
    tt = dense_tables_from_numpy(tj, device="cpu")
    sj = jdw.init_dense_state(cj, psi_t, g, 700.0, -0.3, seed=0)
    st = dense_state_from_numpy(sj, device="cpu")
    st0 = tdw.init_dense_state(ct, psi_t, g, 700.0, -0.3, device="cpu")
    np.testing.assert_allclose(st0.w.numpy(), np.asarray(sj.w), atol=1e-13)

    for iblk in range(4):
        if iblk >= 2:
            sj = sj._replace(equilibrated=jnp.asarray(True))
            st = st._replace(equilibrated=True)
        sj, stats_j = jdw.dense_walk_block(sj, tj, cj, 10)
        st, stats_t = tdw.dense_walk_block(st, tt, ct, 10)
        assert st.step == int(sj.step) == 10 * (iblk + 1)
        scale = max(1.0, float(np.abs(np.asarray(sj.w)).max()))
        np.testing.assert_allclose(st.w.numpy(), np.asarray(sj.w), rtol=0,
                                   atol=1e-10 * scale)
        for f in ("e_trial", "e_est", "reweight_factor_inv", "w_abs_gen",
                  "e_num_blk", "e_den_blk"):
            a, b = float(getattr(st, f)), float(getattr(sj, f))
            assert abs(a - b) < 1e-10 * max(1.0, abs(b)), (f, iblk, a, b)
        for k in ("e_num_gen", "e_den_gen", "w_abs_gen", "e_gen"):
            b = np.asarray(stats_j[k])
            np.testing.assert_allclose(stats_t[k].numpy(), b, rtol=1e-10,
                                       atol=1e-10, err_msg=k)
        sj = sj._replace(
            e_num_blkabs_cum=sj.e_num_blkabs_cum
            + sj.e_num_blk * jnp.sign(sj.e_den_blk),
            e_den_blkabs_cum=sj.e_den_blkabs_cum + jnp.abs(sj.e_den_blk),
            e_num_blk=jnp.zeros_like(sj.e_num_blk),
            e_den_blk=jnp.zeros_like(sj.e_den_blk))
        st = tdw.end_of_dense_block(st)
        assert float(st.e_den_blkabs_cum) == pytest.approx(
            float(sj.e_den_blkabs_cum), rel=1e-10)
    if name == "release_node":
        # the released projector is the exact one: signed weights appear
        assert float(st.w.min()) < 0 or not torch.equal(tt.p_off,
                                                        tt.p_off_exact)


def test_comb_reconfigure_against_numpy_transcription():
    rng = np.random.default_rng(3)
    w = rng.standard_normal(50) * (rng.random(50) < 0.7)
    n_comb = 37
    for u in (0.0, 0.318, 0.999):
        aw = np.abs(w)
        total = aw.sum()
        pts = (u + np.arange(n_comb)) * (total / n_comb)
        idx = np.searchsorted(np.cumsum(aw), pts).clip(0, len(w) - 1)
        counts = np.bincount(idx, minlength=len(w)).astype(float)
        want = np.sign(w) * counts * (total / n_comb)
        got = tdw._comb_reconfigure(torch.as_tensor(w), u, n_comb).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
        assert abs(np.abs(got).sum() - total) < 1e-12 * total
        assert np.all(got * w >= 0) and np.all(got[w == 0] == 0)


def test_deterministic_ground_state_is_the_ed_one(boson):
    j, t = boson
    e, v = tdw.deterministic_ground_state(t)
    w, g = t.diagonalize()
    assert e == pytest.approx(float(w[0]), abs=1e-9)
    assert abs(abs(float(v @ g)) - 1) < 1e-6
    assert e == pytest.approx(jdw.deterministic_ground_state(j)[0], abs=1e-9)


STOCHASTIC = {
    # name: (fixture, run_type, importance sampling, options, psi_g, tau)
    "none_boson": ("boson", "none", 0, {}, "exact", 0.02),
    "fixed_node1_exact_nodes": ("fermi", "fixed_node1", 1, {}, "exact", 0.02),
    "release_node": ("fermi", "release_node", 1, dict(release_step=100),
                     "shifted", 0.02),
    "sr": ("fermi", "sr", 1, dict(partial_node_eps=1.0, min_wt=0.0,
                                  sr_nwalk=1000), "exact", 0.02),
    "exponential": ("boson", "none", 0,
                    dict(use_exponential_projector=True), "exact", 0.05),
}


@pytest.mark.parametrize("name", sorted(STOCHASTIC))
def test_dense_stochastic_walk_lands_on_ed(request, name):
    fixture, run_type, imp, opts, guide, tau = STOCHASTIC[name]
    _, t = request.getfixturevalue(fixture)
    w, g = t.diagonalize()
    e0 = float(w[0])
    psi_g = g if guide == "exact" else g.abs() + 1e-2
    opts = dict(dict(min_wt=0.25), **opts)
    cfg = tdw.DenseWalkConfig(ndet=t.ndet, tau=tau, w_abs_target=2000.0,
                              run_type=run_type, importance_sampling=imp,
                              **opts)
    out = tdw.run_dense_walk(t, cfg, g, psi_g, nstep=200, nblk=12, nblk_eq=4,
                             w_abs_begin=500.0, seed=1)
    assert out.n_measured == 1600 and out.device_ms_per_gen is None
    assert len(out.w_abs_trace) == 2400 and len(out.block_energies) == 8
    tol = max(5 * out.e_err, 5e-3) if name in ("release_node", "sr") else \
        max(4 * out.e_err, 2e-3)            # tests/test_densewalk.py's bounds
    assert abs(out.e_mixed - e0) < tol, (out.e_mixed, e0, out.e_err)
    if name == "fixed_node1_exact_nodes":
        assert float(out.state.w.min()) >= -1e-12
    if name == "sr":
        # the comb conserves sum |w| before the reweight
        assert np.all(out.w_abs_trace > 0)


def test_dense_vmc_samples_the_guiding_energy(fermi):
    """vmc mode with psi_g the exact ground state: the chain is stationary
    on psi_g^2 and every local energy is e0."""
    _, t = fermi
    w, g = t.diagonalize()
    cfg = tdw.DenseWalkConfig(ndet=t.ndet, tau=0.02, w_abs_target=2000.0,
                              run_type="vmc", importance_sampling=1,
                              min_wt=0.25)
    out = tdw.run_dense_walk(t, cfg, g, g, nstep=100, nblk=8, nblk_eq=2,
                             w_abs_begin=1000.0, seed=4)
    assert out.e_mixed == pytest.approx(float(w[0]), abs=1e-8)


def test_dense_block_continues_the_generator_stream(boson):
    """A state carries its generator state: two blocks of 20 generations
    equal one run of 40, and the same seed repeats the run."""
    _, t = boson
    w, g = t.diagonalize()
    cfg = tdw.DenseWalkConfig(ndet=t.ndet, tau=0.02, w_abs_target=500.0)
    tables = tdw.build_dense_tables(t, cfg, g, g)
    s0 = tdw.init_dense_state(cfg, g, g, 300.0, float(w[0]), seed=9,
                              device="cpu")
    a, _ = tdw.dense_walk_block(s0, tables, cfg, 40)
    b, _ = tdw.dense_walk_block(s0, tables, cfg, 20)
    b, _ = tdw.dense_walk_block(b, tables, cfg, 20)
    assert torch.equal(a.w, b.w) and a.step == b.step == 40
    assert torch.equal(a.rng_state, b.rng_state)
    c, _ = tdw.dense_walk_block(
        tdw.init_dense_state(cfg, g, g, 300.0, float(w[0]), seed=10,
                             device="cpu"), tables, cfg, 40)
    assert not torch.equal(a.w, c.w)
