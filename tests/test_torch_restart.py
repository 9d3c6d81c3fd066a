"""Restart artifacts and traces of the port against the JAX package's:
the variational wavefunction cache (.npz written by each package, read by
the other; run_hci skipping the variational stage), the reference-format
files of utils/refio.py (byte-identical between the packages, 128-bit det
words with the top bit set), load_trial_from_reference, and the walkalize
per-generation trace."""

import numpy as np
import pytest
import torch

from sqmc_tpu.algo.hci import run_hci as j_run_hci
from sqmc_tpu.algo.semistoch import (
    build_trial_wavefunction as j_build_trial,
    load_trial_from_reference as j_load_trial_from_reference)
from sqmc_tpu.systems.heg.system import make_heg_system as j_make_heg
from sqmc_tpu.utils import blocking as jblocking
from sqmc_tpu.utils import checkpoint as jckpt
from sqmc_tpu.utils import refio as jrefio
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.algo.semistoch import load_trial_from_reference
from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
from sqmc_tpu_torch.convert import (hci_result_from_numpy, system_from_numpy,
                                    trial_from_npz)
from sqmc_tpu_torch.utils import blocking as tblocking
from sqmc_tpu_torch.utils import checkpoint as tckpt
from sqmc_tpu_torch.utils import refio as trefio

torch.set_num_threads(1)
HCI = dict(eps_var=1e-4, eps_var_sched=[1e-4] * 6, verbose=False)


@pytest.fixture(scope="module")
def heg():
    """HEG-4 (33 orbitals) in both packages, its HCI result and a trial."""
    js = j_make_heg(3, 1.0, 4, 2, 1.6)
    jres = j_run_hci(js, **HCI)
    jtrial = j_build_trial(js, eps_var=1e-3, n_psi_t=10, n_imp=8,
                           verbose=False)
    ts = system_from_numpy(js, device="cpu")
    return js, jres, jtrial, ts, hci_result_from_numpy(jres, device="cpu"), \
        trial_from_npz(jtrial, device="cpu")


def _u64(t):
    return t.numpy().view(np.uint64)


def test_wf_var_filename_matches_jax():
    for eps in (1e-4, 2e-3, 5e-5, 1.0, 12.5):
        assert tckpt.wf_var_filename(eps, "d") == jckpt.wf_var_filename(eps, "d")
    assert tckpt.wf_var_filename(1e-4).endswith("wf_eps_var=1.00E-04")


def test_npz_cache_is_interchangeable(tmp_path, heg):
    js, jres, _, ts, tres, _ = heg
    pj, pt = str(tmp_path / "from_jax"), str(tmp_path / "from_torch")
    jckpt.save_wf_var(pj, jres.up, jres.dn, jres.wts, jres.energies, jres.diag)
    tckpt.save_wf_var(pt, tres.up, tres.dn, tres.wts, tres.energies, tres.diag)
    assert tckpt.load_wf_var(str(tmp_path / "absent")) is None
    a, b = tckpt.load_wf_var(pj), jckpt.load_wf_var(pt)
    assert a["up"].dtype == np.int64 and b["up"].dtype == np.uint64
    for k in ("up", "dn"):
        np.testing.assert_array_equal(a[k].view(np.uint64), getattr(jres, k))
        np.testing.assert_array_equal(b[k], getattr(jres, k))
    for k in ("wts", "energies", "diag"):
        np.testing.assert_array_equal(a[k], getattr(jres, k))
        np.testing.assert_array_equal(b[k], getattr(jres, k))


def test_run_hci_cache_skips_the_variational_stage(tmp_path, heg, capsys):
    js, jres, _, ts, _, _ = heg
    d = str(tmp_path)
    kw = dict(eps_var=1e-4, eps_var_sched=[1e-4] * 6)
    first = run_hci(ts, wf_cache_dir=d, dump_wf_var=True, verbose=True, **kw)
    assert first.n_iters > 0
    assert "Writing variational wavefn to" in capsys.readouterr().out
    second = run_hci(ts, wf_cache_dir=d, verbose=True, **kw)
    assert "Reading variational wavefn from" in capsys.readouterr().out
    assert second.n_iters == 0
    np.testing.assert_array_equal(second.energies, first.energies)
    assert torch.equal(second.up, first.up) and torch.equal(second.dn, first.dn)
    np.testing.assert_array_equal(second.wts, first.wts)
    np.testing.assert_array_equal(second.diag, first.diag)
    # the JAX package takes the port's file, and the port the JAX package's
    jsecond = j_run_hci(js, wf_cache_dir=d, verbose=False, **kw)
    assert jsecond.n_iters == 0
    assert jsecond.energies[0] == pytest.approx(first.energies[0], abs=1e-12)
    d2 = tmp_path / "jax"
    d2.mkdir()
    j_run_hci(js, wf_cache_dir=str(d2), dump_wf_var=True, verbose=False, **kw)
    third = run_hci(ts, wf_cache_dir=str(d2), verbose=False, **kw)
    assert third.n_iters == 0
    assert third.energies[0] == pytest.approx(jres.energies[0], abs=1e-12)
    np.testing.assert_array_equal(_u64(third.up), jres.up)
    # a cache with too few states is not used
    two = run_hci(ts, wf_cache_dir=d, n_states=2, verbose=False, **kw)
    assert two.n_iters > 0 and len(two.energies) == 2
    # without dump_wf_var nothing is written
    d3 = tmp_path / "none"
    d3.mkdir()
    run_hci(ts, wf_cache_dir=str(d3), verbose=False, **kw)
    assert list(d3.iterdir()) == []


def test_run_hci_reads_a_reference_format_cache(tmp_path, heg):
    js, jres, _, ts, tres, _ = heg
    fname = tckpt.wf_var_filename(1e-4, str(tmp_path))
    trefio.write_wf_eps_var(fname, tres.up, tres.dn, tres.wts, tres.energies)
    res = run_hci(ts, eps_var=1e-4, eps_var_sched=[1e-4],
                  wf_cache_dir=str(tmp_path), verbose=False)
    assert res.n_iters == 0
    assert res.energies[0] == pytest.approx(jres.energies[0], abs=1e-12)
    np.testing.assert_array_equal(_u64(res.up), jres.up)
    np.testing.assert_allclose(res.diag, jres.diag, atol=1e-9)


def test_wf_eps_var_files_are_byte_identical(tmp_path, heg):
    js, jres, _, ts, tres, _ = heg
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jrefio.write_wf_eps_var(pj, jres.up, jres.dn, jres.wts, jres.energies)
    trefio.write_wf_eps_var(pt, tres.up, tres.dn, tres.wts, tres.energies)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    up, dn, wts, en = trefio.read_wf_eps_var(pj, ts.norb)
    assert up.dtype == np.int64
    np.testing.assert_array_equal(up.view(np.uint64), jres.up)
    np.testing.assert_array_equal(dn.view(np.uint64), jres.dn)
    np.testing.assert_array_equal(wts, jres.wts)
    np.testing.assert_array_equal(en, jres.energies)

    # 128-bit words with the top bit set, two states
    rng = np.random.default_rng(11)
    up = rng.integers(0, 2 ** 63, size=(40, 2), dtype=np.uint64)
    up |= np.uint64(1) << np.uint64(63)          # bit 63 and bit 127
    dn = rng.integers(0, 2 ** 63, size=(40, 2), dtype=np.uint64)
    wts, en = rng.standard_normal((40, 2)), rng.standard_normal(2)
    jrefio.write_wf_eps_var(pj, up, dn, wts, en)
    trefio.write_wf_eps_var(pt, torch.as_tensor(up.view(np.int64)),
                            dn.view(np.int64), torch.as_tensor(wts), en)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    up2, dn2, wts2, en2 = trefio.read_wf_eps_var(pt, 128)
    assert (up2 < 0).all()
    np.testing.assert_array_equal(up2.view(np.uint64), up)
    np.testing.assert_array_equal(dn2.view(np.uint64), dn)
    np.testing.assert_array_equal(wts2, wts)
    with pytest.raises(ValueError, match="beyond norb"):
        trefio.read_wf_eps_var(pt, 64)
    with open(pt, "wb") as f:
        f.write(b"\x04\x00\x00\x00abcd\x05\x00\x00\x00")
    with pytest.raises(IOError, match="corrupt"):
        trefio.read_wf_eps_var(pt, 64)


def test_text_artifacts_are_byte_identical(tmp_path, heg):
    js, _, jtrial, ts, _, ttrial = heg
    n = (ts.nup, ts.ndn, ts.norb)
    pj, pt = str(tmp_path / "psit_j"), str(tmp_path / "psit_t")
    jrefio.write_psit_connections(pj, jtrial.ct_up, jtrial.ct_dn,
                                  jtrial.ct_num, jtrial.ct_den, *n)
    trefio.write_psit_connections(pt, ttrial.ct_up, ttrial.ct_dn,
                                  ttrial.ct_num, ttrial.ct_den, *n)
    assert open(pj).read() == open(pt).read()
    dj, dt = jrefio.read_psit_connections(pj, *n), \
        trefio.read_psit_connections(pt, *n)
    for k in dj:
        a = dt[k].view(np.uint64) if k.endswith(("_up", "_dn")) else dt[k]
        np.testing.assert_array_equal(a, dj[k], err_msg=k)

    qj, qt = str(tmp_path / "dtm_j"), str(tmp_path / "dtm_t")
    jrefio.write_dtm_projector(qj, jtrial.imp_up, jtrial.imp_dn,
                               jtrial.imp_ham, *n, energy=-1.25)
    trefio.write_dtm_projector(qt, ttrial.imp_up, ttrial.imp_dn,
                               ttrial.imp_ham, *n, energy=-1.25)
    assert open(qj).read() == open(qt).read()
    iu, idn, H = trefio.read_dtm_projector(qj, *n, device="cpu")
    ju, jdn, JH = jrefio.read_dtm_projector(qj, *n)
    np.testing.assert_array_equal(iu.view(np.uint64), ju)
    np.testing.assert_array_equal(idn.view(np.uint64), jdn)
    for k in ("rows", "cols", "vals", "diag"):
        np.testing.assert_array_equal(getattr(H, k).numpy(), getattr(JH, k),
                                      err_msg=k)
    assert H.n == JH.n and H.rows.dtype == torch.int64


@pytest.mark.parametrize("with_dtm", [True, False])
def test_load_trial_from_reference_matches_jax(tmp_path, heg, with_dtm):
    js, _, jtrial, ts, _, ttrial = heg
    n = (ts.nup, ts.ndn, ts.norb)
    pc, pd_ = str(tmp_path / "psit_connections"), str(tmp_path / "dtm")
    trefio.write_psit_connections(pc, ttrial.ct_up, ttrial.ct_dn,
                                  ttrial.ct_num, ttrial.ct_den, *n)
    trefio.write_dtm_projector(pd_, ttrial.imp_up, ttrial.imp_dn,
                               ttrial.imp_ham, *n)
    args = (pc, pd_) if with_dtm else (pc, None, 5)
    a = load_trial_from_reference(ts, *args)
    b = j_load_trial_from_reference(js, *args)
    for k in ("psit_up", "psit_dn", "ct_up", "ct_dn", "imp_up", "imp_dn"):
        np.testing.assert_array_equal(_u64(getattr(a, k)), getattr(b, k),
                                      err_msg=k)
    for k in ("psit_coef", "ct_num", "ct_den"):
        np.testing.assert_allclose(getattr(a, k).numpy(), getattr(b, k),
                                   rtol=0, atol=1e-14, err_msg=k)
    assert a.e_trial == pytest.approx(b.e_trial, abs=1e-14)

    def dense(h, conv):
        m = np.zeros((h.n, h.n))
        m[conv(h.rows), conv(h.cols)] = conv(h.vals)
        return m + m.T + np.diag(conv(h.diag))

    np.testing.assert_allclose(dense(a.imp_ham, lambda x: x.numpy()),
                               dense(b.imp_ham, np.asarray), rtol=0,
                               atol=1e-12)
    assert len(a.imp_up) == (8 if with_dtm else 5)
    assert bool((a.imp_ham.rows < a.imp_ham.cols).all())


def test_write_walkalize_line_for_line(tmp_path):
    rng = np.random.default_rng(0)
    n = 57
    w_abs = rng.random(n) * 1e5
    e_gen = rng.standard_normal(n) * 10
    nwalk = rng.integers(1, 10 ** 6, n)
    rw = 0.5 + rng.random(n)
    pj, pt, pa = (str(tmp_path / x) for x in "jta")
    jblocking.write_walkalize(pj, w_abs, e_gen, nwalk, rw)
    tblocking.write_walkalize(pt, w_abs, e_gen, nwalk, rw)
    lines = open(pj).read().splitlines()
    assert open(pt).read().splitlines() == lines and len(lines) == n
    # written block by block, as run_walk does
    for beg in range(0, n, 20):
        sl = slice(beg, beg + 20)
        tblocking.write_walkalize(pa, w_abs[sl], e_gen[sl],
                                  nwalk[sl].astype(np.float64), rw[sl],
                                  start=beg, append=beg > 0)
    assert open(pa).read().splitlines() == lines


def test_run_walk_writes_the_walkalize_trace(tmp_path, heg):
    js, _, _, ts, _, ttrial = heg
    cfg = WalkConfig(mwalk=4096, cap_spawn=4096, norb=ts.norb, nup=2, ndn=2,
                     n_words=1, tau=5e-3, w_abs_target=400.0, has_singles=False)
    path = tmp_path / "walkalize"
    path.write_text("stale\n")
    out = run_walk(ts, ttrial, cfg, nstep=10, nblk=2, nblk_eq=1,
                   w_abs_begin=300.0, e_trial_initial=ttrial.e_trial,
                   verbose=False, max_eq_extensions=0,
                   walkalize_file=str(path))
    rows = [line.split() for line in path.read_text().splitlines()]
    assert len(rows) == 30 and all(len(r) == 5 for r in rows)
    assert [int(r[0]) for r in rows] == list(range(1, 31))
    np.testing.assert_allclose([float(r[2]) for r in rows], out.w_abs_trace,
                               rtol=1e-6)
    np.testing.assert_array_equal([int(r[4]) for r in rows], out.nwalk_trace)
    assert float(rows[0][1]) == pytest.approx(1.0)          # 1 / reweight
    assert all(np.isfinite(float(r[3])) for r in rows)
    # the last measured generations' energies are near the trial's
    assert abs(float(rows[-1][3]) - ttrial.e_trial) < 0.5
