"""The port's multi-rank layer (sqmc_tpu_torch/parallel/dist.py) against
the JAX package's sqmc_tpu/parallel/dist.py.

The JAX side runs on the virtual CPU devices of tests/conftest.py; the
port's ranks are processes joined by gloo (parallel.dist.spawn, one torch
thread each), whose bodies live in tests/torch_dist_ranks.py (no jax in
the ranks).  Module fixtures spawn each world once and the tests read
their results.  The owner hash and the shard layouts are exact; the
spawn routing and the distributed dedup are exact; the sharded matvec and
Davidson differ from the serial ones only in the order of the sums
(1e-9 / 1e-8, the JAX package's own tolerances); HCI over 1, 2 and 4 ranks
selects the serial dets with the serial energies (1e-10); PT over a mesh
equals serial PT to 1e-12 (relative for the deterministic sum, absolute
for the semistochastic difference, with the same sample count)."""

import os

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as ranks
from sqmc_tpu.algo import davidson as JDav
from sqmc_tpu.algo.sparseham import SparseHam as JSparseHam
from sqmc_tpu.ops import setalg as jsetalg
from sqmc_tpu.parallel import dist as JD
from sqmc_tpu_torch.algo.hci import run_hci
from sqmc_tpu_torch.algo.pt import second_order_pt, second_order_pt_alias
from sqmc_tpu_torch.algo.sparseham import build_sparse_ham
from sqmc_tpu_torch.ops import setalg
from sqmc_tpu_torch.parallel import dist
from sqmc_tpu_torch.systems.heg.system import make_heg_system

torch.set_num_threads(1)
SIGN = np.uint64(1 << 63)


def _words(rng, n, W):
    """Random det words with bit 63 set in about half of them."""
    w = rng.integers(0, 1 << 62, size=(n, W), dtype=np.int64).view(np.uint64)
    return w | np.where(rng.random((n, W)) < 0.5, SIGN, np.uint64(0))


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_det_owner_matches_jax(n_dev):
    rng = np.random.default_rng(n_dev)
    for W in (1, 2):
        up, dn = _words(rng, 4000, W), _words(rng, 4000, W)
        ref = JD.det_owner_np(up, dn, n_dev)
        np.testing.assert_array_equal(
            np.asarray(JD.det_owner_jnp(jax.numpy.asarray(up),
                                        jax.numpy.asarray(dn), n_dev)), ref)
        np.testing.assert_array_equal(dist.det_owner_np(up, dn, n_dev), ref)
        got = dist.det_owner(torch.as_tensor(up.view(np.int64)),
                             torch.as_tensor(dn.view(np.int64)), n_dev)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        assert (up[:, -1] >= SIGN).any()


@pytest.fixture(scope="module")
def heg4_trial():
    from sqmc_tpu.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu.systems.heg.system import make_heg_system as j_heg
    s = j_heg(3, 1.0, 4, 2, 1.6)
    return build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=40,
                                    verbose=False)


@pytest.mark.parametrize("n_dev", [3, 4])
def test_shard_layouts_match_jax(heg4_trial, n_dev):
    """shard_imp_space, _blockell_local and shard_initial_state equal the
    JAX package's (words compared as uint64 bits)."""
    t = heg4_trial
    ref = JD.shard_imp_space(t.imp_up, t.imp_dn, t.imp_ham, n_dev)
    got = dist.shard_imp_space(t.imp_up.view(np.int64),
                               t.imp_dn.view(np.int64), t.imp_ham, n_dev)
    assert got[5] == ref[5]
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g.view(np.uint64), r)
    for g, r in zip(got[2:5], ref[2:5]):
        np.testing.assert_array_equal(g, r)
    m = ref[5]
    for d in range(n_dev):
        jr = JD._blockell_local(m, ref[2][d], ref[3][d], ref[4][d], d * m)
        tr = dist._blockell_local(m, got[2][d], got[3][d], got[4][d], d * m)
        for k in range(3):
            np.testing.assert_array_equal(tr[k], jr[k])
        np.testing.assert_array_equal(tr[5], jr[3])
    rng = np.random.default_rng(1)
    n = len(t.imp_up)
    args = (rng.normal(size=n), rng.integers(0, 3, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int32), n_dev, 64)
    ref = JD.shard_initial_state(t.imp_up, t.imp_dn, *args)
    got = dist.shard_initial_state(t.imp_up.view(np.int64),
                                   t.imp_dn.view(np.int64), *args)
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.view(np.uint64) if k < 2 else g, r)


def _route_case(rng, n_dev, cap, skew):
    """Per-rank spawn slots [n_dev, cap]: owners (skewed towards rank 0
    when `skew`), a valid mask and payloads of every width."""
    p = np.full(n_dev, 1.0 / n_dev)
    if skew:
        p = np.array([0.7] + [0.3 / (n_dev - 1)] * (n_dev - 1))
    owner = rng.choice(n_dev, size=(n_dev, cap), p=p).astype(np.int32)
    valid = rng.random((n_dev, cap)) < (0.8 if skew else 0.5)
    arrays = dict(up=_words(rng, n_dev * cap, 2).reshape(n_dev, cap, 2),
                  dn=_words(rng, n_dev * cap, 2).reshape(n_dev, cap, 2),
                  wt=rng.normal(size=(n_dev, cap)),
                  f=rng.normal(size=(n_dev, cap)).astype(np.float32),
                  imp=rng.integers(-2, 127, (n_dev, cap)).astype(np.int32),
                  init=rng.integers(0, 4, (n_dev, cap)).astype(np.int32))
    return dict(owner=owner, valid=valid, arrays=arrays)


def _jax_route(case, n_dev):
    keys = sorted(case["arrays"])
    mesh = JD.make_mesh(n_dev)

    def local(o, v, *arrs):
        out, vm, ovf = JD.route_spawns("d", n_dev, o[0], v[0],
                                       {k: a[0] for k, a in zip(keys, arrs)})
        return tuple(out[k][None] for k in keys) + (vm[None], ovf[None])

    spec = P("d")
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,) * (2 + len(keys)),
                           out_specs=(spec,) * (2 + len(keys)),
                           check_vma=False))
    res = fn(case["owner"], case["valid"], *(case["arrays"][k] for k in keys))
    return ({k: np.asarray(res[i]) for i, k in enumerate(keys)},
            np.asarray(res[-2]), np.asarray(res[-1]))


@pytest.fixture(scope="module")
def heg14_2e3():
    """The port's HCI on the 14-electron gas at eps_var 2e-3 and its H."""
    s = make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu")
    res = run_hci(s, eps_var=2e-3, eps_var_sched=[2e-3] * 5, verbose=False)
    H = build_sparse_ham(s.table, res.up, res.dn, s.nup, s.ndn, s.norb)
    return s, res, H


@pytest.fixture(scope="module")
def four_ranks(heg14_2e3):
    """One 4-rank world: spawn routing (balanced and overflowing), the
    distributed dedup and the sharded matvec / Davidson."""
    rng = np.random.default_rng(0)
    cases = [_route_case(rng, 4, 64, skew=False),
             _route_case(rng, 4, 64, skew=True)]
    # the inputs of tests/test_sharded_davidson.py's dedup test
    rng5 = np.random.default_rng(5)
    up = rng5.integers(0, 1 << 20, size=(5000, 1)).astype(np.uint64)
    dn = rng5.integers(0, 1 << 20, size=(5000, 1)).astype(np.uint64)
    up[::3], dn[::3] = up[0], dn[0]
    _, _, H = heg14_2e3
    ham = dict(n=H.n, rows=H.rows.numpy(), cols=H.cols.numpy(),
               vals=H.vals.numpy(), diag=H.diag.numpy())
    v = np.random.default_rng(0).normal(size=(H.n, 2))
    outs = dist.spawn(ranks.primitives, 4, device="cpu", args=(
        cases, up.view(np.int64), dn.view(np.int64), ham, v))
    return dict(cases=cases, up=up, dn=dn, ham=ham, v=v, outs=outs)


@pytest.mark.parametrize("which", ["balanced", "overflowing"])
def test_route_spawns_matches_jax(four_ranks, which):
    """route_spawns at 4 ranks equals the JAX package's inside shard_map
    on make_mesh(4) row for row, valid mask and overflow flag included;
    the overflowing case drops exactly the spawns past each full bucket."""
    k = ["balanced", "overflowing"].index(which)
    case = four_ranks["cases"][k]
    ref, ref_v, ref_ovf = _jax_route(case, 4)
    assert bool(ref_ovf.any()) == (which == "overflowing")
    for r, out in enumerate(four_ranks["outs"]):
        got, got_v, got_ovf = out["routed"][k]
        np.testing.assert_array_equal(got_v, ref_v[r])
        assert got_ovf == bool(ref_ovf[r])
        for name, a in ref.items():
            g = got[name]
            if a.dtype == np.uint64:
                g = g.view(np.uint64)
            np.testing.assert_array_equal(g.view(np.uint8), a[r].view(np.uint8))


def test_sharded_unique_dets_equals_unique(four_ranks):
    """The inputs of tests/test_sharded_davidson.py: every rank ends with
    the list of setalg.unique_dets (the JAX package's and the port's)."""
    up, dn = four_ranks["up"], four_ranks["dn"]
    ref_u, ref_d, _, _ = jsetalg.unique_dets(up, dn)
    pu, pd, _, _ = setalg.unique_dets(torch.as_tensor(up.view(np.int64)),
                                      torch.as_tensor(dn.view(np.int64)))
    np.testing.assert_array_equal(pu.numpy().view(np.uint64), ref_u)
    for out in four_ranks["outs"]:
        u, d = out["uniq"]
        np.testing.assert_array_equal(u.view(np.uint64), ref_u)
        np.testing.assert_array_equal(d.view(np.uint64), ref_d)


def test_sharded_matvec_and_davidson_match_serial(four_ranks):
    """HEG-14 at eps_var 2e-3: y = H v at 4 ranks within 1e-9 of the JAX
    package's serial COO matvec, Davidson's two energies within 1e-8 of
    its serial Davidson; every rank holds the same bits."""
    h = four_ranks["ham"]
    JH = JSparseHam(n=h["n"], rows=h["rows"], cols=h["cols"], vals=h["vals"],
                    diag=h["diag"])
    y_ser = np.asarray(JDav.matvec(JH, four_ranks["v"]))
    e_ser, _ = JDav.davidson(JH, n_states=2)
    outs = four_ranks["outs"]
    for out in outs:
        np.testing.assert_allclose(out["y"], y_ser, rtol=0, atol=1e-9)
        np.testing.assert_allclose(out["e"], e_ser, rtol=0, atol=1e-8)
        np.testing.assert_array_equal(out["y"], outs[0]["y"])
        np.testing.assert_array_equal(out["e"], outs[0]["e"])


@pytest.fixture(scope="module")
def serial_hci():
    """The port's serial HCI on the 14-electron gas at eps_var 1e-3 (9,475
    dets; its second iteration meets 22,680 candidates)."""
    s = make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu")
    return s, run_hci(s, eps_var=1e-3, eps_var_sched=[1e-3] * 5,
                      verbose=False)


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_run_hci_mesh_matches_serial(serial_hci, n_ranks, tmp_path):
    """run_hci(mesh=) on 1, 2 and 4 ranks: every rank selects the serial
    dets (every iteration's candidates go through the owner dedup, the
    first with ranks that hold no reference; H.n >= 200 through the
    sharded matvec) with the serial energy to 1e-10; the wavefunction
    cache (dump_wf_var) is written once and holds the same dets."""
    from sqmc_tpu_torch.utils.checkpoint import load_wf_var, wf_var_filename
    _, serial_hci = serial_hci
    outs = dist.spawn(ranks.hci, n_ranks, device="cpu",
                      args=(1e-3, str(tmp_path)))
    for up, dn, e, w in outs:
        np.testing.assert_array_equal(up, serial_hci.up.numpy())
        np.testing.assert_array_equal(dn, serial_hci.dn.numpy())
        np.testing.assert_allclose(e, serial_hci.energies, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(e, outs[0][2])
        np.testing.assert_array_equal(w, outs[0][3])
    cache = load_wf_var(wf_var_filename(1e-3, str(tmp_path)))
    np.testing.assert_array_equal(cache["up"], outs[0][0])
    np.testing.assert_array_equal(cache["energies"], outs[0][2])
    assert len(os.listdir(tmp_path)) == 1


def test_repair_overflow_on_one_rank_is_seen_by_every_rank():
    """Two ranks, a fresh buffer as large as the smaller rank's initial
    population: only the other rank's cache repair overflows.  The
    block's overflow flag is set on both ranks, and run_walk grows the
    capacities once on both and walks on in step (equal traces)."""
    outs = dist.spawn(ranks.repair_overflow, 2, device="cpu", timeout=180)
    counts = outs[0]["counts"]
    assert counts[0] != counts[1] and min(counts) > 0
    for o in outs:
        assert o["block_overflow"] and o["grows"] == 1
        assert o["e_mixed"] == outs[0]["e_mixed"]
        np.testing.assert_array_equal(o["w_abs"], outs[0]["w_abs"])
        np.testing.assert_array_equal(o["nwalk"], outs[0]["nwalk"])


def test_mesh_pt_equals_serial_pt(serial_hci):
    """tests/test_sharded_davidson.py's PT case (HEG-14 at eps_var 1e-3,
    deterministic part at 5e-6, 12 samples of 100 at eps_pt 2e-7, seed 7)
    over 2 ranks: the deterministic sum within 1e-12 relative with the
    same connection count, the semistochastic difference within 1e-12
    with the same sample count."""
    s, res = serial_hci
    e_var = float(res.energies[0])
    det_kw = dict(eps_pt=5e-6)
    pt_big, n_conn = second_order_pt(s, res.up, res.dn, res.wts[:, 0], e_var,
                                     verbose=False, **det_kw)
    alias_kw = dict(eps_pt=2e-7, eps_pt_big=5e-6, n_mc=100,
                    target_error=3e-5, pt_big=pt_big, seed=7,
                    max_samples=12, min_samples=12)
    ref = second_order_pt_alias(s, res.up, res.dn, res.wts[:, 0], e_var,
                                verbose=False, **alias_kw)
    outs = dist.spawn(ranks.pt, 2, device="cpu", args=(
        res.up.numpy(), res.dn.numpy(), res.wts[:, 0], e_var, det_kw,
        alias_kw))
    for e2, nc, diff, ns in outs:
        assert abs(e2 - pt_big) <= 1e-12 * abs(pt_big)
        assert nc == n_conn
        assert abs(diff - ref.pt_diff) < 1e-12
        assert ns == ref.n_samples == 12
    assert outs[0] == outs[1]


def test_dryrun_runs_on_two_cpu_ranks(tmp_path):
    """parallel/dryrun.py at a CPU test's depth over 2 gloo ranks: the
    synthetic C2-shaped file, the dry run's trial and knobs (capacities
    scaled 8 / 2), no overflow, finite and equal on both ranks."""
    from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump
    path = os.path.join(tmp_path, "FCIDUMP")
    write_c2_fcidump(path)
    outs = dist.spawn(ranks.dryrun, 2, device="cpu", args=(path,))
    for o in outs:
        assert o["grows"] == 0 and np.isfinite(o["e_mixed"])
        assert o["transport"] == "gloo" and o["size"] == 2
        assert o["e_mixed"] == outs[0]["e_mixed"]
        assert o["nwalk"] == outs[0]["nwalk"] > 0


def test_spawn_reports_a_failing_rank():
    """A rank that raises fails the call with its traceback; the other
    ranks are stopped."""
    with pytest.raises(RuntimeError, match="rank 1"):
        dist.spawn(ranks.fail_on_rank_one, 2, device="cpu", timeout=120)


def test_make_mesh_joins_the_world_it_is_in(four_ranks):
    """Inside a rank, make_mesh returns the joined group's rank and size;
    asked for another number of devices it raises instead of going on."""
    for r, out in enumerate(four_ranks["outs"]):
        assert out["mesh"] == (r, 4, "gloo", True)


def test_spawn_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """spawn's ranks take the card by default: with no CUDA device it
    raises before starting a process and names device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.spawn(ranks.fail_on_rank_one, 2, timeout=60)


def test_make_mesh_refuses_what_it_cannot_run():
    with pytest.raises(ValueError):
        dist.make_mesh("cpu", backend="nccl")
    with pytest.raises(ValueError):
        dist.make_mesh("cpu", backend="mpi")
