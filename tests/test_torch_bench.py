"""The port's two top-level entry points on the CPU, at a test's size:
``sqmc_tpu_torch/bench.py`` (the counterpart of ``bench.py``) and
``sqmc_tpu_torch/entry.py`` (the counterpart of ``__graft_entry__.py``),
on the synthetic C2-shaped FCIDUMP that both packages read.  The trial of
``entry()`` is held to the JAX package's, ``entry()``'s generation to the
shapes and dtypes of ``__graft_entry__``'s, the bench's record to
``bench.py``'s keys; without a card both refuse to run."""

import ast
import functools
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sqmc_tpu_torch import bench, entry
from sqmc_tpu_torch.systems.chem.synthetic import write_c2_fcidump

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=1)
def _fcidump():
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix="bench_c2_"), "FCIDUMP")
    write_c2_fcidump(path)
    return path


@functools.lru_cache(maxsize=1)
def _jax_small_c2():
    """__graft_entry__._small_c2's system and trial, on the synthetic file."""
    from sqmc_tpu.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu.systems.base import make_chem_system
    system = make_chem_system(_fcidump())
    return system, build_trial_wavefunction(system, eps_var=2e-2, n_psi_t=50,
                                            n_imp=100, verbose=False)


def _words(x):
    return np.asarray(x).view(np.uint64)


def test_entry_trial_matches_jax():
    """entry()'s trial (parallel.dryrun.small_c2: HCI at eps_var 2e-2,
    Psi_T 50 dets, D up to 100) equals the JAX package's at
    __graft_entry__'s knobs on the same file: the same D and Psi_T dets in
    the same order, e_trial within 1e-10."""
    from sqmc_tpu_torch.parallel.dryrun import small_c2
    _, ref = _jax_small_c2()
    _, got = small_c2(_fcidump(), "cpu")
    for k in ("imp_up", "imp_dn", "psit_up", "psit_dn"):
        a, b = _words(getattr(got, k).numpy()), _words(getattr(ref, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    assert len(got.imp_up) == 100 and len(got.psit_up) == 50
    assert abs(got.e_trial - float(ref.e_trial)) < 1e-10


def test_entry_generation_has_graft_entry_shapes():
    """entry(device="cpu")'s fn runs one generation; its three outputs have
    the shapes and dtypes of __graft_entry__'s fn on the same file and
    knobs (the JAX step traced with jax.eval_shape, not run), the weights
    are finite and the population positive."""
    from sqmc_tpu.algo.walk import (WalkConfig, build_walk_tables,
                                    init_walk_state, walk_step)
    system, trial = _jax_small_c2()
    cfg = WalkConfig(mwalk=2048, cap_spawn=8192, norb=system.norb,
                     nup=system.nup, ndn=system.ndn, n_words=system.n_words,
                     tau=1e-3, w_abs_target=1000.0, has_singles=True)
    tables = build_walk_tables(system, trial)
    state = init_walk_state(cfg, trial, w_abs_begin=500.0,
                            e_trial_initial=trial.e_trial)

    def jax_fn(state):
        new_state, stats = walk_step(state, tables, cfg)
        return new_state.wt, stats["e_num_gen"], stats["w_abs_gen"]

    ref = jax.eval_shape(jax_fn, state)
    fn, args = entry.entry(device="cpu")
    got = fn(*args)
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in got] == \
        [(tuple(r.shape), str(r.dtype)) for r in ref]
    assert bool(torch.isfinite(got[0]).all()) and float(got[2]) > 0
    assert np.isfinite(float(got[1]))


def _bench_py_keys():
    """The keys of bench.py's record and of its "config" (:189-211)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "record"):
            keys = [k.value for k in node.value.keys]
            cfg = node.value.values[keys.index("config")]
            return keys, [k.value for k in cfg.keys]
    raise AssertionError("bench.py has no record literal")


def test_bench_record_has_bench_py_keys(tmp_path):
    """bench.run(device="cpu") at a tiny size returns a record with every
    key of bench.py's (and of its config), the device it ran on and its
    kernel launches (none on the CPU); a second run reads the cached
    trial and builds the same one."""
    keys, cfg_keys = _bench_py_keys()
    assert len(keys) == 15 and "value" in keys and "n_imp" in cfg_keys
    tiny = dict(eps_var=2e-2, n_psi_t=50, n_imp=100, mwalk=4096,
                cap_spawn=8192, w_abs_target=1000.0, w_abs_begin=1000.0,
                nstep=10, nblk=2, nblk_eq=1, max_eq_extensions=0)
    rec = bench.run(device="cpu", workdir=str(tmp_path), **tiny)
    assert set(keys) <= set(rec) and set(cfg_keys) <= set(rec["config"])
    assert rec["device"]["platform"] == "cpu"
    assert "c2" in rec["metric"] and "synthetic" in rec["metric"]
    assert rec["oracle_e0"] == bench.ORACLE_E0
    assert rec["config"]["measured_gens"] == 20
    assert not rec["config"]["trial_cached"]
    assert set(rec["launches"].values()) == {0}
    for k in ("value", "e_mixed", "pop", "nwalk", "gen_per_sec"):
        assert np.isfinite(rec[k]) and rec[k] != 0, k
    assert rec["bias_mHa"] == pytest.approx(
        1e3 * (rec["e_mixed"] - bench.ORACLE_E0))
    again = bench.run(device="cpu", workdir=str(tmp_path), **tiny)
    assert again["config"]["trial_cached"]
    assert again["config"]["n_imp"] == rec["config"]["n_imp"] == 100
    with pytest.raises(TypeError):
        bench.run(device="cpu", workdir=str(tmp_path), not_a_knob=1)


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """With no CUDA device the bench's command, bench.run, entry() and
    dryrun_multichip raise before doing any work: the CPU is used only when
    the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code not in (0, None)
    for call in (bench.run, entry.entry, lambda: entry.dryrun_multichip(2),
                 lambda: bench.oracle()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_bench_command_exits_nonzero_without_a_card():
    """`python -m sqmc_tpu_torch.bench` on a machine without a card exits
    nonzero and prints no record."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "sqmc_tpu_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
