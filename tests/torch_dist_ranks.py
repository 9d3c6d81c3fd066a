"""Rank bodies of the port's multi-rank CPU tests (tests/test_torch_dist.py,
tests/test_torch_dist_trace.py).

sqmc_tpu_torch.parallel.dist.spawn starts every rank in a fresh process
that imports the module of the function it runs, by name: this module
imports neither jax nor sqmc_tpu, so the ranks do not either.  Inputs
arrive as numpy arrays made by the tests; results go back as numpy."""

import numpy as np
import torch

from sqmc_tpu_torch.parallel import dist


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def primitives(mesh, route_cases, uniq_up, uniq_dn, ham, v):
    """route_spawns on this rank's slice of each case; sharded_unique_dets
    of one replicated candidate list; the sharded matvec and Davidson of
    one replicated H."""
    from sqmc_tpu_torch.algo.davidson import davidson
    from sqmc_tpu_torch.algo.sparseham import SparseHam
    r = mesh.rank
    routed = []
    for case in route_cases:
        arrays = {k: torch.as_tensor(a[r].view(np.int64) if a.dtype == np.uint64
                                     else a[r])
                  for k, a in case["arrays"].items()}
        out, vmask, ovf = dist.route_spawns(
            mesh, torch.as_tensor(case["owner"][r]),
            torch.as_tensor(case["valid"][r]), arrays)
        routed.append(({k: _np(x) for k, x in out.items()}, _np(vmask),
                       bool(ovf)))
    u, d = dist.sharded_unique_dets(mesh, uniq_up, uniq_dn)
    H = SparseHam(n=ham["n"], **{k: torch.as_tensor(ham[k])
                                 for k in ("rows", "cols", "vals", "diag")})
    mv = dist.make_sharded_matvec(H, mesh)
    y = mv(torch.as_tensor(v))
    e, _ = davidson(H, n_states=2, matvec_fn=mv)
    again = dist.make_mesh("cpu")
    try:
        dist.make_mesh("cpu", n_devices=mesh.size + 1)
        refused = False
    except RuntimeError:
        refused = True
    return dict(routed=routed, uniq=(_np(u), _np(d)), y=_np(y), e=e,
                mesh=(again.rank, again.size, again.transport, refused))


def hci(mesh, eps, cache_dir=None):
    """run_hci over the mesh on the 14-electron gas (writing its cache to
    cache_dir when one is given)."""
    from sqmc_tpu_torch.algo.hci import run_hci
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    s = make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu")
    res = run_hci(s, eps_var=eps, eps_var_sched=[eps] * 5, verbose=False,
                  mesh=mesh, wf_cache_dir=cache_dir,
                  dump_wf_var=cache_dir is not None)
    return _np(res.up), _np(res.dn), res.energies, res.wts


def pt(mesh, up, dn, wts, e_var, det_kw, alias_kw):
    """Deterministic and semistochastic PT over the mesh on the
    14-electron gas."""
    from sqmc_tpu_torch.algo.pt import second_order_pt, second_order_pt_alias
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    s = make_heg_system(3, 0.5, 14, 7, 1.49, device="cpu")
    up, dn = torch.as_tensor(up), torch.as_tensor(dn)
    e2, n_conn = second_order_pt(s, up, dn, wts, e_var, verbose=False,
                                 mesh=mesh, **det_kw)
    res = second_order_pt_alias(s, up, dn, wts, e_var, verbose=False,
                                mesh=mesh, **alias_kw)
    return e2, n_conn, res.pt_diff, res.n_samples


KEYS = ("e_num_gen", "e_den_gen", "w_abs_gen", "nwalk")


def _trace(step, state, tables, nstep):
    rows = []
    for _ in range(nstep):
        state, st = step(state, tables)
        rows.append([float(st[k]) for k in KEYS])
    return np.asarray(rows)


def walks(mesh, lattice, jax_runs, stoch):
    """Deterministic-limit traces of the sharded walk on the 2x3 lattice
    (from the JAX package's sharded state and from the port's own), two
    same-seed stochastic traces, and a stochastic walk of the 4-electron
    gas against its FCI energy."""
    from types import SimpleNamespace
    from sqmc_tpu_torch import convert
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    from sqmc_tpu_torch.systems.hubbard.system import make_hubbard_real_system
    system = make_hubbard_real_system(*lattice["args"], pbc=False,
                                      device="cpu")
    trial = convert.trial_from_npz(lattice["trial"], device="cpu")
    out = {}
    for name, run in jax_runs.items():
        cfg = WalkConfig(**run["cfg"])
        step, own_state, tables = dist.make_sharded_walk(
            system, trial, cfg, mesh, run["w_begin"], run["e_trial"])
        st, tb = convert.sharded_walk_from_numpy(
            SimpleNamespace(**run["state"]), SimpleNamespace(**run["tables"]),
            mesh.rank, mesh.size, tables, f32_state=cfg.f32_state)
        out[name] = _trace(step, st, tb, run["nstep"])
        out[name + "_own"] = _trace(step, own_state, tables, run["nstep"])

    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=10,
                                     verbose=False)
    cfg = WalkConfig(norb=s.norb, nup=2, ndn=2, n_words=1, has_singles=False,
                     axis_name="d", n_dev=mesh.size, **stoch["cfg"])
    for rep in range(2):
        step, state, tables = dist.make_sharded_walk(
            s, trial, cfg, mesh, stoch["w_begin"], trial.e_trial, seed=3)
        out[f"same_seed_{rep}"] = _trace(step, state, tables,
                                         stoch["same_seed_steps"])
    step, state, tables = dist.make_sharded_walk(
        s, trial, cfg, mesh, stoch["w_begin"], trial.e_trial, seed=5)
    res = run_walk(s, trial, cfg, w_abs_begin=stoch["w_begin"],
                   e_trial_initial=stoch["e_trial"], tables=tables,
                   state=state, verbose=False, seed=5, **stoch["run"])
    out["stochastic"] = (res.e_mixed, res.e_err, res.capacity_grows,
                         int(state.nwalk))
    return out


def heg4_walk(mesh):
    """The 4-electron gas's sharded walk on this mesh: (system, trial,
    cfg) with the tests' stochastic knobs."""
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig
    from sqmc_tpu_torch.systems.heg.system import make_heg_system
    s = make_heg_system(3, 1.0, 4, 2, 1.6, device="cpu")
    trial = build_trial_wavefunction(s, eps_var=1e-3, n_psi_t=30, n_imp=10,
                                     verbose=False)
    cfg = WalkConfig(norb=s.norb, nup=2, ndn=2, n_words=1, has_singles=False,
                     mwalk=256, cap_spawn=1024, tau=5e-3, w_abs_target=1000.0,
                     axis_name="d", n_dev=mesh.size)
    return s, trial, cfg


def repair_overflow(mesh):
    """make_sharded_walk hands every walker over with its diagonal
    unknown, so the first block repairs them all through the fresh
    buffer.  With cap_fresh equal to the smaller rank's population only
    the larger rank's repair overflows: the block's overflow flag, and
    run_walk's capacity growth, must still be the same on every rank."""
    import dataclasses
    from sqmc_tpu_torch.algo.walk import run_walk, walk_block
    s, trial, cfg = heg4_walk(mesh)
    _, state, tables = dist.make_sharded_walk(s, trial, cfg, mesh, 500.0,
                                              trial.e_trial, seed=3)
    counts = [int(x) for x in mesh.all_gather(
        state.nwalk.reshape(1).to(torch.int64)).tolist()]
    cfg = dataclasses.replace(cfg, cap_fresh=min(counts))
    gen = torch.Generator().manual_seed(dist.rank_seed(3, mesh.rank))
    out, _ = walk_block(state, tables, cfg, 2, gen)
    res = run_walk(s, trial, cfg, nstep=5, nblk=2, nblk_eq=1,
                   w_abs_begin=500.0, e_trial_initial=trial.e_trial,
                   tables=tables, state=state, verbose=False, seed=3,
                   max_eq_extensions=0)
    return dict(counts=counts, block_overflow=bool(out.overflow),
                grows=res.capacity_grows, e_mixed=res.e_mixed,
                w_abs=res.w_abs_trace, nwalk=res.nwalk_trace)


def fail_on_rank_one(mesh):
    """Rank 1 raises while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.all_reduce(torch.ones(1))


def dryrun(mesh, fcidump):
    """The dry run at a depth a CPU test affords, without the golden."""
    from sqmc_tpu_torch.parallel.dryrun import dryrun_rank
    return dryrun_rank(mesh, fcidump, nblk=2, nstep=4, nblk_eq=1, gate=False)
