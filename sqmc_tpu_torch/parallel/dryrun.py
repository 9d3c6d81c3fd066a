"""Multi-rank dry run of the determinant-sharded walk (port of
``__graft_entry__.dryrun_multichip`` / ``_sharded_blocks``).

The JAX dry run walks C2 from the C2_v2z_curve FCIDUMP, which is not in
the repository.  This one walks the synthetic C2-shaped FCIDUMP
(``systems/chem/synthetic.py``, seed 26, plain det basis) with the JAX
dry run's trial knobs (eps_var 2e-2, n_psi_t 50, n_imp 100) and walk knobs
(``DRYRUN``: population 4,000, tau 2e-3, granularity 2, min_wt 0.5,
r_initiator 0.5, f32 state, 30 equilibration + 30 measured blocks of 50
generations), per-rank capacities scaled as 8 / n, and holds e_mixed to
``GOLDEN_E`` within 4 combined sigma.  The golden is a long run of the
port's serial (unsharded) walk of the same physics on another seed, so
an n-rank bias cannot hide in a self-referential golden.

    python -m sqmc_tpu_torch.parallel.dryrun --ranks 2 [--device cuda]
        [--backend gloo]        # the dry run over a spawned mesh
    python -m sqmc_tpu_torch.parallel.dryrun --golden 600 [--device cuda]
                                # the serial golden run (600 blocks)
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

DRYRUN = dict(pop=4000.0, mwalk=2048, cap=4096, tau=2e-3, g=2.0,
              min_wt=0.5, r_init=0.5, nstep=50, nblk=30, nblk_eq=30)
# mwalk / cap are per rank at the JAX golden's 8 ranks; the global
# population target is n-independent, so per-rank capacities scale 8 / n
NDEV_REF = 8
# Golden: the serial walk (golden_walk: run_walk), 600 measured blocks of
# 50 generations after 30 equilibration blocks, seed 3, on an NVIDIA H100
# 80GB HBM3 at 700.00 W (`python -m sqmc_tpu_torch.parallel.dryrun
# --golden 600 --device cuda`; 6,446 occupied dets at the end)
GOLDEN_E = -75.87663732356019
GOLDEN_ERR = 0.00010284103283349517
FCIDUMP_NAME = "FCIDUMP_c2_synthetic"


def small_c2(fcidump: str, device):
    """The synthetic C2-shaped system (plain det basis) and the dry run's
    small trial wavefunction."""
    from ..algo.semistoch import build_trial_wavefunction
    from ..systems.base import make_chem_system
    system = make_chem_system(fcidump, device=device)
    trial = build_trial_wavefunction(system, eps_var=2e-2, n_psi_t=50,
                                     n_imp=100, verbose=False)
    return system, trial


def walk_config(system, n_ranks: int, **extra):
    """The dry run's WalkConfig for n_ranks (capacities per rank)."""
    from ..algo.walk import WalkConfig
    d = DRYRUN
    scale = max(1, NDEV_REF // n_ranks)
    return WalkConfig(mwalk=d["mwalk"] * scale, cap_spawn=d["cap"] * scale,
                      norb=system.norb, nup=system.nup, ndn=system.ndn,
                      n_words=system.n_words, tau=d["tau"],
                      w_abs_target=d["pop"], has_singles=True,
                      spawn_granularity=d["g"], min_wt=d["min_wt"],
                      r_initiator=d["r_init"], f32_state=True, **extra)


def sharded_walk(mesh, system, trial, nblk: int, nstep: int, nblk_eq: int,
                 seed: int):
    """The dry run's walk over `mesh` (every rank calls it): run_walk on
    make_sharded_walk's tables and state.  Returns the WalkResult."""
    from ..algo.walk import run_walk
    from .dist import make_sharded_walk
    cfg = walk_config(system, mesh.size, axis_name="d", n_dev=mesh.size)
    _, state, tables = make_sharded_walk(
        system, trial, cfg, mesh, w_abs_begin=DRYRUN["pop"],
        e_trial_initial=trial.e_trial, seed=seed)
    return run_walk(system, trial, cfg, nstep, nblk, nblk_eq, DRYRUN["pop"],
                    trial.e_trial, seed=seed, verbose=False,
                    max_eq_extensions=0, tables=tables, state=state)


def golden_walk(system, trial, nblk: int, nstep: int, nblk_eq: int,
                seed: int):
    """The same physics through the serial walk (no mesh, one process, the
    capacities of one rank): the golden's program."""
    from ..algo.walk import run_walk
    return run_walk(system, trial, walk_config(system, 1), nstep, nblk,
                    nblk_eq, DRYRUN["pop"], trial.e_trial, seed=seed,
                    verbose=False, max_eq_extensions=0)


def dryrun_rank(mesh, fcidump: str, seed: int = 0, nblk: int | None = None,
                nstep: int | None = None, nblk_eq: int | None = None,
                gate: bool = True) -> dict:
    """One rank of the dry run (the function :func:`dist.spawn` runs):
    build the system and trial, walk, check.  The depth defaults to
    DRYRUN's; `gate` holds e_mixed to the golden (4 combined sigma, at
    least 1e-4).  Returns the numbers it checked."""
    d = DRYRUN
    system, trial = small_c2(fcidump, mesh.device)
    res = sharded_walk(mesh, system, trial, nblk or d["nblk"],
                       nstep or d["nstep"],
                       d["nblk_eq"] if nblk_eq is None else nblk_eq, seed)
    out = dict(e_mixed=res.e_mixed, e_err=res.e_err,
               grows=res.capacity_grows, w_abs=float(res.w_abs_trace[-1]),
               nwalk=int(res.nwalk_trace[-1]), rank=mesh.rank,
               size=mesh.size, transport=mesh.transport)
    if res.capacity_grows:
        raise AssertionError("capacity/routing overflow in the dry run walk")
    if not (np.isfinite(out["w_abs"]) and np.isfinite(res.e_mixed)):
        raise AssertionError(f"non-finite dry run output: {out}")
    if gate:
        sig = max(float(np.hypot(res.e_err, GOLDEN_ERR)), 1e-4)
        out["sigma"] = abs(res.e_mixed - GOLDEN_E) / sig
        if out["sigma"] >= 4.0:
            raise AssertionError(
                f"sharded e_mixed {res.e_mixed:.6f} is {out['sigma']:.1f} "
                f"sigma from the golden {GOLDEN_E:.6f} (run err "
                f"{res.e_err:.6f}, golden err {GOLDEN_ERR:.6f})")
    return out


def main(argv=None):
    from ..systems.chem.synthetic import write_c2_fcidump
    from .dist import spawn
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--golden", type=int, default=0,
                    help="run the serial golden with this many blocks")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--workdir", default=os.path.join("build", "dryrun"))
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device")
    os.makedirs(a.workdir, exist_ok=True)
    fcidump = os.path.join(a.workdir, FCIDUMP_NAME)
    write_c2_fcidump(fcidump)
    if a.golden:
        system, trial = small_c2(fcidump, a.device)
        d = DRYRUN
        res = golden_walk(system, trial, a.golden, d["nstep"], d["nblk_eq"],
                          3 if a.seed is None else a.seed)
        print(f"dryrun golden: serial nblk={a.golden} nstep={d['nstep']} "
              f"nblk_eq={d['nblk_eq']} e_mixed={res.e_mixed!r} "
              f"e_err={res.e_err!r} capacity_grows={res.capacity_grows} "
              f"nwalk={int(res.nwalk_trace[-1])} "
              f"gen_per_s={res.steps_per_sec:.3f}", flush=True)
        return 1 if res.capacity_grows else 0
    outs = spawn(dryrun_rank, a.ranks, backend=a.backend, device=a.device,
                 args=(os.path.abspath(fcidump), a.seed or 0))
    o = outs[0]
    print(f"dryrun({a.ranks}) transport={o['transport']}: "
          f"e_mixed={o['e_mixed']:.6f} +- {o['e_err']:.6f} "
          f"golden={GOLDEN_E} +- {GOLDEN_ERR} ({o['sigma']:.1f} sigma) "
          f"nwalk={o['nwalk']} w_abs={o['w_abs']:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
