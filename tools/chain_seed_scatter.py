#!/usr/bin/env python3
"""Seed scatter of the 1x8 open-chain fixed_node1 deck (2 + 2 electrons,
U/t = 4, Gutzwiller g = 0.7): is a walk that lands below the exact energy
biased, or is its blocking error bar too small?

The chain has no sign violator, so the fixed-node energy is the exact
e0 = -5.634427 and every unbiased engine must scatter around it.  Three
engines run the deck's configuration (tau 0.02, population 1,500 -> 3,000,
min_wt 0.5, 2 + 4 blocks of 100 generations), each over several seeds, on
the CPU:

  * the port's determinant walk, through its card front end
    (sqmc_tpu_torch.cli.run_from_config);
  * the port's dense-vector walk (algo/densewalk.py) on the enumerated
    784-det space, same guiding function, tau and population;
  * the JAX package's CLI (``python -m sqmc_tpu``) on the same deck, in
    subprocesses.

Prints one line per run and, per engine, the mean of e_mixed - e0, the
seed scatter (standard deviation over seeds), the standard error of the
mean, and the mean blocking error bar the runs reported themselves.

    python tools/chain_seed_scatter.py [--seeds 8] [--jax-seeds 4]
"""

import argparse
import dataclasses
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

DECK = """\
{seed} 5                               irand_seed
100 4 2 0                          nstep,nblk,nblk_eq,ipr
1500 3000 4096                     w_abs_gen_begin, w_abs_gen_target, MWALK
0.3 0.02                           tau_multiplier, tau
1. 2.                              reweight_factor_inv_max_multiplier, reweight_factor_inv_max
10. 0. 0.5                         population_control_expon, e_trial_initial, min_wt
fast_heatbath 1 0. 0 1.            proposal_method, importance_sampling, r_initiator, initiator_power, initiator_rescale_power
fixed_node1                        run_type
.false. f                          semistochastic, use_exponential_projector
0. 0.                              psi_g_energy, psi_g_epsilon
'hubbard2' 0                       hamiltonian_type,ipr
1 8                                l_x, l_y
f f                                pbc, neel_up_only
1. 4.                              t, U
2 2                                n_alpha, n_beta
gutz                               wf_type
0.7                                g
0                                  diagonalize_ham
"""


def summarize(name, e0, runs):
    d = np.array([e for e, _ in runs]) - e0
    errs = np.array([err for _, err in runs])
    n = len(d)
    scatter = float(np.std(d, ddof=1)) if n > 1 else float("nan")
    print(f"{name}: seeds={n} mean(e_mixed - e0)={d.mean():+.6f} "
          f"seed_scatter={scatter:.6f} sem={scatter / np.sqrt(n):.6f} "
          f"mean_blocking_err={errs.mean():.6f} "
          f"scatter/blocking={scatter / errs.mean():.2f}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--jax-seeds", type=int, default=4)
    args = ap.parse_args()

    import torch
    from sqmc_tpu_torch import cli
    from sqmc_tpu_torch.algo.densewalk import DenseWalkConfig, run_dense_walk
    from sqmc_tpu_torch.algo.guiding import (eval_guiding,
                                             make_gutzwiller_guiding)
    from sqmc_tpu_torch.config import parse_input
    from sqmc_tpu_torch.systems.hubbard.system import (
        enumerate_dets, make_hubbard_dense_system, make_hubbard_real_system)

    torch.set_num_threads(2)
    cfg0 = parse_input(DECK.format(seed=13))
    toy = make_hubbard_dense_system(1, 8, 1.0, 4.0, 2, 2, pbc=False,
                                    device="cpu")
    e0 = float(torch.linalg.eigvalsh(toy.ham)[0])
    print(f"e0={e0:.6f} ndet={toy.ndet}", flush=True)

    runs = []
    for k in range(args.seeds):
        cfg = dataclasses.replace(cfg0, seeds=(13 + 101 * k, 5))
        out = cli.run_from_config(cfg, verbose=False, device="cpu")
        runs.append((out.e_mixed, out.e_err))
        print(f"port det walk seed={cfg.seeds[0]}: e_mixed={out.e_mixed:.6f} "
              f"+- {out.e_err:.6f}", flush=True)
    summarize("port determinant walk", e0, runs)

    s = make_hubbard_real_system(1, 8, 1.0, 4.0, 2, 2, pbc=False, device="cpu")
    guide = make_gutzwiller_guiding(s, g=0.7)
    up, dn = (torch.as_tensor(x) for x in enumerate_dets(8, 2, 2))
    g = eval_guiding(guide, "gutzwiller", up, dn, 8, 2, 2)
    wcfg = DenseWalkConfig(ndet=toy.ndet, tau=cfg0.tau,
                           w_abs_target=cfg0.w_abs_target,
                           run_type="fixed_node1", importance_sampling=1,
                           min_wt=cfg0.min_wt)
    runs = []
    for k in range(args.seeds):
        out = run_dense_walk(toy, wcfg, g, g, nstep=cfg0.nstep,
                             nblk=cfg0.nblk + cfg0.nblk_eq,
                             nblk_eq=cfg0.nblk_eq,
                             w_abs_begin=cfg0.w_abs_begin,
                             e_trial_initial=e0, seed=13 + 101 * k)
        runs.append((out.e_mixed, out.e_err))
        print(f"port dense walk seed={13 + 101 * k}: e_mixed={out.e_mixed:.6f}"
              f" +- {out.e_err:.6f}", flush=True)
    summarize("port dense walk", e0, runs)

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(args.jax_seeds):
            deck = os.path.join(tmp, f"deck{k}")
            with open(deck, "w") as f:
                f.write(DECK.format(seed=13 + 101 * k))
            out = subprocess.run(
                [sys.executable, "-m", "sqmc_tpu", "-i", deck, "--cpu"],
                capture_output=True, text=True, cwd=tmp,
                env=dict(os.environ, PYTHONPATH=HERE, JAX_PLATFORMS="cpu"))
            m = re.search(r"e_mixed=\s*([-+0-9.]+)\s*\+-\s*([0-9.eE-]+)",
                          out.stdout)
            if out.returncode != 0 or not m:
                print(out.stderr[-2000:])
                raise SystemExit("the sqmc_tpu CLI failed")
            runs.append((float(m.group(1)), float(m.group(2))))
            print(f"jax cli seed={13 + 101 * k}: e_mixed={runs[-1][0]:.6f} "
                  f"+- {runs[-1][1]:.6f}", flush=True)
    if runs:
        summarize("sqmc_tpu CLI", e0, runs)


if __name__ == "__main__":
    main()
