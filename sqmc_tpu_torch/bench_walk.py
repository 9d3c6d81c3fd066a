"""Generations per second of the HEG-14 walk on the card, f32 and f64 state.

    python sqmc_tpu_torch/bench_walk.py [--repo DIR] [--gens N] [--tag NAME]

Runs the 14-electron electron gas (3D, r_s = 0.5, 19 plane waves; HCI at
eps_var 1e-3, D = the 9,475 HCI dets, Psi_T its top 2,000) at the walk
knobs of chip_smoke.py's phases 3 and 5 (population 2e5, mwalk 458,752,
cap_spawn 262,144) for N generations after N / 2 of equilibration, in
float32 state (dense projector) and in float64 state (block-ELL SpMV
kernel), and prints one line per state with gen/s, the launches of both
kernels and the card's nvidia-smi name and power limit.

--repo DIR imports the package from DIR instead of the directory above
this file, so that two checkouts can be timed in one process-per-run
sequence on one card (old, new, new, old) with the same script.
"""

import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--gens", type=int, default=400)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    from sqmc_tpu_torch.algo.semistoch import build_trial_wavefunction
    from sqmc_tpu_torch.algo.walk import WalkConfig, run_walk
    from sqmc_tpu_torch.ops import segscan, spmv
    from sqmc_tpu_torch.systems.heg.system import make_heg_system

    if not torch.cuda.is_available():
        raise SystemExit("bench_walk: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    system = make_heg_system(3, 0.5, 14, 7, 1.49)
    trial = build_trial_wavefunction(system, eps_var=1e-3, n_psi_t=2000,
                                     n_imp=20000)
    nblk = max(1, args.gens // 100)
    for f32 in (True, False):
        cfg = WalkConfig(mwalk=458_752, cap_spawn=262_144, norb=system.norb,
                         nup=7, ndn=7, n_words=1, tau=2e-3, w_abs_target=2e5,
                         spawn_granularity=2.0, min_wt=0.5, r_initiator=0.5,
                         f32_state=f32, has_singles=False)
        segscan.reset_launches()
        spmv.reset_launches()
        out = run_walk(system, trial, cfg, nstep=100, nblk=nblk,
                       nblk_eq=max(1, nblk // 2), w_abs_begin=2e5,
                       e_trial_initial=trial.e_trial, verbose=False,
                       max_eq_extensions=0, seed=1)
        torch.cuda.synchronize()
        print(f"bench_walk {args.tag} {'f32' if f32 else 'f64'}: "
              f"measured_gens={out.n_measured} gen_per_s={out.steps_per_sec:.3f} "
              f"e_mixed={out.e_mixed:.9f} seg_scan_launches={segscan.launches} "
              f"spmv_launches={spmv.launches} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
