"""Top-level entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``).

:func:`entry` returns one FCIQMC generation of the main path as
``(fn, args)`` on the synthetic C2-shaped FCIDUMP
(``systems/chem/synthetic.py``, seed 26; ``__graft_entry__`` reads the
C2_v2z_curve file, which is not in the repository), at
``__graft_entry__``'s knobs.  :func:`dryrun_multichip` runs the
determinant-sharded dry run of ``parallel/dryrun.py`` over `n` ranks.
Both run on the card unless the caller asks for the CPU; the FCIDUMP is
written into ``build/entry/``.
"""

from __future__ import annotations

import os

import torch

from .bench import ROOT, resolve_device

WORKDIR = os.path.join(ROOT, "build", "entry")
WALK = dict(mwalk=2048, cap_spawn=8192, tau=1e-3, w_abs_target=1000.0,
            has_singles=True)
W_ABS_BEGIN = 500.0


def entry(device=None):
    """(fn, (state, tables)): one generation of the semistochastic
    initiator walk with heat-bath proposals and singles on the synthetic
    C2-shaped system, from the trial of HCI at eps_var 2e-2 (Psi_T 50
    dets, D up to 100; ``parallel.dryrun.small_c2``), mwalk 2,048,
    cap_spawn 8,192, tau 1e-3, population target 1,000 from 500, float64
    state (WalkConfig's default, as in ``__graft_entry__``), so the D-space
    projection runs through the SpMV kernel: a generation launches K1-K4.
    ``fn(state, tables)`` returns ``(new_state.wt, e_num_gen,
    w_abs_gen)``."""
    from .algo.walk import (WalkConfig, build_walk_tables, init_walk_state,
                            walk_step)
    from .parallel.dryrun import FCIDUMP_NAME, small_c2
    from .systems.chem.synthetic import write_c2_fcidump
    dev = resolve_device(device)
    os.makedirs(WORKDIR, exist_ok=True)
    fcidump = os.path.join(WORKDIR, FCIDUMP_NAME)
    write_c2_fcidump(fcidump)
    system, trial = small_c2(fcidump, dev)
    cfg = WalkConfig(norb=system.norb, nup=system.nup, ndn=system.ndn,
                     n_words=system.n_words, **WALK)
    tables = build_walk_tables(system, trial, cfg)
    state = init_walk_state(cfg, trial, W_ABS_BEGIN, trial.e_trial, tables)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def fn(state, tables):
        """One generation (``walk_step`` with the walk's own generator,
        which advances on every call): on the card one replay of the
        generation captured as a CUDA graph at the first call, between a
        copy of `state` into the graph's buffers and clones of the result.

        Host syncs on the card: ``repair_caches`` reads one flag
        (``bool(need.any())``) before the generation, and the first call
        synchronizes once to capture.  Nothing else waits for the card."""
        new_state, stats = walk_step(state, tables, cfg, gen)
        return new_state.wt, stats["e_num_gen"], stats["w_abs_gen"]

    return fn, (state, tables)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The determinant-sharded walk's dry run over `n_devices` ranks
    (``python -m sqmc_tpu_torch.parallel.dryrun --ranks n``): on the card
    by default, every rank on the one card through gloo; raises when a
    rank fails or the result misses its serial golden."""
    from .parallel import dryrun
    dev = resolve_device(device)
    if dryrun.main(["--ranks", str(int(n_devices)), "--device", dev.type,
                    "--workdir", os.path.join(ROOT, "build", "dryrun")]):
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed")
