"""Tiny traffic for the CPU checks: the cells' own code paths at sizes the
CPU runs in seconds (the cells' sizes run only on the card)."""

import time

# D of 100 dets (the HCI trial's n_imp, the cards trial's
# size_deterministic) and 300 generations of equilibration, so that the
# mixed energy has settled
WALK = {"trial": {"eps_var": 2e-2, "n_psi_t": 50, "n_imp": 100,
                  "size_deterministic": 100},
        "walk": {"mwalk": 4096, "cap_spawn": 8192, "w_abs_target": 1000.0},
        "run": {"nstep": 10, "eq_blocks": 30, "w_abs_begin": 1000.0,
                "trace_blocks": 1}}
# HCI at eps_var 2e-2 on the electron gas selects 277 dets with E_var
# 58.282596704912514 (the CPU's own result at this size, stated here as
# the configuration states 9,475 and 58.276906085)
SHCI = {"hci": {"eps_var": 2e-2, "eps_var_sched": [2e-2] * 10},
        "pt": {"eps_pt": 1e-4},
        "stated": {"ndets": 277, "e_var": 58.282596704912514}}
# At this size PT beyond D is -69 to -96 mHa, so the walk's energy gap is
# read against a limit of its own: sound runs read 0.005-7.6 mHa, the
# faults inside the generation 34-49 (half) and 70-100 (scaled) mHa (CPU
# readings of control.py at these sizes, 1 s windows)
WALK_LIMITS = {"energy_mHa": 15.0}
WALK_CELLS = ("c2.walk", "heg14.walk", "c2.walk-timesym")


def override(cell):
    return SHCI if cell.endswith("shci") else WALK


def run(cell, seed=20260001, seconds=1.0, trace=False, **kw):
    from benchmark import harness, registry
    return harness.run_cell(
        registry.Spec(), cell, seed, seconds, trace, "cpu", time.time(),
        traffic_override=override(cell),
        limits_override=None if cell.endswith("shci") else WALK_LIMITS,
        **kw)


def run_with_fault(cell, fault, seed=20260001, **kw):
    """One run with `fault` (faults.py) planted after set-up and the walk
    equilibrated again under it, as a program with the fault would run;
    the fault is taken out after the run."""
    undo = []

    def plant(drv):
        undo.append(fault(drv))
        drv.restart(seed)
    try:
        return run(cell, seed=seed, patch=plant, **kw)
    finally:
        for u in undo:
            u()
