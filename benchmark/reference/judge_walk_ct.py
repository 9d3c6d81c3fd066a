"""The numbers that decide `correct` in a walk cell of the continuous-time
exponential projector, which walks with no deterministic space.

judge_walk.numbers' numbers, worked out by it, less what holds only where
the walk projects exactly on D:

  * `d_space` is dropped: the CT walk never multiplies by the D-space
    projector (the trial still builds D, over which E_ref is taken);
  * `walkers` leaves out its "a D det missing" count: nothing keeps a D
    det resident.  Every other broken row still counts.

`trial_energy`, `estimator`, `population`, `stale` and `energy_mHa`
(E_ref = the lowest eigenvalue of H over D + the screened EN-PT of that
eigenvector) are judge_walk's as they are.
"""

from __future__ import annotations

import torch

from . import judge_walk


def missing_d(H, out: dict) -> int:
    """The D dets that no walker holds at the close (judge_walk's count)."""
    dev = H.h.device
    t = lambda k: torch.as_tensor(out[k], device=dev)  # noqa: E731
    nw = int(out["nwalk"])
    keys = judge_walk._keys(t("walk_up")[:nw], t("walk_dn")[:nw])
    d = judge_walk._keys(t("imp_up"), t("imp_dn"))
    return int((judge_walk._member(d, keys) < 0).sum())


def numbers(H, out: dict, control: dict | None = None,
            info: dict | None = None) -> dict:
    """judge_walk.numbers without `d_space` and without the D-residence
    count in `walkers` (see above)."""
    res = judge_walk.numbers(H, out, control, info)
    del res["d_space"]
    res["walkers"] -= float(missing_d(H, out))
    return res
