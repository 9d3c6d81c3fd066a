"""Walk cells whose dets are too wide for the walk judge's one int64 key
(more than 31 orbitals, up to 62, one word a spin): the walk driver
unchanged, its outputs with the electron gas's basis added, and the
judge of reference/judge_walk_wide.py, which keys a det on its pair of
words and enumerates the PT's momentum-conserving doubles from the
gas's k-vectors.  The traffic's kind is "walk_wide"; the run's kind
stays "walk", so the faults and the per-layer readers apply as they are.
"""

from __future__ import annotations

from benchmark.drivers import walk
from benchmark.reference import judge_walk_wide


class Driver(walk.Driver):
    kind = "walk"

    def outputs(self) -> dict:
        out = super().outputs()
        out["basis"] = {"n_dim": self.config["n_dim"],
                        "cutoff_radius": self.config["cutoff_radius"]}
        return out


def judge(H, outputs: dict, control: dict | None = None,
          info: dict | None = None) -> dict:
    return judge_walk_wide.numbers(H, outputs, control, info)
