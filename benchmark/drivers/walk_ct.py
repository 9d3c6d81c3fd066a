"""Walk cells of the continuous-time exponential projector (the
upstream's move_uniform_exponential_projector): the walk driver
unchanged -- the traffic's `walk` knobs turn the deterministic projection
off and the CT chain on -- and the judge of reference/judge_walk_ct.py,
which holds no D-space projector, since the walk projects nothing
deterministically.  The trial still builds D: E_ref is worked out over
it.  The traffic's kind is "walk_ct"; the run's kind stays "walk", so
the faults and the per-layer readers apply as they are.
"""

from __future__ import annotations

from benchmark.drivers import walk
from benchmark.reference import judge_walk_ct


class Driver(walk.Driver):
    kind = "walk"


def judge(H, outputs: dict, control: dict | None = None,
          info: dict | None = None) -> dict:
    return judge_walk_ct.numbers(H, outputs, control, info)
