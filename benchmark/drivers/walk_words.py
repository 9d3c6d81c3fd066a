"""Walk cells whose dets take several int64 words a spin (the electron gas
past 64 plane waves): the walk driver's set-up for any number of words,
its window unchanged, every word of every det in the snapshot and the
outputs, and the electron gas's basis, read by the judge of
reference/judge_walk_words.py.  The traffic's kind is "walk_words"; the
run's kind stays "walk", so the faults and the per-layer readers apply
as they are.
"""

from __future__ import annotations

import time

from benchmark.drivers import walk
from benchmark.reference import judge_walk_words


class Driver(walk.Driver):
    kind = "walk"

    def setup(self, spans: dict):
        from sqmc_tpu_torch.algo import walk as W
        self.W = W
        self.block_fn = W.walk_block    # the CPU checks plant faults here
        t0 = time.perf_counter()
        s = self.system = self.system_mod.program_system(
            self.config, self.traffic, self.device, self.workdir)
        self.sync()
        t1 = time.perf_counter()
        self.trial = walk._trial(s, self.traffic["trial"])
        self.sync()
        t2 = time.perf_counter()
        spans["system"], spans["trial"] = t1 - t0, t2 - t1
        self.cfg = W.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn,
                                n_words=s.n_words, has_singles=s.has_singles,
                                time_sym=s.time_sym, z=s.z,
                                **self.traffic["walk"])
        self.tables = W.build_walk_tables(s, self.trial, self.cfg)
        self.sync()
        spans["tables"] = time.perf_counter() - t2
        self.restart(self.seed, spans)

    def _snapshot(self):
        st = self.state
        n = int(st.nwalk)
        self.start = (st.up[:n].cpu(), st.dn[:n].cpu(), st.wt[:n].cpu())

    def outputs(self) -> dict:
        out = super().outputs()
        tr, tb, st = self.trial, self.tables, self.state
        c = lambda x: x.cpu()  # noqa: E731
        out.update(psit_up=c(tr.psit_up), psit_dn=c(tr.psit_dn),
                   imp_up=c(tb.imp_up), imp_dn=c(tb.imp_dn),
                   walk_up=c(st.up), walk_dn=c(st.dn),
                   basis={"n_dim": self.config["n_dim"],
                          "cutoff_radius": self.config["cutoff_radius"]})
        return out


def judge(H, outputs: dict, control: dict | None = None,
          info: dict | None = None) -> dict:
    return judge_walk_words.numbers(H, outputs, control, info)
