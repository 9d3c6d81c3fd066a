"""Walk cells: sqmc_tpu_torch's semistochastic walk, driven block by block.

Set-up builds the system, the trial (Psi_T, C(T) and the D-space H, by
HCI or by the deck's trial cards), the walk's tables and the initial
state, then equilibrates: `eq_blocks` blocks of `nstep` generations with
the trial energy free, the first of which captures the generation's CUDA
graph.  The window then runs measured blocks (trial energy fixed) through
``walk.walk_block`` until `seconds` have passed; a block that overflows
the capacities grows them and runs again from its start, as the
program's own driver does, and its time stays in the window.

The traffic file holds the knobs: ``trial`` (how Psi_T and D are built),
``walk`` (WalkConfig's fields; "auto" capacities follow the reference
code's MWALK rule), ``run`` (nstep, eq_blocks, w_abs_begin, trace_blocks),
``precision`` (what the configuration states for the walker state and
the projector's entries) and ``reference`` (the eps_pt of the judge's
E_ref).
"""

from __future__ import annotations

import dataclasses
import time

from benchmark.reference import judge_walk, precision


def _trial(system, spec: dict):
    from sqmc_tpu_torch.algo import semistoch
    if spec["method"] == "hci":
        return semistoch.build_trial_wavefunction(
            system, eps_var=spec["eps_var"], n_psi_t=spec["n_psi_t"],
            n_imp=spec["n_imp"])
    if spec["method"] == "cards":
        return semistoch.build_trial_from_cards(
            system, spec["iterations"], spec["norb"], spec["initiators"],
            spec["truncate"], spec["size_deterministic"])
    raise ValueError(f"unknown trial method {spec['method']!r}")


class Driver:
    kind = "walk"

    def __init__(self, config, traffic, seed, device, workdir, system_mod):
        import torch
        self.torch = torch
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.workdir = seed, device, workdir
        self.system_mod = system_mod
        self.run = traffic["run"]
        self.nstep = self.run["nstep"]
        self.lost = 0

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    # -- set-up -------------------------------------------------------------
    def setup(self, spans: dict):
        from sqmc_tpu_torch.algo import walk as W
        self.W = W
        self.block_fn = W.walk_block    # the CPU checks plant faults here
        t0 = time.perf_counter()
        s = self.system = self.system_mod.program_system(
            self.config, self.traffic, self.device, self.workdir)
        if s.n_words != 1:
            raise ValueError("the walk cells' judge reads one word a spin")
        self.sync()
        t1 = time.perf_counter()
        self.trial = _trial(s, self.traffic["trial"])
        self.sync()
        t2 = time.perf_counter()
        spans["system"], spans["trial"] = t1 - t0, t2 - t1
        knobs = dict(self.traffic["walk"])
        n_imp = len(self.trial.imp_up)
        if knobs.get("mwalk") == "auto":      # the reference code's rule
            knobs["mwalk"] = max(int(3.5 * (knobs["w_abs_target"]
                                            / knobs["min_wt"] + n_imp)), 4096)
        if knobs.get("cap_spawn") == "auto":
            knobs["cap_spawn"] = max(int(3 * knobs["w_abs_target"]), 16384)
        self.cfg = W.WalkConfig(norb=s.norb, nup=s.nup, ndn=s.ndn,
                                n_words=s.n_words, has_singles=s.has_singles,
                                time_sym=s.time_sym, z=s.z, **knobs)
        self.tables = W.build_walk_tables(s, self.trial, self.cfg)
        self.sync()
        t3 = time.perf_counter()
        spans["tables"] = t3 - t2
        self.restart(self.seed, spans)

    def restart(self, seed: int, spans: dict | None = None):
        """A fresh initial state and generator from `seed`, equilibrated
        (the first block captures the generation's graph)."""
        torch, W = self.torch, self.W
        W.release_graphs()
        self.seed = seed
        self.state = W.init_walk_state(self.cfg, self.trial,
                                       self.run["w_abs_begin"],
                                       self.trial.e_trial, self.tables)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.first = True
        t0 = time.perf_counter()
        for i in range(self.run["eq_blocks"]):
            self._block(equil=True)
            if i == 0:
                t1 = time.perf_counter()
        self.sync()
        if spans is not None:
            spans["first_block"] = t1 - t0
            spans["equilibrate"] = time.perf_counter() - t1

    def _block(self, equil: bool):
        torch, W = self.torch, self.W
        start = self.state if self.first else W.end_of_block(self.state)
        self.first = False
        if not equil:
            start = start._replace(
                equilibrated=torch.ones_like(start.equilibrated))
        for grows in range(5):
            gen_state = self.gen.get_state()
            out, stats = self.block_fn(start, self.tables, self.cfg,
                                       self.nstep, self.gen)
            if not bool(out.overflow):      # the block's one host sync
                self.state = out
                return stats
            self.lost += self.nstep
            self.cfg = dataclasses.replace(
                self.cfg, mwalk=2 * self.cfg.mwalk,
                cap_spawn=2 * self.cfg.cap_spawn,
                cap_fresh=2 * self.cfg.cap_fresh)
            start = W.grow_walk_state(start, self.cfg)
            self.gen.set_state(gen_state)
        raise RuntimeError("walker capacity exceeded after 4 growths")

    # -- the window ---------------------------------------------------------
    def _snapshot(self):
        st = self.state
        n = int(st.nwalk)
        self.start = (st.up[:n, 0].cpu(), st.dn[:n, 0].cpu(),
                      st.wt[:n].cpu())

    def window(self, seconds: float) -> dict:
        """Measured blocks until `seconds` have passed: the end-to-end
        metrics over the whole window; the judge's mixed energy is the
        window's summed numerator over its summed denominator."""
        self._snapshot()
        self.lost = 0
        stats = []
        self.sync()
        t0 = time.perf_counter()
        while True:
            stats.append(self._block(equil=False))
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        self.last = stats[-1]
        gens = self.nstep * len(stats)

        def total(k):
            return float(sum(float(s[k].sum()) for s in stats))
        nwalk = total("nwalk")
        self.e_sums = (total("e_num_gen"), total("e_den_gen"), gens)
        self.attempted, self.failed = gens + self.lost, self.lost
        return {"gen_per_s": gens / dt, "walker_steps_per_s": nwalk / dt}

    def traced(self, profile, record_function, seconds: float) -> tuple:
        """`trace_blocks` measured blocks under the profiler, then an
        untraced window of `seconds` for the judge, as in a run without
        the trace: (events, traced seconds, traced generations)."""
        self.lost = 0
        n = self.run["trace_blocks"]
        self.sync()
        with profile as prof:
            with record_function("benchmark.window"):
                t0 = time.perf_counter()
                for _ in range(n):
                    self._block(equil=False)
                self.sync()
                dt = time.perf_counter() - t0
        lost = self.lost
        self.window(seconds)
        self.attempted += n * self.nstep + lost
        self.failed += lost
        return prof.events(), dt, n * self.nstep

    # -- what the judge reads -----------------------------------------------
    def outputs(self) -> dict:
        torch = self.torch
        tr, tb, st, cfg = self.trial, self.tables, self.state, self.cfg
        n_imp = len(tb.imp_diag)
        rows = judge_walk.d_rows(n_imp, self.seed)
        r = torch.as_tensor(rows, device=tb.imp_diag.device)
        if tb.imp_dense.numel():
            prog = tb.imp_dense[r].double()
        else:
            prog = torch.zeros((len(rows), n_imp), dtype=torch.float64,
                               device=r.device)
            ptr = tb.imp_ell_ptr.cpu().numpy()
            for k, i in enumerate(rows):
                a, b = int(ptr[i]), int(ptr[i + 1])
                prog[k].index_add_(0, tb.imp_ell_cols[a:b].long(),
                                   tb.imp_ell_vals[a:b].double())
        prog[torch.arange(len(rows)), r] = tb.imp_diag[r]
        last = {k: float(v[-1]) for k, v in self.last.items()
                if k != "spawn_hist"}
        c = lambda x: x.cpu()  # noqa: E731
        return {
            "norb": cfg.norb, "nup": cfg.nup, "ndn": cfg.ndn,
            "time_sym": cfg.time_sym,
            "psit_up": c(tr.psit_up[:, 0]), "psit_dn": c(tr.psit_dn[:, 0]),
            "psit_coef": c(tr.psit_coef), "e_trial": float(tr.e_trial),
            "imp_up": c(tb.imp_up[:, 0]), "imp_dn": c(tb.imp_dn[:, 0]),
            "d_rows": rows, "d_prog": c(prog),
            "walk_up": c(st.up[:, 0]), "walk_dn": c(st.dn[:, 0]),
            "walk_wt": c(st.wt), "nwalk": int(st.nwalk),
            "nwalk_trace": last["nwalk"], "e_num": last["e_num_gen"],
            "e_den": last["e_den_gen"], "w_abs": last["w_abs_gen"],
            "start_up": self.start[0], "start_dn": self.start[1],
            "start_wt": self.start[2],
            "e_num_sum": self.e_sums[0], "e_den_sum": self.e_sums[1],
            "gens": self.e_sums[2],
            "eps_pt": self.traffic["reference"]["eps_pt"],
        }

    def release(self):
        """Free the program's state, tables and captured graph."""
        self.W.release_graphs()
        self.tables = self.state = self.trial = self.system = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def control(self) -> dict:
        """The precisions the control computes each quantity in."""
        stated = dict(self.traffic["precision"], trial="float64",
                      diag="float64")
        return {k: precision.lower(v) for k, v in stated.items()}


def judge(H, outputs: dict, control: dict | None = None,
          info: dict | None = None) -> dict:
    return judge_walk.numbers(H, outputs, control, info)
