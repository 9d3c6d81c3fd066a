"""SHCI cells: sqmc_tpu_torch's HCI (device Davidson) and deterministic
PT, repeated whole.

Set-up builds the system and runs one whole solve (the kernels' builds
and every shape the window uses).  The window repeats solves, each from
scratch with no wavefunction cache, and closes at the end of the first
solve that ends after `seconds`: shci_s is the window over the solves.
The traced window is one solve, with HCI and PT each ended by a
synchronize.

The traffic file holds ``hci`` (run_hci's knobs), ``pt`` (eps_pt) and
``stated`` (the configuration's own result: the selected dets' count and
E_var).
"""

from __future__ import annotations

import time

from benchmark.reference import judge_shci, precision


class Driver:
    kind = "shci"

    def __init__(self, config, traffic, seed, device, workdir, system_mod):
        import torch
        self.torch = torch
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.workdir = seed, device, workdir
        self.system_mod = system_mod
        self.failed = 0

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def setup(self, spans: dict):
        from sqmc_tpu_torch.algo.hci import run_hci
        from sqmc_tpu_torch.algo.pt import second_order_pt
        self.hci_fn, self.pt_fn = run_hci, second_order_pt   # faults go here
        t0 = time.perf_counter()
        self.system = self.system_mod.program_system(
            self.config, self.traffic, self.device, self.workdir)
        if self.system.n_words != 1 or self.system.time_sym:
            raise ValueError("the SHCI judge reads plain dets, one word a spin")
        self.sync()
        spans["system"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        self._solve({})
        spans["warm_solve"] = time.perf_counter() - t1

    def restart(self, seed: int, spans: dict | None = None):
        """The solve draws nothing at random: a new seed changes nothing."""
        self.seed = seed

    def _solve(self, spans):
        h, p = self.traffic["hci"], self.traffic["pt"]
        t0 = time.perf_counter()
        res = self.hci_fn(self.system, eps_var=h["eps_var"],
                          eps_var_sched=h.get("eps_var_sched"),
                          device_davidson=h["device_davidson"],
                          verbose=False)
        self.sync()
        t1 = time.perf_counter()
        e_var = float(res.energies[0])
        pt, n_conn = self.pt_fn(self.system, res.up, res.dn, res.wts[:, 0],
                                e_var, p["eps_pt"], verbose=False)
        self.sync()
        spans["hci"], spans["pt"] = t1 - t0, time.perf_counter() - t1
        self.last = (res, e_var, float(pt), int(n_conn))

    def window(self, seconds: float) -> dict:
        n = 0
        t0 = time.perf_counter()
        while True:
            self._solve({})
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.attempted = n
        return {"shci_s": (time.perf_counter() - t0) / n}

    def traced(self, profile, record_function, seconds: float) -> tuple:
        """One solve under the profiler (seconds: unused; the judge reads
        that solve)."""
        self.spans = {}
        with profile as prof:
            with record_function("benchmark.window"):
                t0 = time.perf_counter()
                self._solve(self.spans)
                dt = time.perf_counter() - t0
        self.attempted = 1
        return prof.events(), dt, 1

    def traced_spans(self) -> dict:
        return self.spans

    def outputs(self) -> dict:
        res, e_var, pt, n_conn = self.last
        s = self.system
        return {"up": res.up[:, 0].cpu(), "dn": res.dn[:, 0].cpu(),
                "coef": self.torch.as_tensor(res.wts[:, 0]),
                "e_var": e_var, "pt": pt, "n_connected": n_conn,
                "nup": s.nup, "ndn": s.ndn,
                "eps_pt": self.traffic["pt"]["eps_pt"],
                "ndets_stated": self.traffic["stated"]["ndets"],
                "e_var_stated": self.traffic["stated"]["e_var"]}

    def release(self):
        self.system = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def control(self):
        return precision.lower("float64")


def judge(H, outputs: dict, control=None, info: dict | None = None) -> dict:
    return judge_shci.numbers(H, outputs, control, info)
