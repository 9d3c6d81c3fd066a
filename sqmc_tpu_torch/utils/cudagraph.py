"""A step function captured once as a CUDA graph and replayed (the port's
counterpart of ``jax.jit`` over ``jax.lax.scan``).

:class:`StepGraph` runs ``step(state) -> (new_state, stats)`` over a
NamedTuple of tensors.  The state's tensors on its device become static
input buffers; the captured body ends by copying the new state into them,
so each replay advances the state by one step in place.  Each step also
writes one float64 row of chosen stats into a block trace (at a
device-side index) and adds other stats into block sums, so a block of n
steps is n replays and nothing else.

Randomness: the step's own ``torch.Generator`` is registered with the
graph, and each replay continues its Philox stream where the host's
offset stands, as the eager loop would; ``gen.get_state()`` after replays
holds the advanced offset.  A warm-up step on a side stream (lazy kernel
loads and launch attributes, the cuBLAS workspace of the capture stream)
runs before the capture; the generator's state is put back after it.

Marks: with ``marks=n`` the runner owns an int64 ``[rows, n]`` buffer of
device timestamps (ops/mark.py) at the trace's row index: the step is
called as ``step(state, mark)`` and writes marks 0 .. n - 2 at its
pieces' boundaries, and the runner writes the last one after the
copy-back.  ``enqueue_seconds`` is the host time the last block's (or
step's) replays took to enqueue: two clock reads, no sync.

Launch counters: the kernel wrappers count in Python, and a replay calls
no wrapper.  The counters' change while the step is recorded is added
times the replays after each block (warm-up and recording leave the
counters as they were), so they read what the eager loop would launch.

On a CPU state nothing is captured: every replay runs the same body
eagerly over the same static buffers.  A capture that
fails raises; nothing falls back to the eager loop.

Python's cyclic garbage collector is off while a graph is recorded: a
collection there could free another, unreachable graph, and a graph's
destructor and its pool's cudaFree are calls a capture forbids (the
capture is invalidated).  A runner holds no reference cycle of its own,
so it is freed when the last reference to it goes.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from ..ops.mark import Marks

F64 = torch.float64


def _counts(counters):
    return [mod.launches for mod in counters]


def _set_counts(counters, values):
    for mod, v in zip(counters, values):
        mod.launches = v


class StepGraph:
    """One captured step and its static buffers.

    step: ``state -> (new_state, stats)``, stats a dict of tensors, with no
    host sync inside.  state: a NamedTuple whose tensor fields, all on one
    device, are the static inputs; its other fields (host values) are
    frozen at the capture: a caller whose step reads them keys its graphs
    on them and sets them on what the runner returns.  gen: the generator
    the step draws from.  trace_keys: 0-dim stats written each step as
    one float64 row (none: no trace); sum_keys: stats summed over a
    block.  counters: modules with an integer
    ``launches``.  rows: the most steps a block may take.  marks: the
    number of device timestamps a step (0: none; see the module
    docstring).  A CUDA state is captured; a CPU state runs the body
    eagerly on every replay."""

    def __init__(self, step, state, gen, trace_keys, sum_keys=(),
                 counters=(), rows: int = 1, marks: int = 0):
        self.fields = tuple(f for f in state._fields
                            if isinstance(getattr(state, f), torch.Tensor))
        devs = {getattr(state, f).device for f in self.fields}
        if len(devs) != 1:
            raise ValueError(f"the state's tensors lie on {devs}: a step "
                             "graph holds one device's")
        dev = devs.pop()
        self.device = dev
        self.capture = dev.type == "cuda"
        self.gen = gen
        self.trace_keys = tuple(trace_keys)
        self.sum_keys = tuple(sum_keys)
        self.counters = tuple(counters)
        self.rows = int(rows)
        self.static = {f: getattr(state, f).clone() for f in self.fields}
        self.trace = torch.zeros((self.rows, len(self.trace_keys)),
                                 dtype=F64, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.marks = (Marks(marks, self.rows, dev, self.slot) if marks
                      else None)
        marks_ = self.marks            # not self: no cycle through step_fn
        self.step_fn = (step if marks_ is None
                        else lambda s: step(s, marks_))
        self.enqueue_seconds = 0.0
        self.graph = None
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self._build(state)

    # -- capture ----------------------------------------------------------

    def _static_state(self):
        return self.template._replace(**self.static)

    def _body(self):
        """One step over the static buffers: the new state copied into
        them, the trace row at the device-side index, the sums added, the
        last mark after the copy-back."""
        new, stats = self.step_fn(self._static_state())
        # a stat that is an input buffer (a value of the step's input
        # state) is taken before the new state overwrites it
        inputs = {t.untyped_storage().data_ptr() for t in self.static.values()}
        stats = {k: v.clone() if v.untyped_storage().data_ptr() in inputs
                 else v for k, v in stats.items()}
        if self.trace_keys:
            row = torch.stack([stats[k].to(F64) for k in self.trace_keys])
            self.trace.index_copy_(0, self.slot, row[None])
        for k in self.sum_keys:
            self.sums[k].add_(stats[k])
        moves = [(getattr(new, f), self.static[f]) for f in self.fields]
        moves = [(s.clone() if s.untyped_storage().data_ptr() in inputs
                  else s, d) for s, d in moves if s is not d]
        for src, dst in moves:
            dst.copy_(src)
        if self.marks is not None:
            self.marks.last()
        self.slot.add_(1)
        return new, stats

    def _build(self, state):
        self.template = state
        saved = self.gen.get_state()
        before = _counts(self.counters)
        if self.capture:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            on_side = torch.cuda.stream(side)
        else:
            on_side = contextlib.nullcontext()
        with on_side:
            _, stats = self.step_fn(self._static_state())       # warm-up
            self.sums = {k: torch.zeros_like(stats[k]) for k in self.sum_keys}
            del stats
            self.gen.set_state(saved)
            warm = _counts(self.counters)
            t0 = time.perf_counter()
            if self.capture:
                # the pool is what the capture reserves beyond an emptied
                # cache (torch.cuda.graph empties it again, a no-op now)
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.device)
                self.graph = torch.cuda.CUDAGraph()
                self.graph.register_generator_state(self.gen)
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(self.graph, stream=side):
                        new, self.out_stats = self._body()
                finally:
                    if collecting:
                        gc.enable()
                self.pool_bytes = (torch.cuda.memory_reserved(self.device)
                                   - reserved)
            else:
                new, self.out_stats = self._body()
            self.capture_seconds = time.perf_counter() - t0
            self.gen.set_state(saved)
        if self.capture:
            torch.cuda.current_stream(self.device).wait_stream(side)
        self.delta = [b - a for a, b in zip(warm, _counts(self.counters))]
        _set_counts(self.counters, before)
        # fields the step returns that are not tensors pass on
        self.template = new._replace(**self.static)

    # -- replay -----------------------------------------------------------

    def load(self, state):
        """Copy `state` into the static buffers; reset the trace and sums."""
        for f in self.fields:
            x, dst = getattr(state, f), self.static[f]
            if (not isinstance(x, torch.Tensor) or x.shape != dst.shape
                    or x.dtype != dst.dtype or x.device != dst.device):
                raise ValueError(f"state field {f!r} does not match the "
                                 f"captured step's {tuple(dst.shape)} "
                                 f"{dst.dtype} on {dst.device}")
            if x is not dst:
                dst.copy_(x)
        self.slot.zero_()
        for s in self.sums.values():
            s.zero_()

    def _replay(self, n: int):
        before = _counts(self.counters)
        t0 = time.perf_counter()
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                _, self.out_stats = self._body()
        self.enqueue_seconds = time.perf_counter() - t0
        self.replays += n
        _set_counts(self.counters,
                    [b + d * n for b, d in zip(before, self.delta)])

    def _state_out(self):
        """The current state as tensors the caller owns."""
        return self.template._replace(
            **{f: t.clone() for f, t in self.static.items()})

    def block(self, state, n: int):
        """n steps from `state`: (new state, [n, len(trace_keys)] float64
        trace, {sum key: block sum}), all owned by the caller."""
        if not 1 <= n <= self.rows:
            raise ValueError(f"a block of {n} steps; this graph holds "
                             f"1..{self.rows}")
        self.load(state)
        self._replay(n)
        return (self._state_out(), self.trace[:n].clone(),
                {k: v.clone() for k, v in self.sums.items()})

    def step(self, state):
        """One step from `state`: (new state, every stat of the step), all
        owned by the caller."""
        self.load(state)
        self._replay(1)
        return (self._state_out(),
                {k: v.clone() for k, v in self.out_stats.items()})


class GraphCache:
    """The captured steps of one loop (one dense walk, one VMC run, one
    CPMC run) and the generator registered with all of them for their
    lifetime.  A new loop key drops them, with their memory pools, before
    the next capture; ``clear()`` drops them by hand."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.key, self.gen, self.graphs = None, None, {}

    def get(self, key, device, build, variant=None, rows: int = 1):
        """(generator, graph) of loop `key` for `variant`: ``build(gen)``
        captures the graph when there is none, or when it holds fewer than
        `rows` steps.  The graph's step must hold what its key's ids name,
        so that they stay unique while it lives."""
        if key != self.key:
            self.clear()
            self.key, self.gen = key, torch.Generator(device=device)
        g = self.graphs.get(variant)
        if g is None or g.rows < rows:
            g = self.graphs[variant] = build(self.gen)
        return self.gen, g
