"""Determinant sharding over a process group (port of
sqmc_tpu/parallel/dist.py).

A mesh is a ``torch.distributed`` process group with one rank per device,
run SPMD: every rank runs the same program on its own shard, which is what
the JAX package gets from ``shard_map`` over a device mesh.  The
reference's MPI layer maps as the JAX package maps it (SURVEY.md 2.3/2.4):

  P1  get_det_owner hash sharding -> :func:`det_owner` (host numpy and
      torch give the same owner bit for bit); walkers live on their
      owner's rank
  P2  mpi_sendnewwalks alltoallv  -> :func:`route_spawns`: a fixed bucket
      of CAP // n rows per destination, one ``all_to_all_single``
  P4  distributed Davidson        -> :func:`make_sharded_matvec`: a
      contiguous row block per rank in K2's block-ELL layout (local rows,
      global columns), then ``all_gather``
  P5  mpi_merge_sort2             -> :func:`sharded_unique_dets`: owner
      routing with uneven splits, a local sort and unique, ``all_gather``
  P8  master-core I/O + broadcast -> every rank reads its input and builds
      the replicated tables itself

Collectives: ``all_to_all`` -> ``all_to_all_single``, ``psum`` ->
``all_reduce``, ``all_gather`` -> ``all_gather``.  NCCL carries CUDA
tensors.  Gloo carries CPU tensors; a gloo mesh whose ranks work on a CUDA
device stages every collective through the host, and says so
(``Mesh.transport == "gloo-host"``).  No uint64 tensor goes through a
collective (gloo refuses them): det words are int64, payloads move as
int64 bit patterns.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..dets import SENTINEL
from ..ops import setalg

_K1 = 0x9E3779B97F4A7C15
_K2 = 0xC2B2AE3D27D4EB4F
_I64 = torch.int64


def _as_int64(k: int) -> int:
    return k - (1 << 64) if k >= 1 << 63 else k


# ---------------------------------------------------------------------------
# Owner hash (P1)
# ---------------------------------------------------------------------------

def det_owner_np(up, dn, n_dev: int) -> np.ndarray:
    """Owner rank of each det (host).  up/dn: [n, W] uint64 or int64 words
    (the same bits).  int32 [n]."""
    up = np.ascontiguousarray(up).view(np.uint64)
    dn = np.ascontiguousarray(dn).view(np.uint64)
    acc = np.zeros(len(up), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for w in range(up.shape[1]):
            acc = (acc ^ up[:, w]) * np.uint64(_K1)
            acc = (acc ^ dn[:, w]) * np.uint64(_K2)
        acc ^= acc >> np.uint64(29)
    return (acc % np.uint64(n_dev)).astype(np.int32)


def det_owner(up: torch.Tensor, dn: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Owner rank of each det (any device); equals :func:`det_owner_np`
    bit for bit.  The hash runs on int64 (products wrap mod 2^64 as the
    uint64 ones do): the shift is made logical by a mask, and the unsigned
    remainder is built from the two 32-bit halves.  int32 [n]."""
    acc = torch.zeros(up.shape[0], dtype=_I64, device=up.device)
    for w in range(up.shape[1]):
        acc = (acc ^ up[:, w]) * _as_int64(_K1)
        acc = (acc ^ dn[:, w]) * _as_int64(_K2)
    acc = acc ^ ((acc >> 29) & ((1 << 35) - 1))
    hi = (acc >> 32) & 0xFFFFFFFF
    lo = acc & 0xFFFFFFFF
    rem = ((hi % n_dev) * ((1 << 32) % n_dev) + lo % n_dev) % n_dev
    return rem.to(torch.int32)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """One rank's view of the process group: its rank, the group's size,
    the device it works on and the backend.  The collectives below take
    and return tensors on ``device``."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def transport(self) -> str:
        """"nccl", "gloo", or "gloo-host" (gloo with CUDA tensors, staged
        through the host)."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo-host"
        return self.backend

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        # a private copy the collective may overwrite, where it runs
        if self.transport == "gloo-host":
            return t.detach().to("cpu", copy=True)
        return t.detach().clone(memory_format=torch.contiguous_format)

    def _empty(self, shape, dtype) -> torch.Tensor:
        dev = "cpu" if self.transport == "gloo-host" else self.device
        return torch.empty(shape, dtype=dtype, device=dev)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (every rank gets the same bits)."""
        buf = self._send(t)
        dist.all_reduce(buf, group=self.group)
        return buf.to(self.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped tensors concatenated along dim 0 in rank
        order."""
        buf = self._send(t)
        outs = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(outs, buf, group=self.group)
        return torch.cat(outs).to(self.device)

    def all_gather_var(self, t: torch.Tensor) -> torch.Tensor:
        """As all_gather, for tensors whose first dimension differs."""
        n = torch.tensor([t.shape[0]], dtype=_I64, device=self.device)
        sizes = self.all_gather(n).tolist()
        top = max(sizes)
        pad = torch.zeros((top - t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        full = self.all_gather(torch.cat([t, pad]))
        return torch.cat([full[r * top:r * top + s]
                          for r, s in enumerate(sizes)])

    def all_to_all(self, t: torch.Tensor, send_counts=None) -> torch.Tensor:
        """Rows of `t` sent to the ranks in order: ``send_counts[r]`` rows
        to rank r (equal blocks when None); returns the rows received, in
        source-rank order."""
        buf = self._send(t)
        if send_counts is None:
            out = torch.empty_like(buf)
            dist.all_to_all_single(out, buf, group=self.group)
        else:
            sc = torch.as_tensor(send_counts, dtype=_I64)
            recv = self.all_to_all(sc.to(self.device)).tolist()
            out = self._empty((sum(recv),) + tuple(buf.shape[1:]), buf.dtype)
            dist.all_to_all_single(out, buf, output_split_sizes=recv,
                                   input_split_sizes=sc.tolist(),
                                   group=self.group)
        return out.to(self.device)

    def barrier(self) -> None:
        """Wait until every rank has come here."""
        self.all_reduce(torch.zeros(1, device=self.device))

    def close(self) -> None:
        """Leave the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(device="cuda", backend: str | None = None,
              n_devices: int | None = None,
              init_method: str | None = None) -> Mesh:
    """This process's rank of a mesh (joining the process group first
    unless it is already joined).

    backend follows the device: NCCL for ``cuda``, gloo for ``cpu``;
    ``backend="gloo"`` may be asked for with a CUDA device (collectives
    then go through the host).  Rank and size come from ``RANK`` /
    ``WORLD_SIZE`` (``torchrun`` sets them, with ``MASTER_ADDR`` for its
    ``env://`` rendezvous; :func:`spawn` passes a ``file://`` one), a
    single process without them is a mesh of one.  A CUDA rank takes
    ``cuda:{LOCAL_RANK % device_count}`` unless the device names its
    index.  Like the JAX package's make_mesh this raises, and never goes
    on with fewer, when the group does not hold n_devices ranks or when
    NCCL would put two ranks of one host on one card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device visible; a CPU mesh "
                           "is make_mesh(device='cpu') (gloo)")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL carries CUDA tensors only; a CPU mesh is gloo")
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
        if init_method is None:
            if "MASTER_ADDR" in os.environ:
                init_method = "env://"
            elif world == 1:
                init_method = "file://" + os.path.join(tempfile.mkdtemp(),
                                                       "rendezvous")
            else:
                raise RuntimeError(
                    f"make_mesh: {world} ranks need a rendezvous "
                    "(torchrun's MASTER_ADDR, or init_method)")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=timedelta(minutes=10))
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise RuntimeError(f"make_mesh({n_devices}): the process group has "
                           f"{size} rank(s)")
    if device.type == "cuda":
        count = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        if backend == "nccl" and local_size > count:
            raise RuntimeError(
                f"make_mesh: {local_size} NCCL ranks on this host but only "
                f"{count} card(s): NCCL takes one rank per card")
        if device.index is None:
            device = torch.device("cuda", local % count)
        torch.cuda.set_device(device)
    return Mesh(group=dist.group.WORLD, rank=rank, size=size, device=device,
                backend=backend)


def check_mesh(mesh):
    """`mesh` itself when it is None or a Mesh; anything else raises
    ValueError (the mesh= argument of run_hci and PT)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise ValueError(f"mesh={mesh!r} is not a parallel.dist.Mesh "
                         "(make_mesh)")
    return mesh


def _rank_main(fn, rank, world_size, backend, device, tmp, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    mesh = None
    try:
        mesh = make_mesh(device, backend,
                         init_method="file://" + os.path.join(tmp, "rdzv"))
        out = fn(mesh, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if mesh is not None:
            mesh.close()


def spawn(fn, world_size: int, *, backend: str | None = None,
          device="cuda", args=(), timeout: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` on `world_size` ranks, each a fresh process
    (the ``spawn`` start method: `fn` must be importable by name, and a
    module that does not import jax keeps jax out of the ranks), joined by
    a ``file://`` rendezvous in a temporary directory (no TCP port, so
    several groups can run side by side).  Returns the ranks' return
    values in rank order.  A rank that raises, dies or outlives `timeout`
    fails the call: every rank is stopped and a RuntimeError carries each
    failed rank's traceback or exit code.  The ranks work on the card
    (``make_mesh``'s device) unless `device` asks for the CPU; with no
    CUDA device this raises before starting any."""
    import multiprocessing as mp
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn: no CUDA device visible; CPU ranks are "
                           "spawn(..., device='cpu') (gloo)")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, str(device),
                                   tmp, tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                procs[0].join(timeout=0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        errs = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errs.append(f"rank {r}: exit code {p.exitcode}")
        if errs or timed_out:
            why = f"timed out after {timeout} s" if timed_out else "failed"
            raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, "
                               f"{world_size}) {why}:\n" + "\n".join(errs))
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def rank_slice(n: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's contiguous share [lo, hi) of n items."""
    chunk = -(-n // mesh.size)
    lo = min(n, mesh.rank * chunk)
    return lo, min(n, lo + chunk)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of one rank's torch.Generator: the counterpart of
    jax.random.split(PRNGKey(seed), n)[rank]; rank 0 keeps `seed`."""
    return (seed + rank * 0x9E3779B97F4A7C15) % (1 << 63)


# ---------------------------------------------------------------------------
# Spawn routing (P2)
# ---------------------------------------------------------------------------

def _pack(arrays: dict, valid=None):
    """Columns of every payload as one [n, K] int64 matrix (32-bit
    payloads sign-extended, 64-bit ones bitcast) and what unpacks it."""
    cols, meta = [], []
    for k, a in arrays.items():
        c = a[:, None] if a.dim() == 1 else a
        if c.element_size() == 8:
            cols.append(c.view(_I64))
        elif c.element_size() == 4:
            cols.append(c.view(torch.int32).to(_I64))
        else:
            raise ValueError(f"payload {k!r}: {a.dtype} is not 32 or 64 bit")
        meta.append((k, a.dtype, a.dim(), c.shape[1]))
    if valid is not None:
        cols.append(valid.to(_I64)[:, None])
    return torch.cat(cols, dim=1), meta


def _unpack(buf, meta):
    out, j = {}, 0
    for k, dtype, ndim, ncol in meta:
        c = buf[:, j:j + ncol]
        j += ncol
        if torch.empty((), dtype=dtype).element_size() == 4:
            c = c.to(torch.int32).contiguous().view(dtype)
        else:
            c = c.contiguous().view(dtype)
        out[k] = c[:, 0] if ndim == 1 else c
    return out, j


def route_spawns(mesh: Mesh, owner: torch.Tensor, valid: torch.Tensor,
                 arrays: dict):
    """Bucket spawn slots by owner and exchange them over the mesh.

    owner: [CAP] destination ranks; valid: [CAP] mask; arrays: dict of
    [CAP] or [CAP, k] payloads of 32 or 64 bits.  Each destination gets a
    bucket of CAP // n rows, filled with its spawns in slot order (a
    stable sort by owner); spawns past a full bucket are dropped and the
    overflow flag is set, and every other row stays exact.  One
    ``all_to_all_single`` moves one [CAP, K] int64 matrix.  Returns
    (received arrays [CAP, ...], their valid mask, overflow as a 0-d bool
    tensor): row s * CAP // n + j is the j-th spawn rank s sent here;
    invalid rows hold zeros."""
    CAP, n = owner.shape[0], mesh.size
    if CAP % n:
        raise ValueError(f"spawn capacity {CAP} is not a multiple of the "
                         f"{n} ranks")
    cap_loc = CAP // n
    dev = owner.device
    owner = torch.where(valid, owner.to(_I64), n)   # invalid: no bucket
    packed, meta = _pack(arrays, valid)
    order = torch.argsort(owner, stable=True)
    first_of = torch.searchsorted(owner[order],
                                  torch.arange(n + 1, device=dev))
    counts = first_of[1:] - first_of[:-1]
    overflow = (counts[:n] > cap_loc).any()
    # bucket slot s = (rank d, row j) takes the sorted row first_of[d] + j
    # while j < counts[d]: a gather, so an overflowing bucket cuts its own
    # rows and no other
    slot = torch.arange(CAP, device=dev)
    sdev = slot // cap_loc
    srank = slot - sdev * cap_loc
    svalid = srank < counts[sdev]
    src = order[(first_of[sdev] + srank).clamp(max=CAP - 1)]
    buf = torch.where(svalid[:, None], packed[src], 0)
    buf = mesh.all_to_all(buf)
    out, j = _unpack(buf, meta)
    return out, buf[:, j] != 0, overflow


def route_by_owner(mesh: Mesh, up: torch.Tensor, dn: torch.Tensor,
                   payloads=()):
    """Send every det (and its float64 payloads) to its owner rank with
    uneven splits: nothing is dropped.  Returns (up, dn, payloads) of the
    rows this rank received, in source-rank order."""
    owner = det_owner(up, dn, mesh.size).to(_I64)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=mesh.size)
    packed, meta = _pack({"up": up, "dn": dn,
                          **{str(i): p for i, p in enumerate(payloads)}})
    recv = mesh.all_to_all(packed[order], counts.tolist())
    out, _ = _unpack(recv, meta)
    return out["up"], out["dn"], [out[str(i)] for i in range(len(payloads))]


# ---------------------------------------------------------------------------
# Host-side shard layouts
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _np64(x) -> np.ndarray:
    """Det words (tensor or array, int64 or uint64) as host int64."""
    x = np.ascontiguousarray(_host(x))
    return x.view(np.int64) if x.dtype == np.uint64 else x.astype(np.int64)


def _lexsort_np(up, dn) -> np.ndarray:
    """setalg.lexsort_dets (the flipped-key det order) on host arrays."""
    return setalg.lexsort_dets(torch.as_tensor(up), torch.as_tensor(dn)).numpy()


def shard_initial_state(up, dn, wt, imp, init_flag, n_dev: int,
                        mwalk_local: int):
    """Distribute an initial det population to its owner ranks (host).

    Returns stacked arrays [n_dev, mwalk_local, ...] (int64 words, -1 in
    empty slots) plus the per-rank counts; each rank's slice is sorted by
    det key."""
    up, dn = _np64(up), _np64(dn)
    wt, imp, init_flag = (_host(x) for x in (wt, imp, init_flag))
    W = up.shape[1]
    owner = det_owner_np(up, dn, n_dev)
    s_up = np.full((n_dev, mwalk_local, W), SENTINEL, np.int64)
    s_dn = np.full((n_dev, mwalk_local, W), SENTINEL, np.int64)
    s_wt = np.zeros((n_dev, mwalk_local))
    s_imp = np.full((n_dev, mwalk_local), 10 ** 6, np.int32)
    s_init = np.zeros((n_dev, mwalk_local), np.int32)
    counts = np.zeros(n_dev, np.int32)
    for d in range(n_dev):
        sel = owner == d
        u, v = up[sel], dn[sel]
        order = _lexsort_np(u, v)
        k = len(u)
        if k > mwalk_local:
            raise ValueError("initial population exceeds local capacity")
        s_up[d, :k] = u[order]
        s_dn[d, :k] = v[order]
        s_wt[d, :k] = wt[sel][order]
        s_imp[d, :k] = imp[sel][order]
        s_init[d, :k] = init_flag[sel][order]
        counts[d] = k
    return s_up, s_dn, s_wt, s_imp, s_init, counts


def shard_imp_space(imp_up, imp_dn, imp_ham, n_dev: int):
    """Split the deterministic space by owner; build the row-complete COO
    with global column indices (host).

    Returns per-rank arrays stacked on axis 0:
      su, sd: [n_dev, m, W] padded local D dets (sorted; -1 padding)
      rows: [n_dev, nnz_m] local row ids; cols: [n_dev, nnz_m] GLOBAL ids
      vals: [n_dev, nnz_m] (zero padding at row 0, column 0)
    and m, where the global id of (rank d, slot s) is d * m + s."""
    imp_up, imp_dn = _np64(imp_up), _np64(imp_dn)
    h_rows, h_cols = (_host(x).astype(np.int64)
                      for x in (imp_ham.rows, imp_ham.cols))
    h_vals, h_diag = (_host(x).astype(np.float64)
                      for x in (imp_ham.vals, imp_ham.diag))
    n = len(imp_up)
    W = imp_up.shape[1]
    owner = det_owner_np(imp_up, imp_dn, n_dev)
    local_idx = np.zeros(n, np.int64)
    perms = []
    m = 0
    for d in range(n_dev):
        sel = np.nonzero(owner == d)[0]
        sel = sel[_lexsort_np(imp_up[sel], imp_dn[sel])]
        local_idx[sel] = np.arange(len(sel))
        perms.append(sel)
        m = max(m, len(sel))
    m = max(m, 1)
    gid = owner.astype(np.int64) * m + local_idx

    su = np.full((n_dev, m, W), SENTINEL, np.int64)
    sd = np.full((n_dev, m, W), SENTINEL, np.int64)
    for d in range(n_dev):
        su[d, :len(perms[d])] = imp_up[perms[d]]
        sd[d, :len(perms[d])] = imp_dn[perms[d]]

    r_all = np.concatenate([h_rows, h_cols, np.arange(n)])
    c_all = np.concatenate([h_cols, h_rows, np.arange(n)])
    v_all = np.concatenate([h_vals, h_vals, h_diag])
    row_owner = owner[r_all]
    per = []
    nnz_m = 1
    for d in range(n_dev):
        sel = row_owner == d
        per.append((local_idx[r_all[sel]], gid[c_all[sel]], v_all[sel]))
        nnz_m = max(nnz_m, int(sel.sum()))
    rows = np.zeros((n_dev, nnz_m), np.int32)
    cols = np.zeros((n_dev, nnz_m), np.int32)
    vals = np.zeros((n_dev, nnz_m))
    for d, (r, c, v) in enumerate(per):
        rows[d, :len(r)] = r
        cols[d, :len(c)] = c
        vals[d, :len(v)] = v
    return su, sd, rows, cols, vals, m


def _blockell_local(m: int, rows, cols, vals, gdiag_base: int,
                    dtype=np.float64):
    """One rank's projection layout: its row-complete local-rows /
    global-columns COO -> the off-diagonal entries in K2's 128-slot
    row-block layout plus the dense diagonal.  Diagonal entries are those
    with cols == gdiag_base + rows; zero-valued COO padding is dropped.

    Returns (ell_cols [P] int32, ell_vals [P] dtype, ell_row [P // 128]
    int32, row_ptr [m + 1] int64, row_nnz [m] int32, diag [m] float64);
    ell_cols, ell_vals and ell_row equal the JAX package's."""
    from ..ops.spmv import blockell_from_full_coo
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    keep = vals != 0.0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    isdiag = cols == gdiag_base + rows
    diag = np.zeros(m)
    np.add.at(diag, rows[isdiag], vals[isdiag])
    return blockell_from_full_coo(m, rows[~isdiag], cols[~isdiag],
                                  vals[~isdiag], dtype=dtype) + (diag,)


# ---------------------------------------------------------------------------
# Distributed dedup (P5)
# ---------------------------------------------------------------------------

def owner_unique_dets(mesh: Mesh, up: torch.Tensor, dn: torch.Tensor):
    """Union of every rank's det list, sorted and unique, on every rank:
    each rank sends its dets to their owners (uneven splits: no bucket to
    overflow), the owner sorts and uniques what it received, and the
    disjoint results are gathered and sorted (int64 words on mesh.device)."""
    up, dn = up.to(mesh.device), dn.to(mesh.device)
    W = up.shape[1]
    r_up, r_dn, _ = route_by_owner(mesh, up, dn)
    u, d, _, _ = setalg.unique_dets(r_up, r_dn)
    both = mesh.all_gather_var(torch.cat([u, d], dim=1))
    order = setalg.lexsort_dets(both[:, :W], both[:, W:])
    return both[order, :W], both[order, W:]


def sharded_unique_dets(mesh: Mesh, up, dn):
    """Distributed candidate dedup (SURVEY P5; ref mpi_merge_sort2,
    mpi_routines.f90:2625): every rank holds the same candidate list and
    takes its round-robin share of it, which :func:`owner_unique_dets`
    routes to the owners.  Returns (up_u, dn_u) sorted by det key, equal
    to setalg.unique_dets's, on every rank."""
    if not isinstance(up, torch.Tensor):
        up, dn = torch.as_tensor(_np64(up)), torch.as_tensor(_np64(dn))
    if len(up) == 0:
        return up, dn
    return owner_unique_dets(mesh, up[mesh.rank::mesh.size],
                             dn[mesh.rank::mesh.size])


# ---------------------------------------------------------------------------
# Sharded Davidson matvec (P4)
# ---------------------------------------------------------------------------

def make_sharded_matvec(H, mesh: Mesh):
    """y = H v over the mesh (ref: more_tools.f90 davidson_sparse_mpi2:2525,
    a local-row sparse matvec and a gather).  Each rank holds a contiguous
    block of H's rows (both orientations of the stored triangle plus the
    diagonal) in K2's block-ELL layout, float64, with local rows and
    global columns; its product runs on K2 (the plain version on the CPU)
    against the whole replicated v, and ``all_gather`` assembles y.  No
    atomics: y repeats bit for bit.  The JAX package shards COO entries
    and psums instead; only the order of the sums differs.

    Pass the returned function as davidson(..., matvec_fn=...): it takes
    a float64 [n] or [n, k] tensor and returns y on H's device."""
    from ..ops.spmv import _symmetric_sorted, blockell_from_full_coo, spmv
    n = H.n
    lo, hi = rank_slice(n, mesh)
    chunk = -(-n // mesh.size)
    r_all, c_all, v_all, _, _ = _symmetric_sorted(n, H.rows, H.cols, H.vals,
                                                  H.diag)
    a, b = np.searchsorted(r_all, [lo, hi])
    cols, vals, _, ptr, nnz = blockell_from_full_coo(
        hi - lo, r_all[a:b] - lo, c_all[a:b], v_all[a:b], dtype=np.float64)
    dev = H.vals.device
    cols, vals, ptr, nnz = (torch.as_tensor(x, device=dev)
                            for x in (cols, vals, ptr, nnz))

    def matvec_fn(x):
        x = torch.as_tensor(x, device=dev).to(torch.float64)
        y = spmv(x, cols, vals, ptr, nnz)
        pad = torch.zeros((chunk - (hi - lo),) + tuple(y.shape[1:]),
                          dtype=y.dtype, device=dev)
        return mesh.all_gather(torch.cat([y, pad])).to(dev)[:n]

    return matvec_fn


# ---------------------------------------------------------------------------
# Sharded walk assembly
# ---------------------------------------------------------------------------

def make_sharded_walk(system, trial, cfg, mesh: Mesh, w_abs_begin: float,
                      e_trial_initial: float, seed: int = 0):
    """This rank's (step, state, tables) of a determinant-sharded walk.

    cfg: WalkConfig with axis_name set and n_dev = mesh.size; mwalk and
    cap_spawn are PER-RANK capacities.  The tables are the replicated
    ones of build_walk_tables with this rank's D rows swapped in: its D
    dets (sorted, padded to the largest shard), the off-diagonal
    projection rows either dense [m_loc, n_glob] float32 (f32 state and
    n_glob <= dense_proj_max) or K2's block-ELL (local rows, global
    columns into the all-gathered D-weight vector), the diagonal, the
    C(T)-in-D vectors at the local slots, and the mesh.  The state holds
    the initial population's dets this rank owns.  ``step(state,
    tables)`` is walk_step with this rank's torch.Generator (seeded from
    (seed, rank)).  Blocks of generations (the JAX package's
    nstep_per_call) are run_walk's: it takes these tables and state as
    they are and, with the same seed, draws from the same per-rank
    stream."""
    from ..algo import walk as W_
    if cfg.axis_name is None or cfg.n_dev != mesh.size:
        raise ValueError(f"make_sharded_walk needs WalkConfig(axis_name=..., "
                         f"n_dev={mesh.size}) for this mesh")
    n_dev, r = mesh.size, mesh.rank
    dev = mesh.device
    base = W_.build_walk_tables(system, trial, cfg)
    su, sd, rows, cols, vals, m_loc = shard_imp_space(
        trial.imp_up, trial.imp_dn, trial.imp_ham, n_dev)
    fdt = np.float32 if cfg.f32_state else np.float64
    ec, ev, _, ptr, nnz, diag = _blockell_local(
        m_loc, rows[r], cols[r], vals[r], r * m_loc, dtype=fdt)

    n_glob = n_dev * m_loc
    imp_dense = torch.zeros((0, 0), dtype=torch.float32, device=dev)
    if cfg.f32_state and 0 < n_glob <= cfg.dense_proj_max:
        rr, cc = rows[r].astype(np.int64), cols[r].astype(np.int64)
        keep = (vals[r] != 0.0) & (cc != r * m_loc + rr)
        imp_dense = torch.zeros((m_loc, n_glob), dtype=torch.float32,
                                device=dev)
        imp_dense.index_put_(
            (torch.as_tensor(rr[keep], device=dev),
             torch.as_tensor(cc[keep], device=dev)),
            torch.as_tensor(vals[r][keep].astype(np.float32), device=dev),
            accumulate=True)
        if cfg.proj_bf16:
            imp_dense = imp_dense.to(torch.bfloat16)

    t_up = torch.as_tensor(su[r], device=dev)
    t_dn = torch.as_tensor(sd[r], device=dev)
    ct_num_imp = ct_den_imp = torch.zeros(0, dtype=torch.float64, device=dev)
    if base.ct_num_imp.numel():
        # each C(T) det lies in D (build_walk_tables checked it) and is
        # owned by one rank: its (num, den) go to that rank's local slot
        lpos = setalg.search_dets(t_up, t_dn, base.ct_up, base.ct_dn)
        own = lpos >= 0
        ct_num_imp = torch.zeros(m_loc, dtype=torch.float64, device=dev)
        ct_den_imp = torch.zeros(m_loc, dtype=torch.float64, device=dev)
        ct_num_imp[lpos[own]] = trial.ct_num.to(dev, torch.float64)[own]
        ct_den_imp[lpos[own]] = trial.ct_den.to(dev, torch.float64)[own]

    def t(x, dt=None):
        x = torch.as_tensor(np.asarray(x), device=dev)
        return x if dt is None else x.to(dt)

    tables = base._replace(
        imp_up=t_up, imp_dn=t_dn,
        imp_ell_cols=t(ec), imp_ell_vals=t(ev), imp_ell_ptr=t(ptr),
        imp_ell_nnz=t(nnz), imp_diag=t(diag, torch.float64),
        imp_dense=imp_dense,
        imp_rows=t(rows[r], _I64), imp_cols=t(cols[r], _I64),
        imp_vals=t(vals[r].astype(fdt)),
        ct_num_imp=ct_num_imp, ct_den_imp=ct_den_imp, mesh=mesh)

    # the initial population (Psi_T, then every D det at weight 0), by owner
    dev0 = trial.psit_up.device
    all_up = torch.cat([trial.psit_up, trial.imp_up.to(dev0)])
    all_dn = torch.cat([trial.psit_dn, trial.imp_dn.to(dev0)])
    coefs = torch.cat([trial.psit_coef.to(dev0, torch.float64),
                       torch.zeros(len(trial.imp_up), dtype=torch.float64,
                                   device=dev0)])
    u, d, (c,), _ = setalg.unique_dets(all_up, all_dn, [coefs])
    scale = w_abs_begin / float(c.abs().sum())
    in_imp = ~setalg.setdiff_dets(u, d, trial.imp_up.to(dev0),
                                  trial.imp_dn.to(dev0))
    s_up, s_dn, s_wt, s_imp, s_init, counts = shard_initial_state(
        u, d, (c * scale).cpu().numpy(),
        torch.where(in_imp, 0, 1).cpu().numpy().astype(np.int32),
        np.full(len(u), 2, np.int32), n_dev, cfg.mwalk)
    sdt = torch.float32 if cfg.f32_state else torch.float64
    # diag / C(T) index stay unknown: the step's cache repair fills them
    state = W_.walk_state_from_arrays(
        cfg, w_abs_begin, e_trial_initial, up=t(s_up[r]), dn=t(s_dn[r]),
        wt=t(s_wt[r], sdt), init=t(s_init[r]), imp=t(s_imp[r]),
        diag=torch.full((cfg.mwalk,), W_.DIAG_UNKNOWN, dtype=sdt, device=dev),
        ct=torch.full((cfg.mwalk,), -2, dtype=_I64, device=dev),
        nwalk=int(counts[r]))

    gen = torch.Generator(device=dev)
    gen.manual_seed(rank_seed(seed, r))

    def step(state, tables):
        return W_.walk_step(state, tables, cfg, gen)

    return step, state, tables
