"""Second-order Epstein-Nesbet perturbation theory, deterministic and
semistochastic (port of sqmc_tpu/algo/pt.py; ref: hci.f90
second_order_pt:1100, second_order_pt_alias:1314, do_pt:4148).

  deterministic:  sum_{a not in V} (sum_{i in V, |H_ai c_i| > eps_pt}
                  H_ai c_i)^2 / (E_var - H_aa)
  semistochastic: the deterministic part at eps_pt_big plus the unbiased
                  two-term estimator of the eps_pt / eps_pt_big
                  difference, with variational dets alias-sampled with
                  p_i ~ |c_i| and a Welford mean until the target error.

Everything runs on the system's device: screened connections
(``generate_connections``), the merge of contributions by sorted
segment sums (``setalg.unique_dets``) and the external dets' diagonal
elements (``diag_elements_batched``); the host orchestrates and reads one
scalar per sample.  The device PT of the JAX package (``device=True``,
devpt.py) folds into this path and raises ValueError.

Over a mesh (``mesh=``, a parallel.dist.Mesh; every rank calls the same
function) each rank generates the connections of its contiguous slice of
the references (semistochastic: of each sample's compressed references,
drawn identically on every rank from the one shared seed); the
per-external-det sums are merged locally, sent to the det's owner rank
(an all_to_all with uneven splits) and merged there before they are
squared; the owner computes the diagonal elements and the sums are
all-reduced.  The result equals the serial one up to the order of the
sums (ref: hci.f90:1482-1520, the reference's split of the sample
references across cores).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import setalg
from ..ops.alias import sample_alias, setup_alias_np
from ..parallel.dist import check_mesh, det_owner, route_by_owner
from .connect import count_doubles, generate_connections
from .sparseham import diag_elements_batched, ts_diag_elements
from ..utils import timers
from ..utils.timers import phase


def _f64(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def _diag(system, up, dn) -> torch.Tensor:
    """Diagonal elements of external dets (time-symmetrized when the
    system is)."""
    if system.time_sym:
        return ts_diag_elements(system.table, up, dn, system.norb, system.z)
    return diag_elements_batched(system.table, up, dn, system.norb)


def _merge_by_owner(mesh, cu, cd, terms):
    """Merge duplicate candidates and sum their terms: locally, then (over
    a mesh) at each det's owner rank.  Returns (up, dn, sums) of the dets
    this rank owns (all of them without a mesh)."""
    cu, cd, terms, _ = setalg.unique_dets(cu, cd, terms)
    if mesh is None:
        return cu, cd, terms
    cu, cd, terms = route_by_owner(mesh, cu, cd, terms)
    cu, cd, terms, _ = setalg.unique_dets(cu, cd, terms)
    return cu, cd, terms


def _total(mesh, x: torch.Tensor) -> float:
    """A scalar summed over the mesh's ranks."""
    return float(x if mesh is None else mesh.all_reduce(x.reshape(1))[0])


def second_order_pt(system, up, dn, wts, var_energy: float, eps_pt: float,
                    verbose: bool = True, batch: int = 2048, mesh=None):
    """Deterministic screened PT-2.  up/dn: sorted variational dets [n, W]
    (int64 words); wts: [n] coefficients of the state.  Returns
    (delta_e2, n_connected).  mesh: see the module docstring.

    Traced (utils/timers): span "pt.run", ended by the host reading the
    energy (a synchronize), with counters pt_candidates (screened
    connections generated, duplicates included) and pt_connected."""
    check_mesh(mesh)
    verbose = verbose and (mesh is None or mesh.rank == 0)
    dev = system.device
    with phase("Deterministic 2nd-order PT correction", enabled=verbose,
               name="pt.run"):
        up, dn = up.to(dev), dn.to(dev)
        wts = _f64(wts, dev)
        coeffs = wts.abs()
        coeffs = torch.where(coeffs == 0.0, 1e-300, coeffs)
        cu, cd, h, ref = generate_connections(system, up, dn, eps_pt / coeffs,
                                              batch=batch, mesh=mesh)
        timers.count("pt_candidates", len(cu))
        cu_u, cd_u, (num,) = _merge_by_owner(mesh, cu, cd, [h * wts[ref]])
        # connections counted as the reference does: unique candidates
        # plus the references themselves (ref:
        # find_important_connected_dets); over a mesh each rank counts the
        # dets it owns
        ru, rd = up, dn
        if mesh is not None:
            mine = det_owner(up, dn, mesh.size) == mesh.rank
            ru, rd = up[mine], dn[mine]
        uu, _, _, _ = setalg.unique_dets(torch.cat([cu_u, ru]),
                                         torch.cat([cd_u, rd]))
        n_connected = int(_total(mesh, torch.tensor(
            float(len(uu)), dtype=torch.float64, device=dev)))
        ext = setalg.setdiff_dets(cu_u, cd_u, up, dn)
        diag_e = _diag(system, cu_u[ext], cd_u[ext])
        delta_e2 = _total(mesh, torch.sum(num[ext] ** 2
                                          / (var_energy - diag_e)))
        timers.count("pt_connected", n_connected)
    if verbose:
        print(f"Number of connected dets={n_connected}", flush=True)
        print(f"2nd-order PT energy lowering={delta_e2:26.9f}", flush=True)
    return delta_e2, n_connected


@dataclasses.dataclass
class StochasticPTResult:
    pt_diff: float
    std_dev: float
    n_samples: int
    e_tot: float


def second_order_pt_alias(system, up, dn, wts, var_energy: float,
                          eps_pt: float, eps_pt_big: float, n_mc: int,
                          target_error: float, pt_big: float,
                          seed: int = 0, max_samples: int = 10 ** 6,
                          min_samples: int = 10, verbose: bool = True,
                          mesh=None) -> StochasticPTResult:
    """Semistochastic difference estimator (ref: hci.f90:1314).

    Each sample draws n_mc references iid with p ~ |c| (a torch.Generator
    on the system's device seeded with `seed`), compresses duplicates to
    (i, w_i), generates connections a with |H_ai c_i| > eps_pt and sums
      term1[a] = sum_i H_ai c_i w_i / p_i
      term2[a] = sum_i (H_ai c_i)^2 ((n_mc - 1) w_i / p_i - (w_i / p_i)^2)
    and the same restricted to |H_ai c_i| > eps_pt_big; the estimate is
      sum_{a not in V} [term1^2 + term2 - term1_big^2 - term2_big]
        / (E - H_aa) / (n_mc (n_mc - 1)).
    Samples accumulate by Welford until the error is below target_error
    (after min_samples).  mesh: see the module docstring; every rank gets
    the same sample energies, so every rank stops at the same sample."""
    check_mesh(mesh)
    verbose = verbose and (mesh is None or mesh.rank == 0)
    dev = system.device
    up, dn = up.to(dev), dn.to(dev)
    wts = _f64(wts, dev)
    absw = wts.abs()
    prob = absw / absw.sum()
    J, q = setup_alias_np(prob.cpu().numpy())
    J = torch.as_tensor(J.astype(np.int64), device=dev)
    q = torch.as_tensor(q, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    coeffs = torch.where(absw == 0.0, 1e-300, absw)

    mean, M2, nsamp, var = 0.0, 0.0, 0, np.inf
    for _ in range(max_samples):
        idx = sample_alias(gen, J, q, n_mc).to(torch.int64)
        uniq, counts = torch.unique(idx, return_counts=True)
        w_over_p = counts.to(torch.float64) / prob[uniq]
        cu, cd, h, ref = generate_connections(system, up[uniq], dn[uniq],
                                              eps_pt / coeffs[uniq], mesh=mesh)
        hc = h * wts[uniq][ref]
        wop = w_over_p[ref]
        t1 = hc * wop
        t2 = hc ** 2 * ((n_mc - 1) * wop - wop ** 2)
        big = hc.abs() > eps_pt_big
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        t1b = torch.where(big, t1, zero)
        t2b = torch.where(big, t2, zero)
        cu_u, cd_u, (T1, T2, T1b, T2b) = _merge_by_owner(
            mesh, cu, cd, [t1, t2, t1b, t2b])
        ext = setalg.setdiff_dets(cu_u, cd_u, up, dn)
        dex = _diag(system, cu_u[ext], cd_u[ext])
        contrib = (T1[ext] ** 2 + T2[ext] - T1b[ext] ** 2 - T2b[ext]) \
            / (var_energy - dex)
        e_sample = _total(mesh, torch.sum(contrib)) / (n_mc * (n_mc - 1))

        nsamp += 1
        d = e_sample - mean
        mean += d / nsamp
        M2 += d * (e_sample - mean)
        var = M2 / (nsamp * (nsamp - 1)) if nsamp > 1 else np.inf
        if verbose:
            err = np.sqrt(var) if np.isfinite(var) else 0.0
            print(f"Sample, E_2pt_now, E_2pt estimate, total energy="
                  f"{nsamp:6d}{e_sample:15.9f}{mean:12.8f}"
                  f"{var_energy + pt_big + mean:15.8f} +-{err:12.8f}",
                  flush=True)
        if nsamp >= min_samples and var < target_error ** 2:
            break
    return StochasticPTResult(pt_diff=mean, std_dev=float(np.sqrt(var)),
                              n_samples=nsamp,
                              e_tot=var_energy + pt_big + mean)


def estimate_n_connections(system, up, dn, wts, eps: float,
                           n_sample: int = 100) -> int:
    """Sampled estimate of the total screened connection count (ref:
    semistoch.f90 estimate_n_connections:2606): doubles counted exactly
    for up to n_sample evenly spaced references, singles from the
    orbital-symmetry multiplicities."""
    dev = system.device
    n = len(up)
    take = torch.as_tensor(
        np.linspace(0, n - 1, min(n, n_sample)).astype(np.int64), device=dev)
    coeffs = _f64(wts, dev)[take].abs()
    coeffs = torch.where(coeffs == 0.0, 1e-300, coeffs)
    n_emit, _, _ = count_doubles(
        system.heatbath, up.to(dev)[take], dn.to(dev)[take], eps / coeffs,
        torch.full((len(take),), float("inf"), dtype=torch.float64,
                   device=dev),
        nup=system.nup, ndn=system.ndn)
    per_ref = float(n_emit.sum()) / len(take)
    if system.has_singles:
        sym = system.orb_sym_arr.cpu().numpy()
        vals, counts = np.unique(sym, return_counts=True)
        mult = dict(zip(vals.tolist(), counts.tolist()))
        avg_targets = (float(np.mean([mult[s] - 1 for s in sym.tolist()]))
                       if len(sym) else 0.0)
        per_ref += system.nelec * max(avg_targets, 0.0)
    return int(per_ref * n)


def free_memory_bytes(device=None) -> int:
    """Free memory where the connections will live: the card's free
    memory for a CUDA device, else MemAvailable from /proc/meminfo (ref:
    get_free_memory, tools.f90:1134)."""
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[0])
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def do_pt(system, up, dn, wts, diag, var_energy: float, eps_var: float,
          eps_pt: float, eps_pt_big: float = -1.0, target_error: float = -1.0,
          n_mc: int = -1, n_max_connections: int = 40_000_000,
          seed: int = 0, verbose: bool = True,
          eps_pt_big_energy: float | None = None, mesh=None,
          max_pt_samples: int = 10 ** 6, device: bool = False):
    """PT entry point: deterministic if the estimated connection count fits,
    else semistochastic with an auto-chosen eps_pt_big (ref: hci.f90
    do_pt:4148).

    n_max_connections <= 0: sized from free memory (~48 bytes per
    connection; ref hci.f90:629-640).  eps_pt_big_energy: a previous
    run's deterministic part at this eps_pt_big, reused instead of
    recomputed.  Returns dict(pt, pt_err, e_tot, mode, ...)."""
    if device:
        raise ValueError("device=True (devpt) folds into this path: call "
                         "do_pt on a system that lives on the card")
    check_mesh(mesh)
    verbose = verbose and (mesh is None or mesh.rank == 0)
    if n_max_connections <= 0:
        n_max_connections = int(free_memory_bytes(system.device) * 0.4 / 48)
        if verbose:
            print(f"n_max_connections auto-sized from free memory: "
                  f"{n_max_connections}", flush=True)
    n_est = estimate_n_connections(system, up, dn, wts, eps_pt)
    if verbose:
        print(f"If eps_pt={eps_pt:.4e} estimated number of connections to "
              f"variational wavefn={n_est}", flush=True)

    if n_est < n_max_connections and eps_pt_big <= 0:
        pt, n_conn = second_order_pt(system, up, dn, wts, var_energy, eps_pt,
                                     verbose=verbose, mesh=mesh)
        if verbose:
            print(f"Variational energy={var_energy:26.9f}")
            print(f"Total energy={var_energy + pt:26.9f}", flush=True)
        return dict(pt=pt, pt_err=0.0, e_tot=var_energy + pt,
                    mode="deterministic", n_connected=n_conn)

    if eps_pt_big <= 0:
        eps_pt_big = eps_pt
        while n_est >= n_max_connections:
            eps_pt_big = 1.1 * eps_pt_big * (n_est / n_max_connections) ** 0.75
            if eps_pt_big >= eps_var:
                break
            n_est = estimate_n_connections(system, up, dn, wts, eps_pt_big)

    if eps_pt_big_energy is not None:
        pt_big, n_conn = float(eps_pt_big_energy), 0
        if verbose:
            print(f"Reusing deterministic part eps_pt_big_energy="
                  f"{pt_big:.9f}", flush=True)
    elif eps_pt_big < eps_var:
        pt_big, n_conn = second_order_pt(system, up, dn, wts, var_energy,
                                         eps_pt_big, verbose=verbose,
                                         mesh=mesh)
    else:
        pt_big, n_conn = 0.0, 0

    n_mc = n_mc if n_mc > 0 else 200
    target_error = target_error if target_error > 0 else 1e-4
    res = second_order_pt_alias(system, up, dn, wts, var_energy, eps_pt,
                                eps_pt_big, n_mc, target_error, pt_big,
                                seed=seed, verbose=verbose,
                                max_samples=max_pt_samples, mesh=mesh)
    pt_total = pt_big + res.pt_diff
    if verbose:
        print(f"Variational energy={var_energy:26.9f}")
        print(f"2nd-order PT energy lowering={pt_total:26.9f} "
              f"+-{res.std_dev:12.9f}")
        print(f"Total energy={var_energy + pt_total:26.9f} "
              f"+-{res.std_dev:12.9f}", flush=True)
    return dict(pt=pt_total, pt_err=res.std_dev, e_tot=var_energy + pt_total,
                mode="semistochastic", pt_big=pt_big, pt_diff=res.pt_diff,
                n_samples=res.n_samples, n_connected=n_conn)
