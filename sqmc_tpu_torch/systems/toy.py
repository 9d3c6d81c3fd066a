"""Toy Hamiltonian backends: `read` (dense matrix from file) and
`fictitious` (seeded random test matrix) (port of sqmc_tpu/systems/toy.py).

The reference's small-model test path (ref: hamiltonian_mod.f90:320-344
`read`, :430-473 `hamiltonian_fictitious`, :476-700
`hamiltonian_diagonalize`, read_psi_trial.f90:11-59) for the dense-vector
walk engine (algo/densewalk.py): determinants are plain indices
0..ndet-1, the Hamiltonian is a dense float64 [N, N] tensor on the
system's device, and the trial / guiding wavefunction is a dense vector.

The fictitious matrix uses a bit-exact replica of the reference's 48-bit
"rannyu" linear congruential generator (ref: rannyu.f90:1-87), so equal
seeds build equal matrices across codes.  The generator is s <- M s mod
2^48, so the whole stream is s0 M^k: :func:`rannyu_stream` draws it in
bulk as a wrapping uint64 cumulative product (2^48 divides 2^64, so the
low 48 bits are exact).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_RANNYU_MULT = 34522712143931          # 11**13 (ref: rannyu.f90:8)
_MASK48 = (1 << 48) - 1


class Rannyu:
    """NYU 48-bit linear congruential RNG: R_{n+1} = M*R_n mod 2^48
    (ref: rannyu.f90:1-9).  Seed is 4 twelve-bit integers; the last is
    forced odd (ref setrn, rannyu.f90:11-21)."""

    def __init__(self, seed=(0, 0, 0, 1)):
        s = [int(x) & 0xFFF for x in seed]
        s[3] = 2 * (s[3] // 2) + 1
        self.state = (s[0] << 36) | (s[1] << 24) | (s[2] << 12) | s[3]

    def __call__(self) -> float:
        self.state = (self.state * _RANNYU_MULT) & _MASK48
        return self.state / float(1 << 48)

    def savern(self):
        s = self.state
        return ((s >> 36) & 0xFFF, (s >> 24) & 0xFFF,
                (s >> 12) & 0xFFF, s & 0xFFF)


def rannyu_stream(rng: Rannyu, n: int, chunk: int = 1 << 20) -> np.ndarray:
    """The next n draws of `rng` as a float64 array, bit-identical to n
    calls, advancing its state.  state_k = state_0 M^k mod 2^48, computed
    as a wrapping uint64 cumulative product in chunks."""
    out = np.empty(n, np.float64)
    pw = np.cumprod(np.full(min(chunk, max(n, 1)), _RANNYU_MULT, np.uint64))
    mask = np.uint64(_MASK48)
    state = np.uint64(rng.state)
    for beg in range(0, n, chunk):
        m = min(chunk, n - beg)
        s = (state * pw[:m]) & mask
        out[beg:beg + m] = s.astype(np.float64)    # < 2^48: exact
        state = s[-1]
    rng.state = int(state)
    return out / float(1 << 48)


@dataclasses.dataclass
class ToySystem:
    """A dense-matrix Hamiltonian over indexed basis states; `ham` and the
    spectrum are float64 tensors on the system's device."""
    ham: torch.Tensor                 # [N, N] symmetric
    kind: str                         # 'read' | 'fictitious' | 'dense' | ...
    energy_exact: float | None = None
    eigvec_exact: torch.Tensor | None = None
    eigvals: torch.Tensor | None = None

    @property
    def ndet(self):
        return self.ham.shape[0]

    @property
    def device(self):
        return self.ham.device

    def diagonalize(self, verbose: bool = False):
        """Full dense ED on the system's device + diagnostics (ref:
        hamiltonian_diagonalize, hamiltonian_mod.f90:476-700).  Returns
        (eigvals, ground vector); flips the ground vector so its dominant
        component is positive."""
        w, v = torch.linalg.eigh(self.ham)
        g = v[:, 0].clone()
        if g[torch.argmax(g.abs())] < 0:
            g = -g
        self.energy_exact = float(w[0])
        self.eigvec_exact = g
        self.eigvals = w
        if verbose:
            print(f"ndet={self.ndet:15d}")
            print("eigval=" + "".join(f"{x:10.5f}" for x in w.tolist()))
            dom = float(g.abs().max())
            print(f"Fraction of walkers on dominant det with perfect "
                  f"importance sampling and without any="
                  f"{dom ** 2:10.6f}{dom / float(g.abs().sum()):10.6f}")
        return w, g

    def tau_optimal(self, tau_multiplier: float = 1.0):
        """(tau_optimal_deterministic, tau_optimal_stochastic, tau) from
        the spectrum (ref: hamiltonian_mod.f90:549-556)."""
        if self.eigvals is None:
            self.diagonalize()
        w = self.eigvals
        lo, second, hi = float(w[0]), float(w[1]), float(w[-1])
        tau_det = 2.0 / (hi + second - 2 * lo)
        tau_sto = 1.0 / (hi - lo)
        return tau_det, tau_sto, tau_multiplier * tau_sto


def _on(ham, device) -> torch.Tensor:
    return torch.as_tensor(ham, dtype=torch.float64, device=device)


def make_read_system(path: str = "hamiltonian", device="cuda") -> ToySystem:
    """Read a dense Hamiltonian: first line ndet, then ndet rows
    (ref: hamiltonian_mod.f90:320-331)."""
    with open(path) as f:
        toks = f.read().split()
    ndet = int(toks[0])
    vals = np.asarray([float(x) for x in toks[1:1 + ndet * ndet]])
    ham = vals.reshape(ndet, ndet)
    if not np.allclose(ham, ham.T, atol=1e-12):
        raise ValueError("read Hamiltonian must be symmetric")
    return ToySystem(ham=_on(ham, device), kind="read")


def make_fictitious_system(ndet: int, bosonic: int = 1,
                           spectrum_coef: float = 1.0,
                           spectrum_power: float = 1.0,
                           ham_diag_fluc: float = 0.0,
                           ham_offdiag_fluc: float = 0.1,
                           seed=(0, 0, 0, 1), device="cuda") -> ToySystem:
    """Random test Hamiltonian on `device`, bit-identical to the reference
    for equal seeds (ref: hamiltonian_fictitious,
    hamiltonian_mod.f90:430-473):
    diag_i = spectrum_coef*(i-1)^spectrum_power + U(-.5,.5)*ham_diag_fluc,
    offdiag_ij = (sign per `bosonic`) * U * ham_offdiag_fluc/|i-j|^power,
    then the diagonal is shifted so its minimum is 0.  bosonic>=1 makes all
    off-diagonals negative (no sign problem).

    Draw order (the reference's): for i = 2..ndet, diag(i), then
    offdiag(i, j < i).  The stream is drawn in bulk and each row is filled
    by one slice; the symmetric copy is made on the device."""
    rng = Rannyu(seed)
    n_draw = (ndet - 1) + ndet * (ndet - 1) // 2
    u = rannyu_stream(rng, n_draw)
    # |i - j|^power through Python's float pow, as the reference formula
    # evaluates it element by element
    pw = np.array([float(d) ** spectrum_power for d in range(ndet)])
    low = np.zeros((ndet, ndet))              # strictly lower triangle
    diag = np.zeros(ndet)
    pos = 0
    for i in range(1, ndet):
        diag[i] = spectrum_coef * pw[i] + (u[pos] - 0.5) * ham_diag_fluc
        x = u[pos + 1:pos + 1 + i] - 0.5
        if bosonic >= 1:
            low[i, :i] = -np.abs(x) * ham_offdiag_fluc / pw[i:0:-1]
        else:
            low[i, :i] = x * ham_offdiag_fluc / pw[i:0:-1]
        pos += 1 + i
    diag -= diag.min()
    ham = _on(low, device)
    del low
    ham = ham + ham.T
    ham.diagonal().copy_(_on(diag, device))
    return ToySystem(ham=ham, kind="fictitious")


def make_dense_system(ham, device="cuda") -> ToySystem:
    """Wrap an explicit dense symmetric matrix (API convenience)."""
    return ToySystem(ham=_on(ham, device), kind="dense")


def toy_psi_t(ndet: int, iwdet, cdet):
    """Trial + guiding vectors (host numpy) from a sparse index/coef list
    (ref: read_psi_trial.f90:11-59): psi_g equals psi_t on its support and
    the constant sqrt((1-|psi_t|^2)/(ndet-n)) elsewhere; psi_t is
    normalized.  iwdet uses the reference's 1-based indexing."""
    iw = np.asarray(iwdet, np.int64) - 1
    c = np.asarray(cdet, np.float64)
    if abs(c.min()) > c.max():
        c = -c                        # dominant component positive
    norm_sq = float(np.sum(c ** 2))
    psi_g = np.full(ndet, np.sqrt(max(1 - norm_sq, 1e-300) /
                                  max(ndet - len(iw), 1)))
    psi_g[iw] = c
    psi_t = np.zeros(ndet)
    psi_t[iw] = c / np.linalg.norm(c)
    return psi_t, psi_g
