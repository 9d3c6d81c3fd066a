"""A synthetic FCIDUMP at C2 CAS(8e,26o)'s shape, made from a seed.

The C2_v2z_curve FCIDUMP the reference's C2 decks read is not in the
repository; this file stands in for its shape: the same 26 orbitals with
the C2 decks' d2h irreps and 8 electrons, with integrals drawn from a
seed.  ``chip_smoke.py`` (phases 6b and 9) and the multi-rank dry run
(``parallel/dryrun.py``) read it.
"""

from __future__ import annotations

import numpy as np

from .fcidump import n_eri, write_fcidump
from .integrals import pair_index, quad_index

# the C2_v2z_curve decks' orbital irreps (d2h labels 1..8)
C2_SYMS = [1, 5, 3, 2, 1, 7, 6, 5, 1, 2, 3, 1, 6, 7, 5, 4, 1, 5, 3, 2, 8, 5,
           1, 7, 6, 5]
C2_SCALE, C2_SEED, C2_CORE = 0.02, 26, -75.0


def _sym_mask(syms, norb):
    """Bool over the compact 8-fold two-body array: the irrep product of
    the four orbitals is not totally symmetric (d2h labels, XOR product)."""
    s0 = np.asarray(syms) - 1
    npair = norb * (norb + 1) // 2
    hi, lo = np.tril_indices(norb)
    ph, pl = np.empty(npair, int), np.empty(npair, int)
    ph[pair_index(hi, lo)], pl[pair_index(hi, lo)] = hi, lo
    qa, qb = np.tril_indices(npair)
    bad = np.zeros(npair * (npair + 1) // 2, bool)
    bad[quad_index(qa, qb)] = (s0[ph[qa]] ^ s0[pl[qa]] ^ s0[ph[qb]]
                               ^ s0[pl[qb]]) != 0
    return bad


def write_c2_fcidump(path, scale=C2_SCALE, seed=C2_SEED):
    """Write the synthetic file to `path`: 26 orbitals with the C2 decks'
    d2h irreps, 8 electrons (MS2 0); every integral whose irrep product is
    not totally symmetric is zero; the diagonal h ascends (4 occupied
    orbitals in [-2.5, -0.8], 22 virtual in [0, 3]); direct integrals
    (ii|jj) in [0.4, 0.5]; every other one- and two-body integral normal
    with standard deviation `scale`, so the HF det dominates.  Returns
    (h, eri)."""
    rng = np.random.default_rng(seed)
    norb = len(C2_SYMS)
    s0 = np.asarray(C2_SYMS) - 1
    h = rng.normal(size=(norb, norb)) * scale
    h = 0.5 * (h + h.T)
    h[s0[:, None] != s0[None, :]] = 0.0
    h[np.diag_indices(norb)] = np.sort(np.concatenate(
        [rng.uniform(-2.5, -0.8, 4), rng.uniform(0.0, 3.0, norb - 4)]))
    eri = rng.normal(size=n_eri(norb)) * scale
    eri[_sym_mask(C2_SYMS, norb)] = 0.0
    d = pair_index(np.arange(norb), np.arange(norb))
    J = 0.4 + 0.1 * rng.random((norb, norb))
    eri[quad_index(d[:, None], d[None, :])] = 0.5 * (J + J.T)
    write_fcidump(path, h, eri, C2_CORE, C2_SYMS, nelec=8, ms2=0)
    return h, eri
