"""Hubbard density-matrix block basis (`hubbarddm`) (port of
sqmc_tpu/systems/hubbard/dmbasis.py).

The reference's patch-density-matrix renormalized basis (ref: hubbard.f90
density_matrix_2by2:7836 - ED of a 2x2 patch embedded in a 12-site cross /
16-site square, reduced density matrix of the patch, per-(nup,ndn)-sector
eigenbasis; hamiltonian_hubbard_dm:1986 and
make_hamiltonian_tables_two_blocks:1648 - lattice states as strings of 256
per-block DM eigenstates with tabulated one- and two-block terms).

The basis change is an explicit orthogonal rotation R = (x)_b u_b from
real-space determinants (block-major site numbering, so per-block bit
nibbles factorize with only the analytic up/dn interleaving sign) to
products of per-block DM eigenstates.  H_dm = R^T H R as dense
contractions on the device; truncating each block to its top-k DM
eigenstates gives the renormalized (variational) basis.  With k=256 the
rotation is exact and the spectrum identical to real space - the test
oracle.  The sparse H and the embedding's ground state come from the
port's ``build_sparse_ham`` and ``davidson`` on `device`; the index
bookkeeping is host numpy.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ... import dets
from ...algo.davidson import davidson
from ...algo.sparseham import build_sparse_ham
from ...ops import setalg

# the 12-site cross embedding of the central 2x2 patch (sites 0-3; ref
# diagram at hubbard.f90:7844-7850, renumbered 0-based)
CROSS_BONDS = [(5, 6), (5, 0), (6, 1), (4, 0), (0, 1), (1, 7), (4, 8),
               (8, 2), (0, 2), (1, 3), (7, 9), (2, 3), (3, 9), (2, 10),
               (3, 11), (10, 11)]
CROSS_NSITES = 12

_POP4 = np.array([bin(x).count("1") for x in range(16)])


def _popcount(x: np.ndarray) -> np.ndarray:
    """Set bits of small non-negative ints (nibble table)."""
    x = np.asarray(x, np.int64)
    out = np.zeros_like(x)
    while np.any(x):
        out += _POP4[x & 0xF]
        x = x >> 4
    return out


def _enumerate_dets(nsites, nup, ndn, device):
    """Every det of the sector in sorted key order, int64 [n, 1] tensors."""
    from .system import enumerate_dets
    up, dn = enumerate_dets(nsites, nup, ndn)
    up = torch.as_tensor(up, device=device)
    dn = torch.as_tensor(dn, device=device)
    so = setalg.lexsort_dets(up, dn)
    return up[so], dn[so]


def _bond_table(bonds, nsites, t, U, device):
    """IntegralTable for an arbitrary bond list (hopping -t, on-site U)."""
    from ..chem.integrals import IntegralTable, n_eri, pair_index, quad_index

    h = np.zeros((nsites, nsites))
    for a, b in bonds:
        h[a, b] = h[b, a] = -t
    eri = np.zeros(n_eri(nsites))
    p = np.arange(nsites)
    eri[quad_index(pair_index(p, p), pair_index(p, p))] = U
    return IntegralTable.from_dense_arrays(h, eri, 0.0,
                                           np.ones(nsites, np.int32),
                                           device=device)


def patch_density_matrix(bonds, nsites, t, U, nup_emb, ndn_emb,
                         device="cuda"):
    """256x256 reduced density matrix (numpy) of the 2x2 patch (sites 0-3)
    in the embedding lattice's ground state (ref: density_matrix_2by2).
    Patch state index m = up_nibble<<4 | dn_nibble (ref bit layout,
    hubbard.f90:2023-2031)."""
    table = _bond_table(bonds, nsites, t, U, device)
    up, dn = _enumerate_dets(nsites, nup_emb, ndn_emb, device)
    H = build_sparse_ham(table, up, dn, nup_emb, ndn_emb, nsites)
    _, vec = davidson(H, n_states=1)
    psi = np.asarray(vec[:, 0])

    u_int = up[:, 0].cpu().numpy()
    d_int = dn[:, 0].cpu().numpy()
    m = ((u_int & 0xF) << 4) | (d_int & 0xF)
    # patch sites come FIRST in the global ordering, so tracing the
    # environment needs no fermion reordering beyond the up/dn interleave:
    # sign from moving patch-dn operators past environment-up operators
    env_u = u_int >> 4
    env_d = d_int >> 4
    n_env_up = _popcount(env_u)
    n_patch_dn = _popcount(d_int & 0xF)
    sign = np.where((n_patch_dn * n_env_up) % 2 == 0, 1.0, -1.0)
    psi_s = psi * sign

    env_key = (env_u << 32) | env_d
    order = np.lexsort((m, env_key))
    m_s = m[order]
    amp_s = psi_s[order]
    key_s = env_key[order]
    rho = np.zeros((256, 256))
    n = len(key_s)
    boundaries = np.nonzero(np.diff(key_s))[0] + 1
    for beg, end in zip(np.concatenate([[0], boundaries]),
                        np.concatenate([boundaries, [n]])):
        mm = m_s[beg:end]
        aa = amp_s[beg:end]
        rho[np.ix_(mm, mm)] += np.outer(aa, aa)
    return rho


def _patch_sectors():
    """(nup[m], ndn[m]) for the 256 patch states."""
    m = np.arange(256)
    return _POP4[(m >> 4) & 0xF], _POP4[m & 0xF]


def block_rotation(rho):
    """Per-(nup,ndn)-sector eigenbasis of the patch DM, eigenvalues
    descending within each sector.  Returns (u [256,256] orthogonal with
    u[:, j] the j-th DM state in the patch-occupation basis,
    sector_up [256], sector_dn [256], weights [256])."""
    nup, ndn = _patch_sectors()
    u = np.zeros((256, 256))
    w_out = np.zeros(256)
    su = np.zeros(256, np.int64)
    sd = np.zeros(256, np.int64)
    col = 0
    for a in range(5):
        for b in range(5):
            rows = np.nonzero((nup == a) & (ndn == b))[0]
            blk = rho[np.ix_(rows, rows)]
            w, v = np.linalg.eigh(blk)
            order = np.argsort(-w)
            for j in order:
                u[rows, col] = v[:, j]
                w_out[col] = w[j]
                su[col] = a
                sd[col] = b
                col += 1
    return u, su, sd, w_out


def _block_major_bonds(l_x, l_y, pbc=True):
    """Hopping bonds of the l_x x l_y lattice in block-major numbering:
    site = 4*block + (2*dx + dy), block = (bx * (l_y//2) + by)."""
    assert l_x % 2 == 0 and l_y % 2 == 0, "dm basis needs even dimensions"
    nby = l_y // 2

    def site(ix, iy):
        bx, dx = divmod(ix, 2)
        by, dy = divmod(iy, 2)
        return 4 * (bx * nby + by) + 2 * dx + dy

    bonds = set()
    for ix in range(l_x):
        for iy in range(l_y):
            for ddx, ddy in ((1, 0), (0, 1)):
                jx, jy = ix + ddx, iy + ddy
                ok = jx < l_x and jy < l_y
                if not ok and pbc:
                    if (ddx and l_x > 2) or (ddy and l_y > 2):
                        jx %= l_x
                        jy %= l_y
                        ok = True
                if ok:
                    a, b = site(ix, iy), site(jx, jy)
                    bonds.add((min(a, b), max(a, b)))
    return sorted(bonds)


def dm_basis_hamiltonian(l_x, l_y, t, U, nup, ndn, u_rot, sector_up,
                         sector_dn, keep_per_sector=None, pbc=True,
                         device="cuda"):
    """Dense H in the (possibly truncated) DM product basis, a float64
    tensor on `device`.

    keep_per_sector: optional number of DM states kept per (nup,ndn)
    sector of each block (None = all 256 -> exact rotation).

    Returns (H_dm, basis) where basis[J] = tuple of kept per-block DM
    state columns."""
    nblocks = (l_x * l_y) // 4
    bonds = _block_major_bonds(l_x, l_y, pbc)
    table = _bond_table(bonds, l_x * l_y, t, U, device)
    up, dn = _enumerate_dets(l_x * l_y, nup, ndn, device)
    M = build_sparse_ham(table, up, dn, nup, ndn, l_x * l_y).dense()
    n = len(up)

    # kept columns per sector
    nup_m, ndn_m = _patch_sectors()
    kept_map = {}
    for a in range(5):
        for b in range(5):
            cols = np.nonzero((sector_up == a) & (sector_dn == b))[0]
            if keep_per_sector is not None:
                cols = cols[:keep_per_sector]
            kept_map[(a, b)] = cols

    # per-real-det block patch indices + interleave sign
    u_int = up[:, 0].cpu().numpy()
    d_int = dn[:, 0].cpu().numpy()
    m_blocks = np.empty((n, nblocks), np.int64)
    for bidx in range(nblocks):
        ub = (u_int >> (4 * bidx)) & 0xF
        db = (d_int >> (4 * bidx)) & 0xF
        m_blocks[:, bidx] = (ub << 4) | db
    nup_b = nup_m[m_blocks]                     # [n, nblocks]
    ndn_b = ndn_m[m_blocks]
    # sign of reordering global (all-up, all-dn) into per-block (up, dn):
    # each block's dn operators cross the up operators of LATER blocks
    later_up = np.cumsum(nup_b[:, ::-1], axis=1)[:, ::-1] - nup_b
    crossings = np.sum(ndn_b * later_up, axis=1)
    sign = np.where(crossings % 2 == 0, 1.0, -1.0)

    # enumerate dm product basis: per-block sector assignments follow the
    # real-space enumeration (same sectors), so build R column blocks by
    # grouping real dets by their sector signature
    groups = {}
    for i in range(n):
        groups.setdefault(tuple(zip(nup_b[i], ndn_b[i])), []).append(i)

    basis = []
    col_blocks = []
    for s, rows in groups.items():
        rows = np.asarray(rows)
        # kept columns for each block sector
        block_cols = [kept_map[sec] for sec in s]
        if any(len(c) == 0 for c in block_cols):
            continue
        # R_rows: [len(rows), prod(dims)] = product of per-block factors
        R = sign[rows][:, None] * np.ones((len(rows), 1))
        for bidx, cols in enumerate(block_cols):
            fac = u_rot[m_blocks[rows, bidx]][:, cols]   # [rows, dims_b]
            R = (R[:, :, None] * fac[:, None, :]).reshape(len(rows), -1)
        col_blocks.append((rows, R))
        for combo in itertools.product(*[c.tolist() for c in block_cols]):
            basis.append(combo)

    ndm = sum(R.shape[1] for _, R in col_blocks)
    Rfull = np.zeros((n, ndm))
    off = 0
    for rows, R in col_blocks:
        Rfull[rows, off:off + R.shape[1]] = R
        off += R.shape[1]
    Rt = torch.as_tensor(Rfull, device=device)
    return Rt.T @ M @ Rt, basis


def make_hubbarddm_dense(l_x, l_y, t, U, nup, ndn, keep_per_sector=None,
                         embedding="cross", pbc=True, device="cuda"):
    """One-stop hubbarddm construction on `device`: patch DM from the
    embedding ED, block rotation, dense H in the (truncated) DM basis,
    wrapped as a ToySystem for the dense walk engine / ED."""
    from ..toy import ToySystem

    if embedding == "cross":
        bonds, ns = CROSS_BONDS, CROSS_NSITES
    else:
        raise ValueError(f"unknown embedding {embedding}")
    # closest filling on the embedding (ref: hubbard.f90:7916-7918)
    nup_emb = max(int(nup * ns / (l_x * l_y)), 1)
    ndn_emb = max(int(ndn * ns / (l_x * l_y)), 1)
    rho = patch_density_matrix(bonds, ns, t, U, nup_emb, ndn_emb,
                               device=device)
    u_rot, su, sd, w = block_rotation(rho)
    H_dm, basis = dm_basis_hamiltonian(l_x, l_y, t, U, nup, ndn, u_rot,
                                       su, sd, keep_per_sector, pbc,
                                       device=device)
    sys_ = ToySystem(ham=H_dm, kind="hubbarddm")
    return sys_, dict(rho=rho, u=u_rot, weights=w, basis=basis)
