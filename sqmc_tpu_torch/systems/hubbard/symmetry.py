"""Square-lattice space-group symmetrization for momentum-space Hubbard
(port of sqmc_tpu/systems/hubbard/symmetry.py).

ref: more_tools.f90:4209-5017 (C4/reflection maps on the k-lattice,
generate_fourfold_k_configs(_efficient)), hubbard.f90
symmetry_reduce_hubbardk:9061, hamiltonian_hubbard_k_space_sym:2927.

The symmetry group of the Q=(0,0), A1 sector is the 16-element set
{C4^i} x {reflection about y=-x} x {spin inversion}; a symmetrized basis
state is the phase-weighted sum over the orbit of a representative
determinant, with quantum numbers z (spin inversion / time reversal) and
p (parity).  Everything here is batched numpy on the host over det lists
- orbits are materialized as [n, 16] det arrays.  Det words are int64
(the port's convention); the orbit representative is the member with the
largest key in UNSIGNED word order, so a det with bit 63 set compares as
the reference's unsigned words do.
"""

from __future__ import annotations

import numpy as np

from ... import dets
from .system import hubbard_k_vectors


def k_symmetry_maps(l_x: int, l_y: int):
    """(c4_map [3, nsites], reflection_map [nsites]) as orbital-index
    permutations in the energy-sorted orbital ordering (ref:
    more_tools.f90:4209-4420).  C4: (kx,ky)->(ky,-kx); reflection about
    y=-x: (kx,ky)->(-ky,-kx); both modulo the reciprocal lattice."""
    if l_x != l_y:
        raise ValueError("fourfold symmetry requires l_x == l_y")
    rel, _ = hubbard_k_vectors(l_x, l_y)
    mod = np.array([2 * l_x, 2 * l_y])
    # canonical residues for lookup
    keys = {tuple(k): i for i, k in enumerate((rel % mod).tolist())}

    def find(kvecs):
        out = np.empty(len(kvecs), np.int32)
        for i, k in enumerate((kvecs % mod).tolist()):
            out[i] = keys[tuple(k)]
        return out

    c4 = np.empty((3, len(rel)), np.int32)
    cur = rel.copy()
    for i in range(3):
        cur = np.stack([cur[:, 1], -cur[:, 0]], axis=1)
        c4[i] = find(cur)
    refl = find(np.stack([-rel[:, 1], -rel[:, 0]], axis=1))
    return c4, refl


def _relabel(occ: np.ndarray, perm: np.ndarray):
    """Apply an orbital permutation to occupied-orbital lists.
    occ: [n, ne] sorted orbital indices.  Returns (new_occ sorted [n, ne],
    sign [n]) where sign is the fermion permutation parity of resorting
    (ref: relabel_efficient, more_tools.f90)."""
    mapped = perm[occ]
    order = np.argsort(mapped, axis=1, kind="stable")
    new_occ = np.take_along_axis(mapped, order, axis=1)
    # permutation parity of `order` per row
    n, ne = occ.shape
    sign = np.ones(n)
    for i in range(ne):
        for j in range(i + 1, ne):
            sign *= np.where(order[:, i] > order[:, j], -1.0, 1.0)
    return new_occ, sign


_words = dets.host_u64


def _occ_lists(words: np.ndarray, norb: int, ne: int) -> np.ndarray:
    shifts = np.arange(64, dtype=np.uint64)
    bits = ((words[:, :, None] >> shifts) & np.uint64(1)).reshape(
        len(words), -1)[:, :norb]
    out = np.empty((len(words), ne), np.int64)
    for i in range(len(words)):
        out[i] = np.nonzero(bits[i])[0][:ne]
    return out


def _pack(occ: np.ndarray, norb: int) -> np.ndarray:
    n_w = dets.n_words(norb)
    out = np.zeros((len(occ), n_w), np.uint64)
    B = dets.BITS_PER_WORD
    for k in range(occ.shape[1]):
        w = occ[:, k] // B
        b = occ[:, k] % B
        out[np.arange(len(occ)), w] |= np.uint64(1) << b.astype(np.uint64)
    return out


def orbit(up, dn, nup: int, ndn: int, norb: int,
          c4_map: np.ndarray, refl_map: np.ndarray, z: int, p: int):
    """All 16 symmetry images of each det with their phases.

    Returns (o_up [n,16,W], o_dn [n,16,W] int64 words, phases [n,16]) in
    the reference's op order: C4^0..3, then x spin-inversion, then
    x reflection, then x both (ref: generate_fourfold_k_configs)."""
    up, dn = _words(up), _words(dn)
    n = len(up)
    occ_u = _occ_lists(up, norb, nup)
    occ_d = _occ_lists(dn, norb, ndn)

    ident = np.arange(norb)
    perms = [ident, c4_map[0], c4_map[1], c4_map[2]]
    u4, d4, ph4 = [], [], []
    for perm in perms:
        nu, su = _relabel(occ_u, perm)
        nd, sd = _relabel(occ_d, perm)
        u4.append(nu)
        d4.append(nd)
        ph4.append(su * sd)

    o_up, o_dn, phases = [], [], []
    for i in range(4):                      # C4^i
        o_up.append(u4[i]); o_dn.append(d4[i]); phases.append(ph4[i])
    for i in range(4):                      # spin inversion (z)
        o_up.append(d4[i]); o_dn.append(u4[i]); phases.append(z * ph4[i])
    for i in range(8):                      # reflection (p)
        nu, su = _relabel(o_up[i], refl_map)
        nd, sd = _relabel(o_dn[i], refl_map)
        o_up.append(nu); o_dn.append(nd)
        phases.append(p * phases[i] * su * sd)

    W = dets.n_words(norb)
    ou = np.empty((n, 16, W), np.uint64)
    od = np.empty((n, 16, W), np.uint64)
    ph = np.empty((n, 16))
    for g in range(16):
        ou[:, g] = _pack(o_up[g], norb)
        od[:, g] = _pack(o_dn[g], norb)
        ph[:, g] = phases[g]
    return ou.view(np.int64), od.view(np.int64), ph


def _key(u, d):
    """Scalar sort key for W=1 dets (orbit members), in unsigned order."""
    u, d = _words(u), _words(d)
    return (u[..., 0].astype(np.object_) << 64) | d[..., 0].astype(np.object_)


def representatives(up, dn, nup, ndn, norb, c4_map, refl_map, z, p):
    """(rep_up, rep_dn, norm, is_rep): the orbit representative (max key
    member, unsigned order), the group-theoretic norm sum_{g: g det = det}
    phi_g, and whether each input det IS its own representative with
    nonzero norm (ref: symmetry_reduce_hubbardk keeps only such dets)."""
    up, dn = _words(up), _words(dn)
    ou, od, ph = orbit(up, dn, nup, ndn, norb, c4_map, refl_map, z, p)
    keys = _key(ou, od)                       # [n, 16] object ints
    self_key = _key(up[:, None, :], dn[:, None, :])  # [n, 1]
    norm = np.sum(np.where(keys == self_key, ph, 0.0), axis=1)
    gmax = np.argmax(keys, axis=1)
    n = len(up)
    rep_up = ou[np.arange(n), gmax]
    rep_dn = od[np.arange(n), gmax]
    is_rep = (keys[np.arange(n), gmax] == self_key[:, 0]) & \
        (np.abs(norm) > 1e-12)
    return rep_up, rep_dn, norm, is_rep


def symmetrized_matrix_element(table, rep_a_up, rep_a_dn, rep_b_up,
                               rep_b_dn, nup, ndn, norb, c4_map, refl_map,
                               z, p):
    """<A_sym|H|B_sym> between symmetrized states of representatives a, b
    (the elements are evaluated on the table's device).

    With projector P = (1/16) sum_g phi_g g and |A> = P|a>/||P a||,
    <A|H|B> = sqrt(n_b/n_a) * sum over b's DISTINCT orbit members m (one
    coset representative each, phase phi_m) of H(a, m) - the stabilizer
    multiplicity n_b cancels one norm factor
    (ref: hamiltonian_hubbard_k_space_sym, hubbard.f90:2927-2989)."""
    import torch
    from ..chem import slater

    a_up = _words(rep_a_up)[None].view(np.int64)
    a_dn = _words(rep_a_dn)[None].view(np.int64)
    b_up = _words(rep_b_up)[None].view(np.int64)
    b_dn = _words(rep_b_dn)[None].view(np.int64)
    _, _, na, _ = representatives(a_up, a_dn, nup, ndn, norb, c4_map,
                                  refl_map, z, p)
    ou, od, ph = orbit(b_up, b_dn, nup, ndn, norb, c4_map, refl_map, z, p)
    _, _, nb, _ = representatives(b_up, b_dn, nup, ndn, norb, c4_map,
                                  refl_map, z, p)
    dev = table.device

    def bits(w):
        return dets.to_bits(torch.as_tensor(w, device=dev), norb)

    keys = _key(ou[0], od[0])
    elem = 0.0
    seen = set()
    for g in range(16):
        if keys[g] in seen:
            continue
        seen.add(keys[g])
        if np.all(a_up[0] == ou[0, g]) and np.all(a_dn[0] == od[0, g]):
            h = float(slater.diag_elements(table, bits(a_up), bits(a_dn))[0])
        else:
            h = float(slater.pair_matrix_elements(
                table, bits(a_up), bits(a_dn), bits(ou[0, g][None]),
                bits(od[0, g][None]))[0])
        elem += ph[0, g] * h
    return float(np.sqrt(np.abs(nb[0]) / np.abs(na[0])) * elem)
