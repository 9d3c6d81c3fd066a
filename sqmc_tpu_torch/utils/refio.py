"""Reference-format restart-artifact interop (SURVEY 5.4; port of
sqmc_tpu/utils/refio.py).

Readers AND writers for the reference's checkpoint files, so caches
generated by either code restart the other:

* ``wf_eps_var=<eps>`` - the HCI variational wavefunction cache,
  Fortran UNFORMATTED sequential records (gfortran 4-byte markers):
  [i4 ndets][int128 dets_up][int128 dets_dn][f64 wts(ndets,n_states)
  column-major][f64 energies(n_states)]  (ref: hci.f90:602-625 write,
  :194-259 read; det type ik = 128-bit integer, types.f90:16-44).

* ``psit_connections`` - Psi_T's connected dets with precomputed
  local-energy pieces, text (ref write: semistoch.f90:79-134, read:
  do_walk.f90:687-878): header `ndet_psi_t ndet_connections nup ndn
  norb 0 E_T`, a column-title line, then one line per connection
  `occ_up(nup) occ_dn(ndn) e_loc_num e_loc_den` with 1-based orbital
  lists; Psi_T members are the rows with |e_loc_den| > 1e-12.

* ``dtm_projector`` - the deterministic-space Hamiltonian, text
  (ref write: do_walk.f90:964-1011, read: :887-939): header `n_imp nnz
  dtm_energy`, per-row upper-triangular nonzero counts, n_imp lines
  `i occ_up occ_dn`, then nnz lines `col_index H_value` (1-based,
  row-major upper triangular INCLUDING the diagonal; the reference
  multiplies by -tau on read).

All readers/writers use n_core_orb = 0 (frozen cores are materialized
into the occupation lists).  File work is host numpy: det words come
back as int64 arrays (the port's convention; the bits are the file's),
and writers take int64 or uint64 words, arrays or tensors.  The files are
byte-identical to the JAX package's for the same data.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import dets as dets_mod


# ---------------------------------------------------------------------------
# Fortran unformatted helpers
# ---------------------------------------------------------------------------

def _read_record(f) -> bytes:
    head = f.read(4)
    if len(head) < 4:
        raise EOFError("truncated Fortran record")
    (n,) = struct.unpack("<i", head)
    payload = f.read(n)
    tail = f.read(4)
    if struct.unpack("<i", tail)[0] != n:
        raise IOError("corrupt Fortran record markers")
    return payload


def _write_record(f, payload: bytes):
    f.write(struct.pack("<i", len(payload)))
    f.write(payload)
    f.write(struct.pack("<i", len(payload)))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


_u64 = dets_mod.host_u64


def _i128_to_words(buf: bytes, n: int, W: int) -> np.ndarray:
    """n little-endian int128 values -> packed int64 [n, W]."""
    raw = np.frombuffer(buf, dtype="<u8").reshape(n, 2)
    if W < 2 and np.any(raw[:, W:] != 0):
        raise ValueError("determinant uses orbitals beyond norb words")
    out = np.zeros((n, W), np.uint64)
    out[:, : min(W, 2)] = raw[:, : min(W, 2)]
    return out.view(np.int64)


def _words_to_i128(words: np.ndarray) -> bytes:
    n, W = words.shape
    if W > 2:
        raise ValueError("int128 reference format holds at most 127 "
                         "orbitals (ref types.f90 bits_per_word=127)")
    raw = np.zeros((n, 2), "<u8")
    raw[:, :W] = words
    return raw.tobytes()


# ---------------------------------------------------------------------------
# wf_eps_var (unformatted)
# ---------------------------------------------------------------------------

def read_wf_eps_var(path: str, norb: int):
    """-> (up [n,W], dn [n,W], wts [n,n_states], energies [n_states])."""
    W = dets_mod.n_words(norb)
    with open(path, "rb") as f:
        (ndets,) = struct.unpack("<i", _read_record(f))
        up = _i128_to_words(_read_record(f), ndets, W)
        dn = _i128_to_words(_read_record(f), ndets, W)
        wbuf = _read_record(f)
        n_states = len(wbuf) // 8 // ndets
        wts = np.frombuffer(wbuf, dtype="<f8").reshape(
            (ndets, n_states), order="F").copy()
        energies = np.frombuffer(_read_record(f), dtype="<f8").copy()
    return up, dn, wts, energies


def write_wf_eps_var(path: str, up, dn, wts, energies):
    wts = np.asarray(_host(wts), np.float64)
    if wts.ndim == 1:
        wts = wts[:, None]
    with open(path, "wb") as f:
        _write_record(f, struct.pack("<i", len(up)))
        _write_record(f, _words_to_i128(_u64(up)))
        _write_record(f, _words_to_i128(_u64(dn)))
        _write_record(f, np.asarray(wts, "<f8").tobytes(order="F"))
        _write_record(f, np.asarray(_host(energies), "<f8").tobytes())


# ---------------------------------------------------------------------------
# occupied-orbital list <-> packed det helpers (1-based lists)
# ---------------------------------------------------------------------------

def _occs_to_det(occs, norb: int) -> np.ndarray:
    return dets_mod.det_from_orbs([o - 1 for o in occs], norb)


def _det_to_occs(words: np.ndarray, norb: int) -> list:
    return [o + 1 for o in dets_mod.orbs_from_det(words, norb)]


# ---------------------------------------------------------------------------
# psit_connections (text)
# ---------------------------------------------------------------------------

def read_psit_connections(path: str, nup: int, ndn: int, norb: int):
    """-> dict(ct_up, ct_dn, ct_num, ct_den, psit_up, psit_dn,
    psit_coef, e_trial)."""
    with open(path) as f:
        head = f.readline().split()
        n_conn = int(head[1])
        e_trial = float(head[6]) if len(head) > 6 else np.nan
        f.readline()  # column titles
        W = dets_mod.n_words(norb)
        cu = np.zeros((n_conn, W), np.int64)
        cd = np.zeros((n_conn, W), np.int64)
        num = np.zeros(n_conn)
        den = np.zeros(n_conn)
        for i in range(n_conn):
            t = f.readline().split()
            cu[i] = _occs_to_det([int(x) for x in t[:nup]], norb)
            cd[i] = _occs_to_det([int(x) for x in t[nup:nup + ndn]], norb)
            num[i] = float(t[nup + ndn])
            den[i] = float(t[nup + ndn + 1])
    member = np.abs(den) > 1e-12
    return dict(ct_up=cu, ct_dn=cd, ct_num=num, ct_den=den,
                psit_up=cu[member], psit_dn=cd[member],
                psit_coef=den[member], e_trial=e_trial)


def write_psit_connections(path: str, ct_up, ct_dn, ct_num, ct_den,
                           nup: int, ndn: int, norb: int,
                           hamiltonian_type: str = "chem"):
    ct_up, ct_dn = _u64(ct_up).view(np.int64), _u64(ct_dn).view(np.int64)
    ct_num = np.asarray(_host(ct_num), np.float64)
    ct_den = np.asarray(_host(ct_den), np.float64)
    keep = np.abs(ct_num) > 1e-10     # ref drops tiny numerators
    n_psit = int(np.sum(np.abs(ct_den) > 1e-12))
    e_t = ct_num[0] / ct_den[0] if ct_den[0] != 0 else 0.0
    with open(path, "w") as f:
        f.write(f"{n_psit:8d}{int(np.sum(keep)):12d}{nup:4d}{ndn:4d}"
                f"{norb:6d}{0:3d}{e_t:15.8f} ndet_psi_t, "
                "ndet_connections_nonzero, nup-n_core_orb, "
                "ndn-n_core_orb, norb, 0, E_T\n")
        f.write("orb_up          orb_dn           e_loc_num"
                "            e_loc_den\n")
        for i in np.nonzero(keep)[0]:
            ou = _det_to_occs(ct_up[i], norb)
            od = _det_to_occs(ct_dn[i], norb)
            f.write("".join(f"{o:4d}" for o in ou + od) +
                    f"{ct_num[i]:22.15f}{ct_den[i]:19.15f}\n")


# ---------------------------------------------------------------------------
# dtm_projector (text)
# ---------------------------------------------------------------------------

def read_dtm_projector(path: str, nup: int, ndn: int, norb: int,
                       device="cuda"):
    """-> (imp_up [n,W], imp_dn [n,W] host int64 arrays, SparseHam on
    `device`) with H in the upper-triangular-including-diagonal layout
    converted to the framework's (strict upper COO + diag) form."""
    import torch
    from ..algo.sparseham import SparseHam

    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        pos += n
        return out

    n_imp = int(take(1)[0])
    nnz = int(take(1)[0])
    # optional dtm_energy + trailing comment words before the counts:
    # counts are the next n_imp INTEGER tokens; skip non-integer tokens
    while True:
        tok = tokens[pos]
        try:
            int(tok)
            break
        except ValueError:
            pos += 1
    counts = np.array([int(x) for x in take(n_imp)], np.int64)
    W = dets_mod.n_words(norb)
    iu = np.zeros((n_imp, W), np.int64)
    idn = np.zeros((n_imp, W), np.int64)
    for _ in range(n_imp):
        t = take(1 + nup + ndn)
        ind = int(t[0]) - 1
        iu[ind] = _occs_to_det([int(x) for x in t[1:1 + nup]], norb)
        idn[ind] = _occs_to_det([int(x) for x in t[1 + nup:]], norb)
    cols = np.zeros(nnz, np.int64)
    vals = np.zeros(nnz)
    for k in range(nnz):
        t = take(2)
        cols[k] = int(t[0]) - 1
        vals[k] = float(t[1])
    rows = np.repeat(np.arange(n_imp), counts)
    diag = np.zeros(n_imp)
    on_diag = rows == cols
    diag[rows[on_diag]] = vals[on_diag]
    off = ~on_diag
    def on(x):
        return torch.as_tensor(x, device=device)

    return iu, idn, SparseHam(n=n_imp, rows=on(rows[off]), cols=on(cols[off]),
                              vals=on(vals[off]), diag=on(diag))


def write_dtm_projector(path: str, imp_up, imp_dn, H, nup: int, ndn: int,
                        norb: int, energy: float = 0.0):
    n = H.n
    h_rows, h_cols = _host(H.rows), _host(H.cols)
    imp_up, imp_dn = _u64(imp_up).view(np.int64), _u64(imp_dn).view(np.int64)
    order = np.lexsort((h_cols, h_rows))
    r = np.concatenate([h_rows[order], np.arange(n)])
    c = np.concatenate([h_cols[order], np.arange(n)])
    v = np.concatenate([_host(H.vals)[order], _host(H.diag)])
    order2 = np.lexsort((c, r))
    r, c, v = r[order2], c[order2], v[order2]
    counts = np.bincount(r, minlength=n)
    with open(path, "w") as f:
        f.write(f" {n} {len(v)} {energy:.8f} number of deterministic "
                "dets, number of nonzero deterministic Hamiltonian "
                "elements, ground state energy within deterministic "
                "space\n")
        f.write("".join(f"{int(x):8d}" for x in counts) + "\n")
        for i in range(n):
            ou = _det_to_occs(imp_up[i], norb)
            od = _det_to_occs(imp_dn[i], norb)
            f.write(f" {i + 1} " +
                    " ".join(str(o) for o in ou + od) + "\n")
        for k in range(len(v)):
            f.write(f" {int(c[k]) + 1} {v[k]:.15g}\n")
