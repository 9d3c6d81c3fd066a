"""Zeroth-order variational Green's function G0(w) (port of
sqmc_tpu/algo/greens.py; ref: get_zeroth_order_variational_greens_function,
hci.f90:3849).  The (N +- 1)-electron zeroth-order Hamiltonian is taken
diagonal, so no linear solve is needed:

  G0_np1(w, p, q) = <var| a_p 1/(w - (H0 - E0)) a+_q |var>
  G0_nm1(w, p, q) = <var| a+_p 1/(w - (E0 - H0)) a_q |var>

spin-summed, with the fermion signs of the blocked (up-then-dn) spin
order.  Everything runs on the system's device: the (N +- 1) dets and
their diagonal elements in one batch per spin channel, then one pass per
orbital p (a Python loop over norb) that searches the moved-back dets in
the sorted variational list (``setalg.search_dets``, flipped keys) and
adds the [n_w, m] terms into G[:, p, :] by ``index_add_`` over q.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dets as dets_mod
from ..ops import setalg
from ..systems.chem import slater


def _sign_before(bits: torch.Tensor, orb: torch.Tensor) -> torch.Tensor:
    """(-1)^(# occupied below orb) for a creation or annihilation in one
    spin channel (the blocked order keeps the channels independent)."""
    pref = torch.cumsum(bits.to(torch.int64), dim=1) - bits.to(torch.int64)
    cnt = pref.gather(1, orb[:, None])[:, 0]
    return torch.where(cnt % 2 == 0, 1.0, -1.0).to(torch.float64)


def greens_function_g0(system, up, dn, wts, e0: float, w, eta: float = 0.0):
    """Returns (G0_np1, G0_nm1), each complex128 numpy [n_w, norb, norb]
    (imaginary broadening eta; eta = 0 gives the real principal values as
    in the reference).  up / dn: the sorted variational dets."""
    norb = system.norb
    dev = system.device
    table = system.table
    up, dn = up.to(dev), dn.to(dev)
    c = torch.as_tensor(np.asarray(wts, np.float64), device=dev)
    bu, bd = dets_mod.to_bits(up, norb), dets_mod.to_bits(dn, norb)
    w = np.asarray(w, np.float64)
    wz = torch.as_tensor(w + 1j * eta if eta else w.astype(np.complex128),
                         device=dev)
    n_w = len(w)
    G_np1 = torch.zeros((n_w, norb, norb), dtype=torch.complex128, device=dev)
    G_nm1 = torch.zeros_like(G_np1)

    for bits, other, is_up in ((bu, bd, True), (bd, bu, False)):
        for add, G in ((True, G_np1), (False, G_nm1)):
            # N+1: create q (empty), then annihilate p; N-1: annihilate q
            # (occupied), then create p
            det_i, q_list = torch.nonzero(bits == (0 if add else 1),
                                          as_tuple=True)
            new_bits = bits[det_i].clone()
            new_bits[torch.arange(len(det_i), device=dev), q_list] = \
                1 if add else 0
            s_q = _sign_before(bits[det_i], q_list)
            pair = (new_bits, other[det_i]) if is_up else (other[det_i],
                                                           new_bits)
            h_ii = slater.diag_elements(table, *pair)
            for p in range(norb):
                sel = torch.nonzero(new_bits[:, p] == (1 if add else 0)
                                    ).reshape(-1)
                if len(sel) == 0:
                    continue
                back = new_bits[sel].clone()
                back[:, p] = 0 if add else 1
                s_p = _sign_before(new_bits[sel], torch.full_like(sel, p))
                bw = dets_mod.from_bits(back, norb)
                di = det_i[sel]
                k = (setalg.search_dets(up, dn, bw, dn[di]) if is_up
                     else setalg.search_dets(up, dn, up[di], bw))
                hit = k >= 0
                if not bool(hit.any()):
                    continue
                i_idx, k_idx = di[hit], k[hit]
                amp = c[i_idx] * c[k_idx] * s_q[sel][hit] * s_p[hit]
                hh = h_ii[sel][hit]
                shift = (hh - e0) if add else (e0 - hh)
                contrib = amp[None, :] / (wz[:, None] - shift[None, :])
                G[:, p, :].index_add_(1, q_list[sel][hit], contrib)
    return G_np1.cpu().numpy(), G_nm1.cpu().numpy()
