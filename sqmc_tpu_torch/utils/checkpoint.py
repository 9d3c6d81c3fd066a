"""Checkpoint / resume artifacts (port of sqmc_tpu/utils/checkpoint.py).

  * the variational wavefunction cache ``wf_eps_var=<eps>`` written after
    the variational stage and read on startup to skip it entirely (ref:
    hci.f90:194-259, 602-625): an .npz with dets, weights, energies and
    diagonal elements;
  * per-block walker-state checkpoints for the walk (the reference had no
    mid-walk checkpoint).

Both files are the JAX package's npz layouts - det words as uint64, the
C(T) index as int32 - so a file saved by either package loads in the
other.  The JAX package's PRNG key has no counterpart here: a zero key is
written in its place, and this package's generator state rides along
under ``torch_rng`` (the JAX loader ignores it).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def wf_var_filename(eps_var: float, directory: str = ".") -> str:
    """Reference-compatible name: wf_eps_var=<eps in es7.2e1>
    (ref: hci.f90 write(fmt,'(es7.2e1)'))."""
    return os.path.join(directory, f"wf_eps_var={eps_var:7.2e}".replace(
        "e-0", "E-0").replace("e+0", "E+0"))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_wf_var(path: str, up, dn, wts, energies, diag):
    """Write the variational wavefunction to `path`(.npz); det words
    (tensors or arrays, int64 or uint64) are stored as uint64."""
    from ..dets import host_u64
    np.savez_compressed(_npz(path), up=host_u64(up), dn=host_u64(dn),
                        wts=_host(wts), energies=_host(energies),
                        diag=_host(diag))


def load_wf_var(path: str):
    """The cache as a dict of host arrays (det words int64 with the stored
    bits), or None when `path`(.npz) does not exist."""
    p = _npz(path)
    if not os.path.exists(p):
        return None
    z = np.load(p)
    return dict(up=z["up"].view(np.int64), dn=z["dn"].view(np.int64),
                wts=z["wts"], energies=z["energies"], diag=z["diag"])


def save_walker_state(path: str, state):
    """Write a WalkState (host copy of the device state) to `path`(.npz)."""
    def a(x, dtype=None):
        x = x.detach().cpu().numpy()
        return x if dtype is None else x.astype(dtype)

    extra = {}
    if state.rng_state is not None:
        extra["torch_rng"] = a(state.rng_state)
    np.savez_compressed(
        _npz(path), up=a(state.up).view(np.uint64), dn=a(state.dn).view(np.uint64),
        wt=a(state.wt), init=a(state.init), imp=a(state.imp),
        diag=a(state.diag), ct=a(state.ct, np.int32), nwalk=a(state.nwalk),
        key=np.zeros(2, np.uint32), e_trial=a(state.e_trial),
        e_est=a(state.e_est), tau=a(state.tau),
        reweight=a(state.reweight_factor_inv), reached=a(state.reached_target),
        equilibrated=a(state.equilibrated), enbc=a(state.e_num_blkabs_cum),
        edbc=a(state.e_den_blkabs_cum), enb=a(state.e_num_blk),
        edb=a(state.e_den_blk), w_abs=a(state.w_abs_gen), step=a(state.step),
        **extra)


def load_walker_state(path: str, cfg, device="cuda"):
    """Read a walker checkpoint of either package as a WalkState on
    `device`, in cfg's state precision."""
    from ..algo.walk import WalkState
    from ..convert import walk_state_from_numpy

    z = np.load(_npz(path))
    n = z["imp"].shape[0]
    fields = dict(
        up=z["up"], dn=z["dn"], wt=z["wt"], init=z["init"], imp=z["imp"],
        diag=z["diag"],
        # no ct in old checkpoints: -2 = repaired at the next block's start
        ct=z["ct"] if "ct" in z.files else np.full(n, -2, np.int32),
        nwalk=z["nwalk"], e_trial=z["e_trial"], e_est=z["e_est"], tau=z["tau"],
        reweight_factor_inv=z["reweight"], reached_target=z["reached"],
        equilibrated=z["equilibrated"], e_num_blkabs_cum=z["enbc"],
        e_den_blkabs_cum=z["edbc"], e_num_blk=z["enb"], e_den_blk=z["edb"],
        w_abs_gen=z["w_abs"], overflow=np.asarray(False),
        step=z["step"] if "step" in z.files else np.asarray(0))
    st = walk_state_from_numpy(WalkState(**fields), f32_state=cfg.f32_state,
                               device=device)
    if "torch_rng" in z.files:
        st = st._replace(rng_state=torch.as_tensor(z["torch_rng"]))
    return st
