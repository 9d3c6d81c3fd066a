"""The continuous-time chains of the exponential projector in ct_mode
"hubbardk" (K7): plain PyTorch version and the wrapper around the hand
CUDA kernel (csrc/ctchain.cu).

Port of the hubbardk branch of the JAX generation's _ct_chain
(sqmc_tpu/algo/walk.py:1089; ref: move_uniform_exponential_projector,
do_walk.f90:3803, the deterministic-diagonal variant).  Each spawn slot
starts at its parent det (``up_w``, ``dn_w``, [S, W] int64) and, where
``slot_valid``, runs moves i = 0, 1, ... until its time crosses ``tau``,
its proposal dies or it has made ``n_moves`` moves.  Move i reads the six
uniforms u[i, :, slot] of the [n_moves, 6, S] float64 buffer of
:func:`draw_uniforms`:

  * the time to the next jump, -log(max(u0, TINY)) / rate, wrapped by
    remainder(., tau) on move 0 (the child weight already carries the
    conditioning 1 - exp(-tau rate));
  * the segment factor exp(seg (E_T - H_ii + rate)) of the det the chain
    sits on, seg = tau - t where the jump crosses tau, else the time to
    the jump; H_ii is slater.diag_elements' formula in float64;
  * unless it crossed, the jump: the occupied up orbital p (u1), the
    occupied dn orbital q (u2), the empty up orbital r (u3), each uniform
    over its ascending list; s = kmap3[(p norb + q) norb + r] by momentum
    conservation; the chain dies where s is occupied, and otherwise takes
    the factor -(-1)^(n_up + n_dn) (every |H_ij| = U/N, so the thinning
    factor is minus the element's sign; n the occupied orbitals strictly
    between p and r, q and s) and moves to the excited det.

A chain still running after ``n_moves`` moves is zeroed.  Returns (up
[S, W], dn [S, W], f [S] float64 chain factor, ok [S] bool, n_jumps,
n_cut): the jumps taken over all chains and the chains zeroed for running
past ``n_moves``, 0-d float64 device tensors (no host sync).  A slot that
is not drawn keeps its parent's words, factor 0 and flag false.

:func:`chain` dispatches on the device of ``up_w``: a CPU tensor takes
:func:`chain_plain` with :func:`hubbardk_move`; a CUDA tensor launches the
kernel (built from the source on first use, ops/cudabuild.py) or raises.
Both read the one uniform buffer, so the random stream is the same on
either path.  The kernel's words, flags and counters equal the plain
version's; its factor differs only by the order of H_ii's sums.
:func:`chain_plain` takes the move as an argument: algo/walk.py runs the
heg and generic modes' moves through it on every device.
"""

from __future__ import annotations

import ctypes

import torch

from .. import dets
from ..systems.chem import slater
from . import cudabuild
from .hbspawn import in_window, parity_sign

F64, I32, I64 = torch.float64, torch.int32, torch.int64
TINY = 1e-30
MAX_WORDS = 2                        # words a spin the kernel takes
_SOURCE = "ctchain.cu"
_PREFIX = "sqmc_ct_chain"

launches = 0                         # kernel launches since reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def draw_uniforms(gen: torch.Generator, n_moves: int, S: int,
                  device) -> torch.Tensor:
    """[n_moves, 6, S] float64 uniforms: n_moves draws of torch.rand((6,
    S)) from ``gen``, each into its row, in order (the stream of a loop
    that draws each move's six rows as it goes)."""
    u = torch.empty((n_moves, 6, S), dtype=F64, device=device)
    for i in range(n_moves):
        u[i].uniform_(0.0, 1.0, generator=gen)
    return u


def hubbardk_move(kmap3: torch.Tensor, norb: int, nup: int, ndn: int):
    """The hubbardk jump of each chain, as chain_plain's ``move``."""
    def move(cu, cd, bits_cu, bits_cd, u6, sl):
        zero = torch.zeros((), dtype=F64, device=cu.device)
        occ_u = dets.occ_orbitals(bits_cu, nup)
        occ_d = dets.occ_orbitals(bits_cd, ndn)
        unocc_u = dets.occ_orbitals(1 - bits_cu, norb - nup)
        p = occ_u[sl, (u6[1] * nup).to(I64).clamp(max=nup - 1)]
        q = occ_d[sl, (u6[2] * ndn).to(I64).clamp(max=ndn - 1)]
        r = unocc_u[sl, (u6[3] * (norb - nup)).to(I64).clamp(
            max=norb - nup - 1)]
        s_ = kmap3[(p * norb + q) * norb + r]
        s_occ = dets.get_orb(cd, s_)
        cu_cnt = dets.count_below(cu, p, r) - in_window(p, p, r)
        cd_cnt = dets.count_below(cd, q, s_) - in_window(q, q, s_)
        jump_f = torch.where(s_occ, zero, -parity_sign(cu_cnt + cd_cnt))
        nxt_up = dets.set_orb(dets.clear_orb(cu, p), r)
        nxt_dn = dets.set_orb(dets.clear_orb(cd, q), s_)
        return jump_f, nxt_up, nxt_dn
    return move


def chain_plain(u, up_w, dn_w, slot_valid, table, rate, tau, e_trial,
                norb: int, move):
    """Every slot's chain as vectorized moves over all slots (see the
    module's docstring).  ``move(cu, cd, bits_cu, bits_cd, u6, sl)``
    returns each slot's jump factor (0: the chain dies), up and dn words
    after the jump; ``table`` the IntegralTable of H_ii; rate, tau,
    e_trial 0-d float64 tensors."""
    S = up_w.shape[0]
    dev = up_w.device
    cu, cd = up_w, dn_w
    one = torch.ones((), dtype=F64, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)
    f = torch.where(slot_valid, one, zero)
    t = torch.zeros(S, dtype=F64, device=dev)
    done = ~slot_valid
    n_jumps = torch.zeros(S, dtype=I32, device=dev)
    sl = torch.arange(S, device=dev)
    for i in range(u.shape[0]):
        u6 = u[i]
        t_inc = -torch.log(u6[0].clamp(min=TINY)) / rate
        if i == 0:
            t_inc = torch.remainder(t_inc, tau)     # conditioned on >= 1 jump
        t_new = t + t_inc
        cross = t_new > tau
        bits_cu = dets.to_bits(cu, norb)
        bits_cd = dets.to_bits(cd, norb)
        diag_cur = slater.diag_elements(table, bits_cu, bits_cd)
        seg = torch.where(cross, tau - t, t_inc)
        seg_f = torch.exp(seg * (e_trial - diag_cur + rate))
        jump_f, nxt_up, nxt_dn = move(cu, cd, bits_cu, bits_cd, u6, sl)
        act = ~done
        dead = jump_f == 0.0
        f = torch.where(act, f * seg_f * torch.where(cross, one, jump_f), f)
        jumped = act & ~cross & ~dead
        n_jumps += jumped
        cu = torch.where(jumped[:, None], nxt_up, cu)
        cd = torch.where(jumped[:, None], nxt_dn, cd)
        t = torch.where(act, t_new, t)
        done = done | (act & (cross | dead))
    f = torch.where(done, f, zero)
    return (cu, cd, f, slot_valid & (f != 0.0), n_jumps.sum(dtype=F64),
            (~done).sum(dtype=F64))


def _bind(lib):
    fn = lib.sqmc_ct_chain
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    shape = lib.sqmc_ct_chain_shape
    shape.restype = ctypes.c_int
    shape.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]


def build():
    """Compile csrc/ctchain.cu (see ops/cudabuild.py); returns the path."""
    return cudabuild.build(_SOURCE)


def launch_shape(S: int, n_words: int, norb: int, device) -> dict:
    """How the kernel launches for S slots of dets of n_words words a spin
    over norb orbitals on ``device`` (a card): blocks, threads a block and
    resident blocks per SM."""
    dev = torch.device(device)
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        err = lib.sqmc_ct_chain_shape(S, n_words, norb, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError("ct_chain launch shape: "
                           + cudabuild.error_string(lib, _PREFIX, err))
    return dict(zip(("blocks", "threads", "blocks_per_sm"), list(out)))


def _expect(t, dtype, shape, dev, name):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, not {type(t).__name__}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on {dev}, "
                         f"not {tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def chain_cuda(u, up_w, dn_w, slot_valid, table, kmap3, rate, tau, e_trial,
               norb: int, nup: int, ndn: int):
    """Launch the kernel on CUDA tensors (checks everything it is handed:
    the tensors go to csrc/ctchain.cu's sqmc_ct_chain in its order)."""
    global launches
    dev = up_w.device
    if up_w.dim() != 2 or up_w.dtype != I64:
        raise ValueError("up_w must be [S, W] int64")
    S, W = up_w.shape
    if not 1 <= W <= MAX_WORDS:
        raise ValueError(f"the kernel takes 1 to {MAX_WORDS} words a spin, "
                         f"not {W}")
    if not (64 * (W - 1) < norb <= 64 * W and 0 < nup < norb
            and 0 < ndn <= norb):
        raise ValueError(f"norb {norb}, nup {nup}, ndn {ndn} do not fit "
                         f"{W} words a spin")
    if not 0 < S < 2**31:
        raise ValueError("need between 1 and 2^31 - 1 slots")
    if u.dim() != 3 or u.shape[0] < 1:
        raise ValueError("u must be [n_moves, 6, S] with n_moves >= 1")
    x = lambda t, dt, sh, name: _expect(t, dt, sh, dev, name)  # noqa: E731
    ins = [x(u, F64, (u.shape[0], 6, S), "u"),
           x(up_w, I64, (S, W), "up_w"), x(dn_w, I64, (S, W), "dn_w"),
           x(slot_valid, torch.bool, (S,), "slot_valid"),
           x(table.h, F64, (norb, norb), "table.h"),
           x(table.direct, F64, (norb, norb), "table.direct"),
           x(table.exchange, F64, (norb, norb), "table.exchange"),
           x(kmap3, I64, (norb ** 3,), "kmap3"),
           x(rate, F64, (), "rate"), x(tau, F64, (), "tau"),
           x(e_trial, F64, (), "e_trial")]
    counts = torch.zeros(2, dtype=F64, device=dev)
    outs = [torch.empty((S, W), dtype=I64, device=dev),
            torch.empty((S, W), dtype=I64, device=dev),
            torch.empty(S, dtype=F64, device=dev),
            torch.empty(S, dtype=torch.bool, device=dev), counts]
    with torch.cuda.device(dev):
        lib = cudabuild.load(_SOURCE, _PREFIX, _bind, dev.index)
        err = lib.sqmc_ct_chain(
            S, W, norb, nup, ndn, u.shape[0], float(table.core_energy),
            (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins]),
            (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs]),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("ct_chain kernel launch failed: "
                           + cudabuild.error_string(lib, _PREFIX, err))
    launches += 1
    return (*outs[:4], counts[0], counts[1])


def chain(u, up_w, dn_w, slot_valid, table, kmap3, rate, tau, e_trial,
          norb: int, nup: int, ndn: int):
    """The hubbardk chains of every slot: (up, dn, f, ok, n_jumps, n_cut).
    u: [n_moves, 6, S] float64 (draw_uniforms); up_w, dn_w: [S, W] int64
    parent words; slot_valid: [S] bool; table: the IntegralTable; kmap3:
    [norb^3] int64; rate, tau, e_trial: 0-d float64 tensors."""
    if up_w.device.type == "cpu":
        return chain_plain(u, up_w, dn_w, slot_valid, table, rate, tau,
                           e_trial, norb, hubbardk_move(kmap3, norb, nup, ndn))
    if up_w.device.type != "cuda":
        raise ValueError(f"ct_chain has no path for device {up_w.device}")
    return chain_cuda(u, up_w, dn_w, slot_valid, table, kmap3, rate, tau,
                      e_trial, norb, nup, ndn)
