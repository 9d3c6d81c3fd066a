"""Faults planted under a cell's timed path, each of which the judge has
to catch (the CPU checks and ``control.py`` plant them; a normal run never
does).  Each takes the driver and returns the function that takes it
out again.

In a walk cell:

    unchanged  every block hands back the state it was given
    half       inside each generation, every other spawn slot left out,
               as if the spawn's launch covered half of its slots (a
               walker spawns into one slot or a few): the spawning half
               of the projector is halved.  (Doubling the rest, to keep
               the mean, would be an unbiased thinning: a noisier
               projector with the same answer, see PERF.md)
    scaled     inside each generation, every spawn's weight doubled (a
               spawn kernel with a wrong H_ij or tau; the diagonal step
               and the D-space projection keep theirs)
    altered    one walker's det written over with another's where the
               block produces it

The two inside the generation replace the spawn's proposal function of
the program's walk module and drop the captured generation, so that the
next block captures the fault with the rest.

In an SHCI cell:

    unchanged  HCI runs no iteration: the space it was given (one det)
    half       PT over every other det of the space only
    altered    E_var moved by 1 mHa where HCI returns it
    early      Davidson stops once its eigenvalue moves by less than
               1e-3 Ha (the program's own criterion is 3e-6)
"""

from __future__ import annotations


def _block(drv, wrap):
    orig = drv.block_fn
    drv.block_fn = wrap(orig)

    def undo():
        drv.block_fn = orig
    return undo


def _spawns(edit):
    """Replace the walk module's proposal with one whose spawns `edit`
    changes: edit(up_w, dn_w, factor, ok) -> (factor, ok)."""
    from sqmc_tpu_torch.algo import walk as W
    orig = W._propose

    def propose(cfg, tables, up_w, dn_w, *a):
        su, sd, fac, ok = orig(cfg, tables, up_w, dn_w, *a)
        fac, ok = edit(up_w, dn_w, fac, ok)
        return su, sd, fac, ok
    W._propose = propose
    W.release_graphs()

    def undo():
        W._propose = orig
        W.release_graphs()
    return undo


def unchanged(drv):
    def wrap(orig):
        def block(start, *a):
            out, stats = orig(start, *a)
            return start._replace(overflow=out.overflow), stats
        return block
    return _block(drv, wrap)


def half(drv):
    def edit(up_w, dn_w, fac, ok):
        import torch
        slot = torch.arange(len(ok), device=ok.device)
        return fac, ok & (slot % 2 == 0)
    return _spawns(edit)


def scaled(drv):
    return _spawns(lambda up_w, dn_w, fac, ok: (2 * fac, ok))


def altered(drv):
    def wrap(orig):
        def block(start, *a):
            out, stats = orig(start, *a)
            up, dn = out.up.clone(), out.dn.clone()
            up[1], dn[1] = up[0], dn[0]
            return out._replace(up=up, dn=dn), stats
        return block
    return _block(drv, wrap)


def _shci(drv, name, wrap):
    orig = getattr(drv, name)
    setattr(drv, name, wrap(orig))

    def undo():
        setattr(drv, name, orig)
    return undo


def shci_unchanged(drv):
    return _shci(drv, "hci_fn",
                 lambda f: lambda *a, **k: f(*a, **dict(k, max_iters=0)))


def shci_half(drv):
    def wrap(f):
        def pt(system, up, dn, wts, e_var, eps, **k):
            return f(system, up[::2], dn[::2], wts[::2], e_var, eps, **k)
        return pt
    return _shci(drv, "pt_fn", wrap)


def shci_altered(drv):
    def wrap(f):
        def hci(*a, **k):
            res = f(*a, **k)
            res.energies = res.energies + 1e-3
            return res
        return hci
    return _shci(drv, "hci_fn", wrap)


def shci_early(drv):
    from sqmc_tpu_torch.algo import hci as HCI
    orig = HCI.davidson
    HCI.davidson = lambda *a, **k: orig(*a, **dict(k, tol=1e-3))

    def undo():
        HCI.davidson = orig
    return undo


FOR = {"walk": {"unchanged": unchanged, "half": half, "scaled": scaled,
                "altered": altered},
       "shci": {"unchanged": shci_unchanged, "half": shci_half,
                "altered": shci_altered, "early": shci_early}}
