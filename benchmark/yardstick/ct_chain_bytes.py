"""The compulsory bytes of one generation's CT chain (the exponential
projector's continuous-time spawn, sqmc_tpu_torch/algo/walk.py
_ct_chain), from the walk's shapes and tables.

Counted, each once:

  * a drawn slot's parent det, read: 2 W int64 words (W words a spin);
  * its outputs, written: the child's 2 W int64 words, its float64 chain
    factor and its one-byte flag;
  * the momentum map kmap3, read once a generation.

over the slots the generation drew (the spawn total, at most the
capacity), not the capacity.  Not counted: the six float64 uniforms a
slot and a move (a kernel could draw them itself), the rereads of every
move after the first (ct_max_jumps moves run over every slot), the
diagonals and occupied lists recomputed each move, and the slots past
the spawn total.  So a share of this bound stays under 100% however fast
a later chain gets.
"""


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def compulsory(slots: float, n_words: int, tables) -> float:
    """Bytes one generation's chain must move for `slots` spawn slots at
    `n_words` words a spin, with the walk's tables (WalkTables)."""
    per_slot = 2 * n_words * 8 + (2 * n_words * 8 + 8 + 1)
    return slots * per_slot + _nbytes(getattr(tables, "kmap3", None))
