"""The compulsory bytes of one launch of K3b, the heat-bath proposal
kernel (sqmc_tpu_torch/csrc/hbselect.cu, entry sqmc_hb_spawn), from the
walk's shapes and tables.

Counted, each once:

  * a slot's parent det, read: 2 W int64 words (W words a spin);
  * a slot's outputs, written: the child's 2 W int64 words, its float64
    spawn factor and its one-byte flag;
  * the tables the launch is handed, read once a launch: R2, the
    heat-bath rows (start, count, row sum) and their alias entries (q,
    own, partner), and with singles the singles' rows (u_rowsum, the
    singles alias, and sng_pack under a float32 state or h, the float64
    singles rows and u_table under a float64 one).

over the slots the generation drew (the spawn total, at most the
launch's capacity), not the capacity.  Not counted: the five float64
uniforms a slot (a kernel could draw them itself), the slots past the
spawn total, and every reread (K3's R2 rows, once per occupied
spin-orbital a pass).  The tables, counted whole, are 0.6-0.7 MB in the
walk cells, under a tenth of the count; the rest is what any kernel with
this interface moves, so a share of this bound stays under 100% however
fast a later kernel gets.
"""

HB_TABLES = ("R2", "hb_alias_q", "hb_rs_own", "hb_rs_partner", "hb_start",
             "hb_count", "hb_rowsum")
SINGLES = ("u_rowsum", "u_alias_q", "u_alias_J")
SINGLES_F64 = ("h", "sing_dir", "sing_exch")


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def compulsory(slots: float, n_words: int, tables, singles: bool,
               f32_state: bool) -> float:
    """Bytes one launch must move for `slots` spawn slots at `n_words`
    words a spin, with the walk's tables (WalkTables)."""
    per_slot = 2 * n_words * 8 + (2 * n_words * 8 + 8 + 1)
    nbytes = sum(_nbytes(getattr(tables, k, None)) for k in HB_TABLES)
    if singles:
        nbytes += sum(_nbytes(getattr(tables, k, None)) for k in SINGLES)
        if f32_state:
            nbytes += _nbytes(getattr(tables, "sng_pack", None))
        else:
            tb = getattr(tables, "table", None)
            nbytes += sum(_nbytes(getattr(tb, k, None)) for k in SINGLES_F64)
            nbytes += _nbytes(getattr(tables, "u_table", None))
    return slots * per_slot + nbytes
