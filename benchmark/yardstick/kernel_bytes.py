"""Bytes and operations a call of the port's hand kernels needs, from the
call's own shapes, each input byte read once and each output written
once."""


def seg_scan(rows: int, field_bytes) -> int:
    """K1, the segmented scan: one byte of segment flag a row, each field
    read once and written once."""
    return rows + 2 * sum(rows * b for b in field_bytes)


def spmv(n: int, nnz: int, elem: int, m: int = 1):
    """K2, the SpMV over row pointers: (bytes, flops) for `nnz` stored
    entries (an int32 column and a value each), the row pointers (int64,
    n + 1) and row counts (int32), x read and y written (m columns)."""
    nbytes = nnz * (4 + elem) + (n + 1) * 8 + n * 4 + 2 * n * m * elem
    return nbytes, 2.0 * nnz * m
