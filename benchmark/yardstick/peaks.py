"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
its 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float32": 67e12,             # outside the tensor cores
         "float64": 34e12}


def bound_us(nbytes: float, flops: float = 0.0, dt: str = "float32"):
    """The least time for the work: the larger of bytes / HBM rate and
    operations / peak rate (us), and which of the two bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e6, flops / FLOPS[dt] * 1e6
    return max(tb, to), ("bytes" if tb >= to else "operations")
