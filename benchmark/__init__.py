"""The benchmark of sqmc_tpu_torch on an NVIDIA H100 (see README.md)."""
