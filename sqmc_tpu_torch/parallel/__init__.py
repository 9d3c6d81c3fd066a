"""Determinant sharding over a torch.distributed process group (port of
sqmc_tpu/parallel)."""
