"""sqmc_tpu_torch - the PyTorch/CUDA port of sqmc_tpu.

Semistochastic initiator FCIQMC with heat-bath proposals, fed by an HCI
trial wavefunction and deterministic space, and SHCI (HCI + second-order
PT), written for an NVIDIA H100 (PyTorch on the card, plus hand CUDA
kernels for the annihilation merge's segmented scan and the sparse
matvec of Davidson and the D-space projection) and runnable on the CPU
for tests.

The layout mirrors ``sqmc_tpu`` module for module (``dets``, ``ops``,
``systems``, ``algo``, ``utils``).  Conventions that differ from the JAX
package:

  * packed determinant words are ``int64`` (torch has no usable uint64);
    they sort and search on ``w ^ (1 << 63)``, the order-preserving flip
    that makes signed order equal the JAX package's unsigned order, and
    the all-ones empty-slot sentinel is ``-1``;
  * every dtype is explicit (the JAX package runs with x64 on, torch
    defaults to float32);
  * randomness comes from an explicit ``torch.Generator`` on the working
    device, seeded by the caller.

This package never imports ``jax`` or ``sqmc_tpu``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # the mesh entry point, as sqmc_tpu exports it (imported on first use)
    if name == "make_mesh":
        from .parallel.dist import make_mesh
        return make_mesh
    raise AttributeError(f"module 'sqmc_tpu_torch' has no attribute {name!r}")
