"""PyTorch/CUDA port of the MIG serving workload, held against ``repro``.

The JAX package ``repro`` is the reference; this package computes the same
functions in PyTorch, with every Pallas TPU kernel on its path rewritten by
hand for Hopper (``kernels/csrc``).  It imports neither JAX nor ``repro``.
Importing it builds and loads nothing: kernels compile at first use.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
