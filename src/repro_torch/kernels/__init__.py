"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain versions.

Importing this package builds nothing; ``build.build()`` compiles the
sources with nvcc and each wrapper loads its library at first CUDA call.
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *inputs: torch.Tensor) -> None:
    """Raise if autograd would have to differentiate through the kernel.

    The kernels have no backward, as the reference's ``pallas_call`` has no
    VJP (``jax.grad`` through it raises).  A CUDA launch fills a buffer the
    graph cannot see, so without this check its gradient would be dropped
    silently; the CPU path refuses too, so both devices agree.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name} has no backward: call it on inputs that do not require "
            f"grad, or under torch.no_grad(); to train, use the plain path "
            f"(attn_impl/ssm_impl='xla')")
