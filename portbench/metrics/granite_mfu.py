"""Whole step of the hybrid MoE cell: ``mfu``'s reading (the model FLOPs
the traced batches' requests asked for, the model module's
``request_flops``: matrix products, the SSD at its least work, each
attention layer's pairs up to each token's position, the router and the
k routed and the shared experts, the head for the logits used; no
padding; over the traced window, as a share of the card's bf16 peak)."""

from portbench.metrics.mfu import read  # noqa: F401
