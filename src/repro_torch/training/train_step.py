"""The training step and train-state construction (the reference's
``repro/training/train_step.py``), on PyTorch autograd.

The state is ``{"params", "opt": {"m", "v", "step"}}``; params are leaf
tensors that require grad.  The step runs the loss and its backward on the
plain path and updates params and moments in place.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


def init_train_state(generator: torch.Generator | None, cfg: ModelConfig,
                     moments_dtype: torch.dtype | None = None,
                     device: str | torch.device | None = None) -> dict:
    """Params drawn from ``generator`` (on its device, or on ``device``),
    made to require grad, and zero AdamW moments (f32 unless
    ``moments_dtype`` says otherwise)."""
    params, _ = registry.init_params(generator, cfg, device)
    params = tree_map(lambda p: p.requires_grad_(), params)
    return {"params": params,
            "opt": init_opt_state(params, moments_dtype or torch.float32)}


def _microbatches(batch: dict, n: int) -> list[dict]:
    size = next(iter(batch.values())).shape[0]
    if size % n:
        raise ValueError(f"batch {size} is not a multiple of {n} "
                         f"microbatches")
    parts = {k: torch.chunk(v, n) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def accumulate_grads(params: dict, cfg: ModelConfig, batch: dict,
                     n_microbatches: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss and its backward over ``n_microbatches`` slices of the
    batch, accumulating into each param's ``.grad``; returns the loss and
    aux loss, each the f32 sum of the slices' over ``n_microbatches``."""
    loss = aux = torch.zeros((), dtype=torch.float32,
                             device=tree_leaves(params)[0].device)
    for mb in _microbatches(batch, n_microbatches):
        mb_loss, out = registry.loss_fn(params, cfg, mb)
        (mb_loss / n_microbatches).backward()
        loss = loss + mb_loss.detach() / n_microbatches
        aux = aux + out.aux_loss.detach() / n_microbatches
    return loss, aux


def train_step(state: dict, batch: dict, *, cfg: ModelConfig,
               opt_cfg: AdamWConfig, n_microbatches: int = 1
               ) -> tuple[dict, dict]:
    """One optimizer step; returns (state, metrics) with the state updated
    in place and metrics ``loss``, ``aux_loss``, ``grad_norm`` and ``lr``
    as 0-d tensors on the state's device.

    ``n_microbatches > 1`` accumulates gradients: the batch is split on dim
    0 and each slice's loss / n is differentiated in turn, so saved
    activations scale with the microbatch.  Gradients accumulate in each
    param's ``.grad``, in the param's dtype, as in the reference's scan;
    the loss and aux loss are summed in f32 in the same order.
    """
    params = state["params"]
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    loss, aux = accumulate_grads(params, cfg, batch, n_microbatches)
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), params)
    _, _, info = adamw_update(params, grads, state["opt"], opt_cfg)
    for p in leaves:
        p.grad = None
    return state, {"loss": loss, "aux_loss": aux, **info}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    n_microbatches: int = 1):
    opt_cfg = opt_cfg or AdamWConfig()
    return functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg,
                             n_microbatches=n_microbatches)
