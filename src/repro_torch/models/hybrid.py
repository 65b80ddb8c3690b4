"""Zamba2-style hybrid: a Mamba2 backbone and one weight-TIED attention
block applied after every ``attn_every`` Mamba2 layers (arXiv:2411.15242).

The shared block's params exist once and every application reads them
(zamba2's design: the attention block's weights are shared across all its
applications, which is why an 81-layer 7B model stays 7B).  The Mamba2
layers are stacked as ``mamba_layers`` [n_groups * attn_every] and
``mamba_tail`` [remainder], as in the reference; the port loops over groups
and layers in Python (:func:`walk`), so full-sequence attention reaches the
flash kernel and each Mamba2 mixer the SSD kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed_tokens, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm)
from repro_torch.models.module import ParamBuilder
from repro_torch.models.transformer import (DecoderOutput, _head,
                                            init_rmsnorm_stacked,
                                            layer_views, remat_layer)

#: mixer(layer params, normed x, stack name, index in the stack) -> output
Mixer = Callable[[dict, torch.Tensor, str, int], torch.Tensor]
#: attend(normed x, group) -> the shared attention's output
Attend = Callable[[torch.Tensor, int], torch.Tensor]


def _group_shape(cfg: ModelConfig) -> tuple[int, int]:
    """(full groups of ``attn_every`` Mamba2 layers, tail layers)."""
    m = max(cfg.attn_every, 1)
    if not (cfg.n_layers % m == 0 or cfg.n_layers > m):
        raise ValueError(f"{cfg.name}: a hybrid stack needs at least one "
                         f"full group of {m} layers")
    n_groups = cfg.n_layers // m
    return n_groups, cfg.n_layers - n_groups * m


def init_hybrid(generator: torch.Generator | None, cfg: ModelConfig,
                device: str | torch.device = "cpu") -> tuple[dict, dict]:
    b = ParamBuilder(generator, device)
    init_embedding(b, cfg)
    n_groups, remainder = _group_shape(cfg)
    stacked = n_groups * max(cfg.attn_every, 1)
    grp = b.sub("mamba_layers")
    ssm_lib.init_ssm(grp, cfg, stacked=stacked)
    init_rmsnorm_stacked(grp, "norm1", cfg.d_model, stacked)
    if remainder:
        tail = b.sub("mamba_tail")
        ssm_lib.init_ssm(tail, cfg, stacked=remainder)
        init_rmsnorm_stacked(tail, "norm1", cfg.d_model, remainder)
    shared = b.sub("shared_attn")
    attn.init_attention(shared, cfg)
    init_mlp(shared, cfg)
    init_rmsnorm(shared, "norm1", cfg.d_model)
    init_rmsnorm(shared, "norm2", cfg.d_model)
    init_rmsnorm(b, "final_norm", cfg.d_model)
    return b.build()


def walk(params: dict, cfg: ModelConfig, x: torch.Tensor, mixer: Mixer,
         attend: Attend) -> torch.Tensor:
    """The residual stream through the stack: each group's Mamba2 layers
    (stack ``"ssm"``, index g * attn_every + j), then the shared attention
    and MLP block; then the tail's layers (stack ``"ssm_tail"``).  Each
    Mamba2 layer and each application of the shared block is checkpointed
    while autograd records (:func:`remat_layer`), as the reference remats
    its ``mamba_block`` and ``group_body``."""
    n_groups, remainder = _group_shape(cfg)
    m = max(cfg.attn_every, 1)
    shared, eps = params["shared_attn"], cfg.norm_eps
    group_layers = layer_views(params["mamba_layers"])
    tail_layers = layer_views(params["mamba_tail"]) if remainder else []

    @remat_layer
    def mamba(x, lp, name, i):
        return x + mixer(lp, rmsnorm(x, lp["norm1"], eps), name, i)

    @remat_layer
    def shared_block(x, g):
        x = x + attend(rmsnorm(x, shared["norm1"], eps), g)
        return x + mlp(shared, rmsnorm(x, shared["norm2"], eps), cfg)

    for g in range(n_groups):
        for j in range(m):
            i = g * m + j
            x = mamba(x, group_layers[i], "ssm", i)
        x = shared_block(x, g)
    for i, lp in enumerate(tail_layers):
        x = mamba(x, lp, "ssm_tail", i)
    return x


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            last_only: bool = False) -> DecoderOutput:
    b_, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=x.device).expand(b_, s)
    shared = params["shared_attn"]
    x = walk(params, cfg, x,
             lambda lp, h, stack, i: ssm_lib.ssm_forward(lp, h, cfg),
             lambda h, g: attn.mha_full(shared, h, cfg, positions))
    if last_only:
        x = x[:, -1:]
    return DecoderOutput(logits=_head(params, cfg, x),
                         aux_loss=torch.zeros((), device=x.device))


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            caches: dict) -> tuple[torch.Tensor, dict]:
    """Prompt prefill: one forward over the padded [B,S] prompt batch that
    fills ``caches`` in place as the reference engine's replay of the prompt
    through :func:`decode_step` would, and returns the last position's
    logits [B,1,V] with the caches.  Each Mamba2 layer writes its conv
    window and SSD state (:func:`repro_torch.models.ssm.ssm_prefill`, the
    SSD on the chunk-scan kernel when ``ssm_impl == 'pallas'``) into its
    stack's cache at its index; each application g of the shared attention
    writes its K/V into ``attn_k[g]``/``attn_v[g]`` and attends over them
    (:func:`repro_torch.models.attention.mha_prefill`, on the flash kernel
    when ``attn_impl == 'pallas'``)."""
    x = embed_tokens(params, tokens, cfg)
    shared = params["shared_attn"]

    def mixer(lp, h, stack, i):
        return ssm_lib.ssm_prefill(lp, h, cfg, caches[stack]["conv"][i],
                                   caches[stack]["state"][i])

    x = walk(params, cfg, x, mixer,
             lambda h, g: attn.mha_prefill(shared, h, cfg,
                                           caches["attn_k"][g],
                                           caches["attn_v"][g]))
    return _head(params, cfg, x[:, -1:]), caches


def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: str | torch.device = "cpu") -> dict:
    """The shared block's K/V for each of its applications, [n_groups, B,
    C, KH, hd] bf16, and the Mamba2 stacks' conv and state caches (f32)."""
    n_groups, remainder = _group_shape(cfg)
    m = max(cfg.attn_every, 1)
    k, v = attn.init_kv_cache(cfg, n_groups, batch, context, device=device)
    caches = {
        "ssm": ssm_lib.init_ssm_cache(cfg, n_groups * m, batch,
                                      device=device),
        "attn_k": k, "attn_v": v,
    }
    if remainder:
        caches["ssm_tail"] = ssm_lib.init_ssm_cache(cfg, remainder, batch,
                                                    device=device)
    return caches


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                index: int | torch.Tensor, caches: dict
                ) -> tuple[torch.Tensor, dict]:
    """token: [B,1] int; index: position, an ``int`` or a 0-dim int64
    tensor on the step's device.  Returns (logits [B,1,V], caches) with the
    caches updated in place."""
    x = embed_tokens(params, token, cfg)
    shared = params["shared_attn"]

    def mixer(lp, h, stack, i):
        conv, cache_i = caches[stack]["conv"], caches[stack]["state"][i]
        out, conv_i, state_i = ssm_lib.ssm_decode_step(lp, h, conv[i],
                                                       cache_i, cfg)
        conv[i].copy_(conv_i)
        if state_i is not cache_i:          # else updated in place
            cache_i.copy_(state_i)
        return out

    x = walk(params, cfg, x, mixer,
             lambda h, g: attn.mha_decode(shared, h, cfg, caches["attn_k"][g],
                                          caches["attn_v"][g], index)[0])
    return _head(params, cfg, x), caches
