"""The hybrid MoE stack of IBM Granite 4.0-H (Hugging Face transformers'
``granitemoehybrid``): Mamba2 and attention layers, each followed by a
routed MoE and a shared expert.

Every layer i computes, with r = ``residual_multiplier``,

    x += r * mixer_i(rmsnorm(x))
    h  = rmsnorm(x);  x += r * (moe(h) + shared(h))

where mixer_i is NoPE grouped-query attention (softmax scale
``attention_multiplier``) for i in ``attn_layers`` and a Mamba2 mixer
(:mod:`repro_torch.models.ssm`) otherwise, moe is the softmax top-k router
over stacked SiLU-gated experts (:mod:`repro_torch.models.moe`; a softmax
over all experts renormalised over the top k is Granite's softmax over the
top-k logits) and shared a SwiGLU of width ``shared_ff``
(:func:`repro_torch.models.layers.mlp`).  The embedding is multiplied by
``embedding_multiplier`` and the tied head's logits divided by
``logits_scaling``.

The Mamba2 layers are stacked as ``mamba_layers``, the attention layers as
``attention_layers`` (absent where no index of ``attn_layers`` lies below
``n_layers``), the routers and experts as ``moe_layers`` and the shared
experts as ``shared_mlp``, one entry a layer; the caches hold the Mamba2
layers' conv windows and states (``ssm``), whose size is fixed, and the
attention layers' K/V (``k``, ``v``), which fill with the context.  The
prefill and ``forward`` route every token alone (dropless,
:func:`~repro_torch.models.moe.moe_tokens`), as Granite does; a captured
decode step runs the capacity dispatch at one token a group, which drops
nothing either.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed_tokens, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm)
from repro_torch.models.module import ParamBuilder
from repro_torch.models.transformer import (DecoderOutput, _head,
                                            init_rmsnorm_stacked, layer_views)
from repro_torch.obs.trace import wall_span

#: the span around each MoE FFN (routed and shared experts) of the prefill,
#: under the serving engine's prefix
MOE_SPAN = "repro_torch.serve.moe"

#: mixer(layer params, normed x, index in its stack) -> the mixer's output
Mixer = Callable[[dict, torch.Tensor, int], torch.Tensor]
#: routed(moe params of the layer, normed x) -> the routed experts' output
Routed = Callable[[dict, torch.Tensor], torch.Tensor]


def layer_stacks(cfg: ModelConfig) -> list[tuple[str, int]]:
    """Each layer's mixer, ``"attention"`` or ``"mamba"``, and its index in
    that mixer's stack; indices of ``attn_layers`` past the last layer are
    dropped, so a config cut in depth keeps the pattern of the layers it
    keeps."""
    attention = set(cfg.attn_layers)
    seen = {"attention": 0, "mamba": 0}
    out = []
    for i in range(cfg.n_layers):
        kind = "attention" if i in attention else "mamba"
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def _counts(cfg: ModelConfig) -> tuple[int, int]:
    """(Mamba2 layers, attention layers)."""
    kinds = [kind for kind, _ in layer_stacks(cfg)]
    return kinds.count("mamba"), kinds.count("attention")


def init_hybrid_moe(generator: torch.Generator | None, cfg: ModelConfig,
                    device: str | torch.device = "cpu") -> tuple[dict, dict]:
    b = ParamBuilder(generator, device)
    init_embedding(b, cfg)
    n_mamba, n_attn = _counts(cfg)
    if n_mamba:
        stack = b.sub("mamba_layers")
        ssm_lib.init_ssm(stack, cfg, stacked=n_mamba)
        init_rmsnorm_stacked(stack, "norm1", cfg.d_model, n_mamba)
    if n_attn:
        stack = b.sub("attention_layers")
        attn.init_attention(stack, cfg, stacked=n_attn)
        init_rmsnorm_stacked(stack, "norm1", cfg.d_model, n_attn)
    stack = b.sub("moe_layers")
    moe_lib.init_moe(stack, cfg, stacked=cfg.n_layers)
    init_rmsnorm_stacked(stack, "norm2", cfg.d_model, cfg.n_layers)
    init_mlp(b.sub("shared_mlp"), cfg, d_ff=cfg.shared_ff,
             stacked=cfg.n_layers)
    init_rmsnorm(b, "final_norm", cfg.d_model)
    return b.build()


def walk(params: dict, cfg: ModelConfig, x: torch.Tensor, mamba: Mixer,
         attend: Mixer, routed: Routed, ffn_span: bool = False
         ) -> torch.Tensor:
    """The residual stream through the stack (see the module docstring);
    with ``ffn_span`` each layer's MoE FFN runs inside a :data:`MOE_SPAN`
    span, the device drained before it and inside it at its end, so that
    the span's host time is the FFN's own (the dropless routing reads
    expert counts on the host, which would otherwise wait inside the span
    for the mixer queued before it)."""
    eps, r = cfg.norm_eps, cfg.residual_multiplier
    stacks = {name: layer_views(params[key]) if key in params else []
              for name, key in (("mamba", "mamba_layers"),
                                ("attention", "attention_layers"))}
    moes = layer_views(params["moe_layers"])
    shared = layer_views(params["shared_mlp"])
    mixers = {"mamba": mamba, "attention": attend}
    for i, (kind, j) in enumerate(layer_stacks(cfg)):
        lp = stacks[kind][j]
        x = x + mixers[kind](lp, rmsnorm(x, lp["norm1"], eps), j) * r
        h = rmsnorm(x, moes[i]["norm2"], eps)
        if ffn_span:
            _drain(h)
            with wall_span(None, MOE_SPAN):
                out = routed(moes[i], h) + mlp(shared[i], h, cfg)
                _drain(out)
        else:
            out = routed(moes[i], h) + mlp(shared[i], h, cfg)
        x = x + out * r
    return x


def _drain(x: torch.Tensor) -> None:
    """Wait for the device's queue on a CUDA tensor's stream."""
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    return embed_tokens(params, tokens, cfg) * cfg.embedding_multiplier


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _head(params, cfg, x) / cfg.logits_scaling


def _routed_tokens(cfg: ModelConfig) -> Routed:
    return lambda fp, h: moe_lib.moe_tokens(fp, h, cfg)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            last_only: bool = False) -> DecoderOutput:
    """tokens [B,S] -> logits [B,S,V] (the last position's with
    ``last_only``); no auxiliary loss."""
    b_, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=x.device).expand(b_, s)
    x = walk(params, cfg, x,
             lambda lp, h, j: ssm_lib.ssm_forward(lp, h, cfg),
             lambda lp, h, j: attn.mha_full(lp, h, cfg, positions),
             _routed_tokens(cfg))
    if last_only:
        x = x[:, -1:]
    return DecoderOutput(logits=_logits(params, cfg, x),
                         aux_loss=torch.zeros((), device=x.device))


def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: str | torch.device = "cpu") -> dict:
    """The Mamba2 layers' conv and state caches (f32) and the attention
    layers' K/V [n_attention, B, C, KH, hd] (bf16)."""
    n_mamba, n_attn = _counts(cfg)
    caches = {"ssm": ssm_lib.init_ssm_cache(cfg, n_mamba, batch,
                                            device=device)}
    if n_attn:
        caches["k"], caches["v"] = attn.init_kv_cache(cfg, n_attn, batch,
                                                      context, device=device)
    return caches


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            caches: dict) -> tuple[torch.Tensor, dict]:
    """Prompt prefill: one forward over the padded [B,S] prompt batch that
    fills ``caches`` in place as a replay of the prompt through
    :func:`decode_step` would (each Mamba2 layer its conv window and SSD
    state, :func:`~repro_torch.models.ssm.ssm_prefill`, on the SSD kernel
    when ``ssm_impl == 'pallas'``; each attention layer its K/V,
    :func:`~repro_torch.models.attention.mha_prefill`, on the flash kernel
    when ``attn_impl == 'pallas'``), and returns the last position's
    logits [B,1,V] with the caches.  Each layer's MoE FFN is a
    :data:`MOE_SPAN` span."""
    x = _embed(params, cfg, tokens)
    ssm_cache = caches["ssm"]

    def mamba(lp, h, j):
        return ssm_lib.ssm_prefill(lp, h, cfg, ssm_cache["conv"][j],
                                   ssm_cache["state"][j])

    def attend(lp, h, j):
        return attn.mha_prefill(lp, h, cfg, caches["k"][j], caches["v"][j])

    x = walk(params, cfg, x, mamba, attend, _routed_tokens(cfg),
             ffn_span=True)
    return _logits(params, cfg, x[:, -1:]), caches


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                index: int | torch.Tensor, caches: dict,
                capacity_moe: bool = False) -> tuple[torch.Tensor, dict]:
    """token: [B,1] int; index: position, an ``int`` or a 0-dim int64
    tensor on the step's device.  Returns (logits [B,1,V], caches) with the
    caches updated in place.  The MoE layers route each token alone
    (:func:`~repro_torch.models.moe.moe_tokens`, which reads expert counts
    on the host), or with ``capacity_moe`` through the capacity dispatch
    (:func:`~repro_torch.models.moe.moe_layer`, one token a group:
    capacity k, nothing dropped), which a captured decode graph replays."""
    x = _embed(params, cfg, token)
    conv, state = caches["ssm"]["conv"], caches["ssm"]["state"]

    def mamba(lp, h, j):
        cache_j = state[j]
        out, conv_j, state_j = ssm_lib.ssm_decode_step(lp, h, conv[j],
                                                       cache_j, cfg)
        conv[j].copy_(conv_j)
        if state_j is not cache_j:          # else updated in place
            cache_j.copy_(state_j)
        return out

    def attend(lp, h, j):
        return attn.mha_decode(lp, h, cfg, caches["k"][j], caches["v"][j],
                               index)[0]

    routed = ((lambda fp, h: moe_lib.moe_layer(fp, h, cfg)[0])
              if capacity_moe else _routed_tokens(cfg))
    x = walk(params, cfg, x, mamba, attend, routed)
    return _logits(params, cfg, x), caches

