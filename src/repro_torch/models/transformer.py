"""Decoder-only stacks: the dense/VLM/MoE transformer and the Mamba2
(ssm) stack.

Parameters carry a leading ``layers`` axis as in the reference; the port
loops over it in Python, so each layer's window is a plain int (``None``
for global layers) and full-sequence attention can reach the flash kernel.
MoE configs put their experts in ``layers`` (grok-1, a MoE FFN in every
layer) or interleave separate ``moe_layers`` and ``dense_layers`` stacks
(llama4, ``moe_every`` > 1); :func:`layer_ffns` gives each layer its FFN.
Dense and VLM configs may take the reference's decode cache variants, an
int8 cache (``kv_quant``) or rings on the local layers
(``windowed_cache``); :func:`_layer_cache` gives each layer its cache.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed_tokens, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm,
                                       unembed)
from repro_torch.models.module import ParamBuilder

GLOBAL = attn.GLOBAL_WINDOW


def layer_pattern(cfg: ModelConfig) -> list[int]:
    """Per-layer window sizes: GLOBAL for global layers, the local window
    (sliding or chunk) otherwise."""
    win = []
    for i in range(cfg.n_layers):
        if cfg.layer_is_global(i):
            win.append(GLOBAL)
        elif cfg.sliding_window is not None:
            win.append(cfg.sliding_window)
        elif cfg.attention_chunk is not None:
            win.append(cfg.attention_chunk)
        else:
            win.append(GLOBAL)
    return win


def _layer_masks(cfg: ModelConfig) -> list[tuple[int | None, int | None]]:
    """(window, chunk) per layer, with None for 'no limit'."""
    out = []
    for win in layer_pattern(cfg):
        window = None if win >= GLOBAL else win
        if cfg.attention_chunk is not None:
            out.append((None, window))
        else:
            out.append((window, None))
    return out


def windowed_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group_size, n_tail) for the windowed-cache decode layout:
    groups of (global_every) layers = (ge-1) local + 1 global; trailing
    local layers form the tail (gemma3: 62 = 10x6 + 2)."""
    ge = cfg.global_every
    n_groups = cfg.n_layers // ge
    return n_groups, ge, cfg.n_layers - n_groups * ge


def _layer_cache(caches: dict, cfg: ModelConfig, i: int
                 ) -> tuple[str, tuple[torch.Tensor, ...]]:
    """Layer i's attention cache, as views of ``caches``: ("int8", (k_q,
    k_s, v_q, v_s)), ("ring", (k, v)) for a local layer of the windowed
    layout, or ("plain", (k, v))."""
    if "k_q" in caches:
        return "int8", tuple(caches[n][i] for n in ("k_q", "k_s", "v_q",
                                                     "v_s"))
    if "local_k" in caches:
        ng, ge, _ = windowed_layout(cfg)
        g, j = divmod(i, ge)
        if g == ng:
            t = i - ng * ge
            return "ring", (caches["tail_k"][t], caches["tail_v"][t])
        if j < ge - 1:
            return "ring", (caches["local_k"][g, j], caches["local_v"][g, j])
        return "plain", (caches["global_k"][g], caches["global_v"][g])
    return "plain", (caches["k"][i], caches["v"][i])


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: this module runs the dense, VLM, MoE and ssm "
            f"stacks; family {cfg.family} runs in models/hybrid.py "
            f"(zamba2) or models/encdec.py (whisper)")


def layer_views(stack: dict) -> list[dict]:
    """Each layer's params of a stacked tree (leading ``layers`` axis), as
    views.  ``unbind`` splits every leaf once, so a backward stacks the
    layers' gradients in one op, where indexing layer by layer would give
    each layer's gradient as a zero-filled copy of the whole stack."""
    per_key = {k: v.unbind(0) for k, v in stack.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def layer_ffns(layers: list[dict], params: dict, cfg: ModelConfig
               ) -> list[tuple[bool, dict]]:
    """Each layer's FFN as (is_moe, its params), given ``layers``, the
    views of ``params["layers"]``.  With ``moe_every`` m > 1 (llama4) layer
    i is MoE iff (i+1) % m == 0: the MoE layers take ``moe_layers`` in
    order, the dense layers ``dense_layers``."""
    if not cfg.n_experts:
        return [(False, lp) for lp in layers]
    if cfg.moe_every == 1:
        return [(True, lp) for lp in layers]
    moe = iter(layer_views(params["moe_layers"]))
    dense = iter(layer_views(params["dense_layers"]))
    return [(True, next(moe)) if (i + 1) % cfg.moe_every == 0
            else (False, next(dense)) for i in range(len(layers))]


def _ffn_tokens(is_moe: bool, fp: dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """The FFN of the cache-filling prefill and of eager decode: a MoE
    layer routes every token as a group of one, as the reference engine's
    replay through decode_step does."""
    return moe_lib.moe_tokens(fp, x, cfg) if is_moe else mlp(fp, x, cfg)


def remat_layer(fn):
    """Per-layer activation checkpointing, as the reference's
    ``remat_layer`` (``jax.checkpoint``): while autograd records, only the
    layer's inputs are saved and the rest is recomputed in backward.  With
    grad disabled (prefill, serving) the layer runs as it is."""
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the layers draw no random numbers, so no RNG state is kept
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


@dataclasses.dataclass
class DecoderOutput:
    logits: torch.Tensor
    aux_loss: torch.Tensor


# -- init ---------------------------------------------------------------------------

def init_decoder(generator: torch.Generator | None, cfg: ModelConfig,
                 device: str | torch.device = "cpu") -> tuple[dict, dict]:
    _check_supported(cfg)
    b = ParamBuilder(generator, device)
    init_embedding(b, cfg)
    lyr = b.sub("layers")
    L = cfg.n_layers
    if cfg.family == "ssm":
        ssm_lib.init_ssm(lyr, cfg, stacked=L)
        init_rmsnorm_stacked(lyr, "norm1", cfg.d_model, L)
    else:
        attn.init_attention(lyr, cfg, stacked=L)
        init_rmsnorm_stacked(lyr, "norm1", cfg.d_model, L)
        init_rmsnorm_stacked(lyr, "norm2", cfg.d_model, L)
        if cfg.n_experts and cfg.moe_every == 1:
            moe_lib.init_moe(lyr, cfg, stacked=L)
        elif cfg.n_experts:
            # dense and MoE layers interleaved (llama4): separate stacks
            n_moe = L // cfg.moe_every
            moe_lib.init_moe(b.sub("moe_layers"), cfg, stacked=n_moe)
            init_mlp(b.sub("dense_layers"), cfg,
                     d_ff=cfg.d_ff * cfg.moe_every, stacked=L - n_moe)
        else:
            init_mlp(lyr, cfg, stacked=L)
    init_rmsnorm(b, "final_norm", cfg.d_model)
    return b.build()


def init_rmsnorm_stacked(b: ParamBuilder, name: str, dim: int, L: int):
    b.add(name, (L, dim), ("layers", "norm"), init="ones")


# -- forward (train / prefill) ---------------------------------------------------

def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           extra_embeddings: torch.Tensor | None) -> torch.Tensor:
    x = embed_tokens(params, tokens, cfg)
    if extra_embeddings is not None:
        v = extra_embeddings.shape[1]
        x = torch.cat([extra_embeddings.to(x.dtype), x[:, v:]], dim=1)
    return x


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return unembed(params, rmsnorm(x, params["final_norm"], cfg.norm_eps),
                   cfg)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embeddings: torch.Tensor | None = None,
            last_only: bool = False) -> DecoderOutput:
    """tokens: [B,S] int. extra_embeddings: [B,V,d] stub frontend output
    (VLM patches) overriding the first V positions."""
    _check_supported(cfg)
    b_, s = tokens.shape
    x = _embed(params, cfg, tokens, extra_embeddings)
    layers = layer_views(params["layers"])
    aux = torch.zeros((), device=x.device)
    if cfg.family == "ssm":
        @remat_layer
        def ssm_body(h, lp):
            return h + ssm_lib.ssm_forward(
                lp, rmsnorm(h, lp["norm1"], cfg.norm_eps), cfg)

        for lp in layers:
            x = ssm_body(x, lp)
    else:
        positions = torch.arange(s, device=x.device).expand(b_, s)

        @remat_layer
        def body(h, lp, is_moe, fp, window, chunk):
            h = h + attn.mha_full(lp, rmsnorm(h, lp["norm1"], cfg.norm_eps),
                                  cfg, positions, window=window, chunk=chunk)
            hn = rmsnorm(h, lp["norm2"], cfg.norm_eps)
            if is_moe:
                out, a = moe_lib.moe_layer(fp, hn, cfg)
                return h + out, a
            return h + mlp(fp, hn, cfg), torch.zeros((), device=h.device)

        for lp, (is_moe, fp), (window, chunk) in zip(
                layers, layer_ffns(layers, params, cfg), _layer_masks(cfg)):
            x, a = body(x, lp, is_moe, fp, window, chunk)
            aux = aux + a
    if last_only:
        x = x[:, -1:]
    return DecoderOutput(logits=_head(params, cfg, x), aux_loss=aux)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            caches: dict, extra_embeddings: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Prompt prefill: one forward over the padded [B,S] prompt batch that
    writes every layer's K/V into ``caches`` (in place, positions 0..S-1)
    and returns the last position's logits [B,1,V] with the caches.
    For the ssm stack it writes each layer's conv window and SSD state
    instead (:func:`repro_torch.models.ssm.ssm_prefill`), the SSD running
    through the chunk-scan kernel when ``ssm_impl == 'pallas'``.

    This replaces the reference engine's prompt replay, which feeds the
    prompt one token at a time through ``decode_step``
    (repro/serving/engine.py:100-104).  Each layer projects q/k/v at
    positions 0..S-1, stores k/v in the cache dtype, and attends over the
    K/V as stored in the cache, cast back to q's dtype, exactly what the
    replay computes token by token.  So the cache contents and the last
    logits are the replay's, up to the order of the sums, while the
    attention runs as one causal full-sequence call per layer (through
    the flash kernel when ``attn_impl == 'pallas'``) instead of S decode
    steps.  A MoE layer routes each prompt token as a group of its own
    (:func:`repro_torch.models.moe.moe_tokens`), as the replay does, so no
    token is dropped, where ``forward``'s capacity dispatch over groups of
    up to 512 tokens may drop some.  The decode cache variants fill as the
    replay fills them: an int8 cache holds the prompt's quantized K/V and
    attention reads them dequantized; a windowed layout's local layer
    attends over its K/V rounded to its ring's dtype and keeps the last W
    positions in ring slots p mod W.
    """
    _check_supported(cfg)
    x = _embed(params, cfg, tokens, extra_embeddings)
    layers = layer_views(params["layers"])
    if cfg.family == "ssm":
        for i, lp in enumerate(layers):
            x = x + ssm_lib.ssm_prefill(
                lp, rmsnorm(x, lp["norm1"], cfg.norm_eps), cfg,
                caches["ssm"]["conv"][i], caches["ssm"]["state"][i])
        return _head(params, cfg, x[:, -1:]), caches
    for i, ((window, chunk), (is_moe, fp)) in enumerate(
            zip(_layer_masks(cfg), layer_ffns(layers, params, cfg))):
        lp = layers[i]
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        kind, c = _layer_cache(caches, cfg, i)
        if kind == "int8":
            x = x + attn.mha_prefill_quant(lp, h, cfg, *c, window=window,
                                           chunk=chunk)
        elif kind == "ring":
            x = x + attn.mha_prefill_windowed(lp, h, cfg, *c, window=window)
        else:
            x = x + attn.mha_prefill(lp, h, cfg, *c, window=window,
                                     chunk=chunk)
        x = x + _ffn_tokens(is_moe, fp, rmsnorm(x, lp["norm2"], cfg.norm_eps),
                            cfg)
    return _head(params, cfg, x[:, -1:]), caches


# -- decode ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: str | torch.device = "cpu") -> dict:
    _check_supported(cfg)
    if cfg.family == "ssm":
        return {"ssm": ssm_lib.init_ssm_cache(cfg, cfg.n_layers, batch,
                                              device=device)}
    if cfg.kv_quant and not cfg.n_experts:
        # int8 KV: dense/VLM only — MoE top-k routing is discontinuous and
        # amplifies quantization perturbations into expert flips
        return attn.init_kv_cache_quant(cfg, cfg.n_layers, batch, context,
                                        device=device)
    if (cfg.windowed_cache and cfg.sliding_window and cfg.global_every
            and not cfg.n_experts):
        # local layers keep rings of W slots, bf16 whatever the params
        ng, ge, tail = windowed_layout(cfg)
        w = min(cfg.sliding_window, context)
        kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim

        def ring(*lead):
            return torch.zeros(lead + (batch, w, kh, hd),
                               dtype=torch.bfloat16, device=device)

        gk, gv = attn.init_kv_cache(cfg, ng, batch, context, device=device)
        caches = {"local_k": ring(ng, ge - 1), "local_v": ring(ng, ge - 1),
                  "global_k": gk, "global_v": gv}
        if tail:
            caches["tail_k"], caches["tail_v"] = ring(tail), ring(tail)
        return caches
    k, v = attn.init_kv_cache(cfg, cfg.n_layers, batch, context,
                              device=device)
    return {"k": k, "v": v}


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                index: int | torch.Tensor, caches: dict,
                capacity_moe: bool = False) -> tuple[torch.Tensor, dict]:
    """token: [B,1] int; index: position, an ``int`` or a 0-dim int64
    tensor on the step's device.  Returns (logits [B,1,V], caches) with
    the caches updated in place.  MoE layers route each token as a group
    of one (:func:`~repro_torch.models.moe.moe_tokens`, which counts the
    tokens of each expert on the host), or with ``capacity_moe`` through
    the capacity dispatch of ``forward``
    (:func:`~repro_torch.models.moe.moe_layer`), the reference's one
    dispatch, which reads nothing on the host: the dry run traces it on
    ``meta`` and a captured decode graph replays it."""
    _check_supported(cfg)
    x = embed_tokens(params, token, cfg)
    layers = layer_views(params["layers"])
    if cfg.family == "ssm":
        conv, state = caches["ssm"]["conv"], caches["ssm"]["state"]
        for i, lp in enumerate(layers):
            cache_i = state[i]
            out, conv_i, state_i = ssm_lib.ssm_decode_step(
                lp, rmsnorm(x, lp["norm1"], cfg.norm_eps), conv[i],
                cache_i, cfg)
            conv[i].copy_(conv_i)
            if state_i is not cache_i:      # else updated in place
                cache_i.copy_(state_i)
            x = x + out
        return _head(params, cfg, x), caches
    for i, ((window, chunk), (is_moe, fp)) in enumerate(
            zip(_layer_masks(cfg), layer_ffns(layers, params, cfg))):
        lp = layers[i]
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        kind, c = _layer_cache(caches, cfg, i)
        if kind == "int8":
            out, _ = attn.mha_decode_quant(lp, h, cfg, *c, index,
                                           window=window, chunk=chunk)
        elif kind == "ring":
            out, _, _ = attn.mha_decode_windowed(lp, h, cfg, *c, index)
        else:
            out, _, _ = attn.mha_decode(lp, h, cfg, *c, index, window=window,
                                        chunk=chunk)
        x = x + out
        hn = rmsnorm(x, lp["norm2"], cfg.norm_eps)
        if is_moe and capacity_moe:
            x = x + moe_lib.moe_layer(fp, hn, cfg)[0]
        else:
            x = x + _ffn_tokens(is_moe, fp, hn, cfg)
    return _head(params, cfg, x), caches
