"""Whisper-style encoder-decoder (arXiv:2212.04356).

The mel-spectrogram + conv frontend is a stub, as in the reference: the
caller supplies frame embeddings [B, enc_seq, d].  This module is the
transformer backbone: a bidirectional encoder, a causal decoder with self-
and cross-attention, learned positions (no RoPE).  Stacks carry a leading
``layers`` axis as in the reference; the port loops over them in Python
(:func:`walk` for the decoder), so the decoder's full-sequence self
attention reaches the flash kernel on ``attn_impl='pallas'``.  The encoder
and the cross attention stay plain, as the reference's do.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_tokens, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm)
from repro_torch.models.module import ParamBuilder
from repro_torch.models.transformer import (DecoderOutput, _head,
                                            init_rmsnorm_stacked,
                                            layer_views, remat_layer)

#: self_attend(layer params, normed x, layer index) -> the output
SelfAttend = Callable[[dict, torch.Tensor, int], torch.Tensor]
#: cross(cross-attention params, layer index) -> the encoder's (K, V)
CrossKV = Callable[[dict, int], tuple[torch.Tensor, torch.Tensor]]


def init_encdec(generator: torch.Generator | None, cfg: ModelConfig,
                device: str | torch.device = "cpu") -> tuple[dict, dict]:
    b = ParamBuilder(generator, device)
    init_embedding(b, cfg)
    b.add("enc_pos", (cfg.enc_seq, cfg.d_model), (None, "embed"), scale=0.02)
    b.add("dec_pos", (cfg.max_seq_len, cfg.d_model), (None, "embed"),
          scale=0.02)
    enc = b.sub("encoder")
    attn.init_attention(enc, cfg, stacked=cfg.enc_layers)
    init_mlp(enc, cfg, stacked=cfg.enc_layers)
    init_rmsnorm_stacked(enc, "norm1", cfg.d_model, cfg.enc_layers)
    init_rmsnorm_stacked(enc, "norm2", cfg.d_model, cfg.enc_layers)
    dec = b.sub("decoder")
    attn.init_attention(dec, cfg, stacked=cfg.n_layers)
    cross = b.sub("cross")
    attn.init_attention(cross, cfg, stacked=cfg.n_layers)
    init_mlp(dec, cfg, stacked=cfg.n_layers)
    init_rmsnorm_stacked(dec, "norm1", cfg.d_model, cfg.n_layers)
    init_rmsnorm_stacked(dec, "norm_cross", cfg.d_model, cfg.n_layers)
    init_rmsnorm_stacked(dec, "norm2", cfg.d_model, cfg.n_layers)
    init_rmsnorm(b, "enc_final_norm", cfg.d_model)
    init_rmsnorm(b, "final_norm", cfg.d_model)
    return b.build()


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: [B, enc_seq, d] stub frontend embeddings."""
    s = frames.shape[1]
    x = frames + params["enc_pos"][:s].to(frames.dtype)
    eps = cfg.norm_eps

    @remat_layer
    def body(h, lp):
        h = h + attn.mha_bidirectional(lp, rmsnorm(h, lp["norm1"], eps), cfg)
        return h + mlp(lp, rmsnorm(h, lp["norm2"], eps), cfg)

    for lp in layer_views(params["encoder"]):
        x = body(x, lp)
    return rmsnorm(x, params["enc_final_norm"], eps)


def walk(params: dict, cfg: ModelConfig, x: torch.Tensor,
         self_attend: SelfAttend, cross: CrossKV) -> torch.Tensor:
    """The decoder's residual stream: each layer's self attention, cross
    attention over the encoder's K/V, and MLP, each layer checkpointed
    while autograd records (:func:`remat_layer`)."""
    eps = cfg.norm_eps

    @remat_layer
    def body(h, lp, xlp, i):
        h = h + self_attend(lp, rmsnorm(h, lp["norm1"], eps), i)
        h = h + attn.mha_cross(xlp, rmsnorm(h, lp["norm_cross"], eps),
                               *cross(xlp, i), cfg)
        return h + mlp(lp, rmsnorm(h, lp["norm2"], eps), cfg)

    for i, (lp, xlp) in enumerate(zip(layer_views(params["decoder"]),
                                      layer_views(params["cross"]))):
        x = body(x, lp, xlp, i)
    return x


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           start: int | torch.Tensor = 0) -> torch.Tensor:
    """Token embeddings plus the learned positions start..start+S-1;
    ``start`` is an ``int`` or a 0-dim int64 tensor on the tokens' device,
    whose rows come from ``index_select`` (the reference's
    ``dynamic_slice_in_dim``), so nothing reads it on the host."""
    x = embed_tokens(params, tokens, cfg)
    s = tokens.shape[1]
    if isinstance(start, torch.Tensor):
        rows = start + torch.arange(s, device=start.device)
        pos = params["dec_pos"].index_select(0, rows)
    else:
        pos = params["dec_pos"][start:start + s]
    return x + pos.to(x.dtype)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, last_only: bool = False) -> DecoderOutput:
    """Teacher-forced training / prefill: tokens [B,S], frames [B,Senc,d]."""
    enc_out = encode(params, cfg, frames)
    b_, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b_, s)
    x = walk(params, cfg, _embed(params, cfg, tokens),
             lambda lp, h, i: attn.mha_full(lp, h, cfg, positions),
             lambda xlp, i: attn.cross_kv(xlp, enc_out, cfg))
    if last_only:
        x = x[:, -1:]
    return DecoderOutput(logits=_head(params, cfg, x),
                         aux_loss=torch.zeros((), device=x.device))


def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: str | torch.device = "cpu") -> dict:
    """Self-attention K/V [L,B,C,KH,hd] and cross K/V [L,B,enc_seq,KH,hd],
    all bf16 whatever the params' dtype, as in the reference."""
    k, v = attn.init_kv_cache(cfg, cfg.n_layers, batch, context,
                              device=device)
    shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {
        "k": k, "v": v,
        # cross K/V are filled once from the encoder at prefill time
        "cross_k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "cross_v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


def prefill_cross_kv(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                     caches: dict) -> dict:
    """Run the encoder once and write each layer's cross K/V into the
    caches (in place, in the caches' dtype); returns the caches."""
    enc_out = encode(params, cfg, frames)
    for i, xlp in enumerate(layer_views(params["cross"])):
        k, v = attn.cross_kv(xlp, enc_out, cfg)
        caches["cross_k"][i].copy_(k)
        caches["cross_v"][i].copy_(v)
    return caches


def _cached_cross(caches: dict, dtype: torch.dtype) -> CrossKV:
    """Cross K/V read from the caches, cast to the residual stream's
    dtype, as the reference's decode_step reads them."""
    return lambda xlp, i: (caches["cross_k"][i].to(dtype),
                           caches["cross_v"][i].to(dtype))


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            caches: dict) -> tuple[torch.Tensor, dict]:
    """Prompt prefill: one forward over the padded [B,S] prompt batch that
    writes every decoder layer's self K/V into ``caches`` (in place,
    positions 0..S-1) as the reference engine's replay of the prompt
    through :func:`decode_step` would, and returns the last position's
    logits [B,1,V] with the caches.  The caches' cross K/V must already
    hold the encoder's (:func:`prefill_cross_kv`).

    Each layer attends causally over its K/V as stored in the cache
    (:func:`repro_torch.models.attention.mha_prefill`, through the flash
    kernel when ``attn_impl == 'pallas'``), then over the cached cross K/V
    cast to the residual stream's dtype, as decode_step does: the replay's
    numbers, not the forward's, which uses fresh f32 cross K/V.
    """
    x = _embed(params, cfg, tokens)
    x = walk(params, cfg, x,
             lambda lp, h, i: attn.mha_prefill(lp, h, cfg, caches["k"][i],
                                               caches["v"][i]),
             _cached_cross(caches, x.dtype))
    return _head(params, cfg, x[:, -1:]), caches


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                index: int | torch.Tensor, caches: dict
                ) -> tuple[torch.Tensor, dict]:
    """token: [B,1] int; index: position, an ``int`` or a 0-dim int64
    tensor on the step's device.  Returns (logits [B,1,V], caches) with the
    self-attention caches updated in place."""
    x = _embed(params, cfg, token, start=index)
    x = walk(params, cfg, x,
             lambda lp, h, i: attn.mha_decode(lp, h, cfg, caches["k"][i],
                                              caches["v"][i], index)[0],
             _cached_cross(caches, x.dtype))
    return _head(params, cfg, x), caches
