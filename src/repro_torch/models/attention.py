"""Grouped-query attention with RoPE, qk-norm, sliding-window / chunked
masks, KV-cache decode, cross-attention, and bidirectional (encoder) mode.

The plain path (``attn_impl='xla'``) is exact softmax attention in PyTorch;
``attn_impl='pallas'`` sends full-sequence causal self attention through
the hand-written flash kernel (:func:`repro_torch.kernels.ops.flash_mha`).
Cross and bidirectional attention stay plain, as in the reference.

KV caches are updated in place: decode and prefill write the new K/V into
the cache tensors they are given and return those same tensors.  Besides
the plain [B,C,KH,hd] cache there are the reference's two decode cache
variants: a ring of the last W positions for a sliding-window layer and
an int8 cache with per-(token, head) f32 scales; decode attention over
them is plain, as the reference's is.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.module import ParamBuilder
from repro_torch.sharding.partitioning import (constrain, einsum, flatten,
                                               unflatten)

NEG_INF = -2.3819763e38  # close to bf16 min, used by flash implementations
GLOBAL_WINDOW = 2 ** 30  # 'window' large enough to mean full attention


def init_attention(b: ParamBuilder, cfg: ModelConfig,
                   stacked: int | None = None) -> None:
    d, h, kh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    b.add("wq", lead + (d, h, hd), lax_ + ("embed", "heads", "head_dim"))
    b.add("wk", lead + (d, kh, hd), lax_ + ("embed", "kv_heads", "head_dim"))
    b.add("wv", lead + (d, kh, hd), lax_ + ("embed", "kv_heads", "head_dim"))
    b.add("wo", lead + (h, hd, d), lax_ + ("heads", "head_dim", "embed"))
    if cfg.qk_norm:
        b.add("q_norm", lead + (hd,), lax_ + ("norm",), init="ones")
        b.add("k_norm", lead + (hd,), lax_ + ("norm",), init="ones")


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul.  Mixed float inputs are
    promoted to the wider type, as the reference's einsum promotes them
    (whisper's bf16 stub frames meet f32 weights in the first encoder
    layer)."""
    d, nh, hd = w.shape
    dtype = torch.promote_types(x.dtype, w.dtype)
    return unflatten(torch.matmul(x.to(dtype), flatten(w, 1, 2).to(dtype)),
                     -1, (nh, hd))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matmul."""
    return torch.matmul(flatten(out, -2, -1), flatten(wo, 0, 1))


def _project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, rope: bool = True):
    q = _proj_heads(x, params["wq"])
    k = _proj_heads(x, params["wk"])
    v = _proj_heads(x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", "seq", "heads", None))
    k = constrain(k, ("batch", "seq", "kv_heads", None))
    v = constrain(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window, chunk,
               causal: bool = True) -> torch.Tensor:
    """Additive bias [q_len, k_len] in f32 from position vectors."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((dq.shape[0], dk.shape[1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window is not None:
        ok &= (dq - dk) < window
    if chunk is not None:
        ok &= (dq // chunk) == (dk // chunk)
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa(q, k, v, bias, cfg: ModelConfig):
    """q:[B,Sq,H,hd] k,v:[B,Sk,KH,hd] bias:[Sq,Sk] (or [B,1,Sq,Sk])."""
    b_, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    q = unflatten(q, 2, (kh, g))
    scores = einsum("bqkgd,bskd->bkgqs", q, k).float()
    scores = scores / math.sqrt(hd)
    if bias.dim() == 2:
        scores = scores + bias[None, None, None]
    else:
        scores = scores + bias[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = einsum("bkgqs,bskd->bqkgd", probs, v)
    return constrain(out.reshape(b_, sq, h, hd),
                     ("batch", "seq", "heads", None))


def _sdpa_qblocked(q, k, v, q_pos, k_pos, window, chunk, causal: bool,
                   cfg: ModelConfig, block: int):
    """Exact attention over query blocks of ``block`` rows, so live memory
    holds one [B,H,block,Sk] score slab instead of [B,H,Sq,Sk]."""
    sq = q.shape[1]
    outs = []
    for start in range(0, sq, block):
        stop = start + block
        bias = _mask_bias(q_pos[start:stop], k_pos, window, chunk, causal)
        outs.append(_sdpa(q[:, start:stop], k, v, bias, cfg))
    return constrain(torch.cat(outs, dim=1), ("batch", "seq", "heads", None))


def _attend_self(q, k, v, cfg: ModelConfig, pos: torch.Tensor, window,
                 chunk) -> torch.Tensor:
    """Causal full-sequence attention of q over k/v at the same positions:
    the flash kernel for ``attn_impl='pallas'`` (chunked masks excepted),
    else plain attention, q-blocked when S is a multiple of the block."""
    s, block = q.shape[1], cfg.attn_q_block
    if cfg.attn_impl == "pallas" and chunk is None:
        return ops.flash_mha(q, k, v, causal=True, window=window)
    if s <= block or s % block != 0:
        return _sdpa(q, k, v, _mask_bias(pos, pos, window, chunk), cfg)
    return _sdpa_qblocked(q, k, v, pos, pos, window, chunk, True, cfg,
                          block)


def _attend(q, k, v, q_pos, k_pos, window, chunk, causal: bool,
            cfg: ModelConfig, q_block: int = 512) -> torch.Tensor:
    """Plain attention of q over k/v (cross and bidirectional): one
    [B,H,Sq,Sk] score slab unless Sq is a multiple of ``q_block`` above
    it, then q-blocked."""
    sq = q.shape[1]
    if sq <= q_block or sq % q_block != 0:
        bias = _mask_bias(q_pos, k_pos, window, chunk, causal)
        return _sdpa(q, k, v, bias, cfg)
    return _sdpa_qblocked(q, k, v, q_pos, k_pos, window, chunk, causal, cfg,
                          q_block)


def mha_full(params: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, window: int | None = None,
             chunk: int | None = None) -> torch.Tensor:
    """Full-sequence causal self attention (training / prefill)."""
    q, k, v = _project_qkv(params, x, cfg, positions, rope=not _no_rope(cfg))
    pos = positions[0] if positions.dim() > 1 else positions
    y = _out_proj(_attend_self(q, k, v, cfg, pos, window, chunk),
                  params["wo"])
    return constrain(y, ("batch", "seq", None))


def _prefill(params: dict, x: torch.Tensor, cfg: ModelConfig, store,
             window: int | None, chunk: int | None) -> torch.Tensor:
    """Causal self attention over a prompt x:[B,S,d] at positions 0..S-1.
    ``store(k, v)`` writes the prompt's K/V into a cache and returns them
    as token-by-token decode reads them back from it; attention runs over
    those, cast to q's dtype, so the cache rounds K/V as decode does."""
    b_, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b_, s)
    q, k, v = _project_qkv(params, x, cfg, positions, rope=not _no_rope(cfg))
    k, v = store(k, v)
    out = _attend_self(q, k.to(q.dtype), v.to(q.dtype), cfg, positions[0],
                       window, chunk)
    return _out_proj(out, params["wo"])


def mha_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                window: int | None = None,
                chunk: int | None = None) -> torch.Tensor:
    """Causal self attention over a prompt x:[B,S,d] at positions 0..S-1
    that also fills cache_k/v:[B,C,KH,hd] (in place) at 0..S-1."""
    def store(k, v):
        s = k.shape[1]
        cache_k[:, :s] = k.to(cache_k.dtype)
        cache_v[:, :s] = v.to(cache_v.dtype)
        return cache_k[:, :s], cache_v[:, :s]

    return _prefill(params, x, cfg, store, window, chunk)


def mha_prefill_windowed(params: dict, x: torch.Tensor, cfg: ModelConfig,
                         cache_k: torch.Tensor, cache_v: torch.Tensor,
                         window: int | None = None) -> torch.Tensor:
    """A local layer's prefill into a ring of W slots, cache_k/v:
    [B,W,KH,hd] (in place): attention over the prompt's K/V rounded to the
    ring's dtype, with the layer's ``window``; then positions
    max(0, S-W)..S-1 go to slots p mod W, which is what a replay through
    :func:`mha_decode_windowed` leaves in the ring."""
    def store(k, v):
        s, w = k.shape[1], cache_k.shape[1]
        k, v = k.to(cache_k.dtype), v.to(cache_v.dtype)
        lo = max(0, s - w)
        slots = torch.arange(lo, s, device=k.device) % w
        cache_k[:, slots] = k[:, lo:]
        cache_v[:, slots] = v[:, lo:]
        return k, v

    return _prefill(params, x, cfg, store, window, None)


def mha_prefill_quant(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      k_q, k_s, v_q, v_s, window: int | None = None,
                      chunk: int | None = None) -> torch.Tensor:
    """The prefill into an int8 cache (in place at 0..S-1): K/V quantized
    per (token, head), attention over their dequantized values, as
    :func:`mha_decode_quant` reads them back."""
    def store(k, v):
        s = k.shape[1]
        for t, codes, scales in ((k, k_q, k_s), (v, v_q, v_s)):
            codes[:, :s], scales[:, :s] = quantize_kv(t)
        return (dequantize_kv(k_q[:, :s], k_s[:, :s], k.dtype),
                dequantize_kv(v_q[:, :s], v_s[:, :s], v.dtype))

    return _prefill(params, x, cfg, store, window, chunk)


def _decode_positions(index, b: int, device) -> torch.Tensor:
    """The decode step's positions [B,1] at ``index``: an ``int``, or a
    0-dim int64 tensor on the step's device, which nothing reads on the
    host (a captured decode graph replays it at every position)."""
    if isinstance(index, torch.Tensor):
        return index.expand(b, 1)
    return torch.full((b, 1), index, dtype=torch.int64, device=device)


def _write_at(cache: torch.Tensor, index, new: torch.Tensor) -> None:
    """cache[:, index] = new[:, 0] in place, along the sequence dim 1:
    a slice for an ``int``, ``index_copy_`` for a device tensor."""
    new = new.to(cache.dtype)
    if isinstance(index, torch.Tensor):
        cache.index_copy_(1, index.reshape(1), new)
    else:
        cache[:, index:index + 1] = new


def _decode_bias(k_pos: torch.Tensor, index, window, chunk) -> torch.Tensor:
    """The additive bias [1, C] of a decode step at ``index`` over cache
    positions k_pos, from tensor arithmetic for either kind of index."""
    valid = k_pos <= index
    if window is not None:
        valid &= (index - k_pos) < window
    if chunk is not None:
        valid &= (k_pos // chunk) == (index // chunk)
    return torch.where(valid, 0.0, NEG_INF).float()[None, :]


def mha_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               index: int | torch.Tensor, window: int | None = None,
               chunk: int | None = None):
    """One-token decode. x:[B,1,d]; cache_k/v:[B,C,KH,hd] (written in
    place at ``index``); index: current position, an ``int`` or a 0-dim
    int64 tensor on x's device.  Returns (y, cache_k, cache_v)."""
    positions = _decode_positions(index, x.shape[0], x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions,
                                   rope=not _no_rope(cfg))
    _write_at(cache_k, index, k_new)
    _write_at(cache_v, index, v_new)
    k_pos = torch.arange(cache_k.shape[1], device=x.device)
    bias = _decode_bias(k_pos, index, window, chunk)
    out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), bias, cfg)
    y = _out_proj(out, params["wo"])
    return constrain(y, ("batch", "seq", None)), cache_k, cache_v


def mha_cross(params: dict, x: torch.Tensor, enc_k: torch.Tensor,
              enc_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Cross attention (whisper decoder): x:[B,S,d] over the encoder's K/V
    enc_k/enc_v:[B,Senc,KH,hd], precomputed by :func:`cross_kv`."""
    s = x.shape[1]
    q = _proj_heads(x, params["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
    q_pos = torch.arange(s, device=x.device)
    k_pos = torch.arange(enc_k.shape[1], device=x.device)
    out = _attend(q, enc_k, enc_v, q_pos, k_pos, None, None, False, cfg)
    return constrain(_out_proj(out, params["wo"]), ("batch", "seq", None))


def cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K/V [B,Senc,KH,hd] for cross attention."""
    k = _proj_heads(enc_out, params["wk"])
    v = _proj_heads(enc_out, params["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    return k, v


def mha_bidirectional(params: dict, x: torch.Tensor, cfg: ModelConfig
                      ) -> torch.Tensor:
    """Encoder self-attention: no mask, no cache, no RoPE (the whisper
    encoder's learned positions are added by the caller)."""
    b_, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b_, s)
    q, k, v = _project_qkv(params, x, cfg, positions, rope=False)
    pos = positions[0]
    out = _attend(q, k, v, pos, pos, None, None, False, cfg)
    return constrain(_out_proj(out, params["wo"]), ("batch", "seq", None))


def _no_rope(cfg: ModelConfig) -> bool:
    return cfg.family == "audio"  # whisper uses learned positions


def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, context: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: str | torch.device = "cpu"):
    """Stacked [L, B, C, KH, hd] caches."""
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, context, kh, hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def mha_decode_windowed(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        cache_k: torch.Tensor, cache_v: torch.Tensor,
                        index: int | torch.Tensor):
    """One-token decode against a ring-buffer cache of ``window`` slots.

    cache_k/v: [B, W, KH, hd].  Slot ``index % W`` is overwritten (in
    place); slot j holds absolute position p_j = index - ((index - j) mod
    W), i.e. exactly the last W positions — the sliding window needs no
    extra mask beyond p_j >= 0 (warmup).  ``index`` is an ``int`` or a
    0-dim int64 tensor on x's device.
    """
    w = cache_k.shape[1]
    positions = _decode_positions(index, x.shape[0], x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions,
                                   rope=not _no_rope(cfg))
    slot = index % w
    _write_at(cache_k, slot, k_new)
    _write_at(cache_v, slot, v_new)
    j = torch.arange(w, device=x.device)
    k_pos = index - (index - j) % w
    bias = torch.where(k_pos >= 0, 0.0, NEG_INF).float()[None, :]
    out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), bias, cfg)
    y = _out_proj(out, params["wo"])
    return constrain(y, ("batch", "seq", None)), cache_k, cache_v


# -- int8-quantized KV cache (decode) -----------------------------------------

def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: x [B,S,KH,hd] ->
    (q int8 [B,S,KH,hd], scale f32 [B,S,KH,1]).  ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_kv_cache_quant(cfg: ModelConfig, n_layers: int, batch: int,
                        context: int, device: str | torch.device = "cpu"):
    """int8 caches + f32 scales, stacked [L, B, C, KH, hd] / [.., 1]."""
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, context, kh, hd)
    sshape = (n_layers, batch, context, kh, 1)
    return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_s": torch.zeros(sshape, dtype=torch.float32, device=device)}


def mha_decode_quant(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     k_q, k_s, v_q, v_s, index: int | torch.Tensor,
                     window: int | None = None, chunk: int | None = None):
    """One-token decode against an int8 KV cache (written in place at
    ``index``, an ``int`` or a 0-dim int64 tensor on x's device).
    Returns (y, (k_q, k_s, v_q, v_s)).

    Halves the decode cache's bytes; per-(token, head) scales keep the
    logit error within bf16 noise (~2% relative in the reference's tests).
    """
    positions = _decode_positions(index, x.shape[0], x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions,
                                   rope=not _no_rope(cfg))
    for t, codes, scales in ((k_new, k_q, k_s), (v_new, v_q, v_s)):
        new_codes, new_scales = quantize_kv(t)
        _write_at(codes, index, new_codes)
        _write_at(scales, index, new_scales)
    k_pos = torch.arange(k_q.shape[1], device=x.device)
    bias = _decode_bias(k_pos, index, window, chunk)
    k = dequantize_kv(k_q, k_s, q.dtype)
    v = dequantize_kv(v_q, v_s, q.dtype)
    out = _sdpa(q, k, v, bias, cfg)
    y = _out_proj(out, params["wo"])
    return constrain(y, ("batch", "seq", None)), (k_q, k_s, v_q, v_s)
