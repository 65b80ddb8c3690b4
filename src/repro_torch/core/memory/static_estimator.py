"""Static/analytic memory estimation — the CASE/DNNMem tier (paper §2.2,
§4.3); the port's copy of ``repro.core.memory.static_estimator``.

The paper uses compiler analysis [CASE] for scientific jobs and DNNMem for
DNNs to choose the *starting* slice.  For these models the analytic footprint
is derivable from the :class:`~repro_torch.configs.base.ModelConfig`:

    train:  params + grads + adam(m, v) + activations(microbatch)
    serve:  params + KV cache(context) + activation working set

The reference's XLA dry-run path cross-checks these numbers against
``compiled.memory_analysis()``; the port has no counterpart of that
tooling yet.  Each function returns the reference's bytes exactly, its
blind spots included: the MoE term counts every layer as MoE whatever
``moe_every`` says, and the encoder-decoder's f32 encoder attention slabs
are not counted.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

BF16 = 2
FP32 = 4


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (embedding + per-layer + head)."""
    d, v = cfg.d_model, cfg.vocab
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    if cfg.family == "ssm":
        per_layer = _ssm_layer_params(cfg)
        layers = cfg.n_layers * per_layer
    elif cfg.family == "hybrid":
        ssm = _ssm_layer_params(cfg)
        layers = cfg.n_layers * ssm
        # one weight-tied shared attention+mlp block (zamba2)
        layers += _attn_params(cfg) + _mlp_params(cfg)
    else:
        attn = _attn_params(cfg)
        if cfg.n_experts:
            mlp = cfg.n_experts * _mlp_params(cfg) + d * cfg.n_experts  # router
        else:
            mlp = _mlp_params(cfg)
        per_layer = attn + mlp + 2 * d  # two norms
        layers = cfg.n_layers * per_layer
        if cfg.enc_layers:  # whisper encoder + cross-attention in decoder
            enc_layer = _attn_params(cfg) + _mlp_params(cfg) + 2 * d
            layers += cfg.enc_layers * enc_layer
            layers += cfg.n_layers * _attn_params(cfg)  # cross-attn
    return emb + layers + d  # final norm


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only top_k experts) — used for
    MODEL_FLOPS = 6 * N_active * D in the roofline."""
    if not cfg.n_experts:
        return param_count(cfg)
    dense = param_count(cfg) - cfg.n_layers * cfg.n_experts * _mlp_params(cfg)
    return dense + cfg.n_layers * cfg.top_k * _mlp_params(cfg)


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q = d * cfg.n_heads * hd
    kv = 2 * d * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * d
    qknorm = 2 * hd if cfg.qk_norm else 0
    return q + kv + o + qknorm


def _mlp_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * cfg.d_ff


def _ssm_layer_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nheads = cfg.ssm_heads or max(1, d_inner // 64)
    # in_proj covers z, x, B, C, dt; plus conv, A, D, norm, out_proj (mamba2)
    in_proj = d * (2 * d_inner + 2 * cfg.ssm_state + nheads)
    conv = cfg.conv_width * (d_inner + 2 * cfg.ssm_state)
    out = d_inner * d
    return in_proj + conv + out + 2 * nheads + d_inner + 2 * d


@dataclasses.dataclass(frozen=True)
class FootprintEstimate:
    params_bytes: int
    optimizer_bytes: int
    gradient_bytes: int
    activation_bytes: int
    kv_cache_bytes: int
    total_bytes: int

    @property
    def total_gb(self) -> float:
        return self.total_bytes / 1024 ** 3


def kv_cache_bytes(cfg: ModelConfig, batch: int, context: int,
                   dtype_bytes: int = BF16) -> int:
    """KV (or SSM-state) cache bytes for ``batch`` sequences at ``context``."""
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * cfg.d_model
        nheads = cfg.ssm_heads or max(1, d_inner // 64)
        per_layer = (nheads * (d_inner // max(nheads, 1)) * cfg.ssm_state
                     + cfg.conv_width * (d_inner + 2 * cfg.ssm_state))
        return cfg.n_layers * batch * per_layer * dtype_bytes
    per_tok_layer = 2 * cfg.n_kv_heads * hd * dtype_bytes
    n_attn_layers = cfg.n_layers + (cfg.enc_layers and cfg.n_layers)  # + cross
    if cfg.family == "hybrid":
        n_attn_layers = max(1, cfg.n_layers // max(cfg.attn_every, 1))
        d_inner = cfg.ssm_expand * cfg.d_model
        nheads = cfg.ssm_heads or max(1, d_inner // 64)
        ssm_bytes = cfg.n_layers * batch * (
            nheads * (d_inner // max(nheads, 1)) * cfg.ssm_state
            + cfg.conv_width * (d_inner + 2 * cfg.ssm_state)) * dtype_bytes
        return ssm_bytes + n_attn_layers * batch * context * per_tok_layer
    # windowed ring caches for local layers — only when the model actually
    # allocates them (cfg.windowed_cache); the estimator must match the
    # implementation, not the ideal (gemma3's windowed ring cache)
    if cfg.windowed_cache and cfg.sliding_window and cfg.global_every:
        n_global = cfg.n_layers // cfg.global_every
        n_local = cfg.n_layers - n_global
        local_ctx = min(context, cfg.sliding_window)
        return batch * per_tok_layer * (n_global * context + n_local * local_ctx)
    return n_attn_layers * batch * context * per_tok_layer


def activation_bytes_train(cfg: ModelConfig, batch: int, seq: int,
                           dtype_bytes: int = BF16,
                           checkpoint_policy: str = "layer") -> int:
    """Saved-activation bytes with per-layer remat (store layer inputs only)."""
    base = cfg.n_layers * batch * seq * cfg.d_model * dtype_bytes
    if checkpoint_policy == "none":
        mult = 8 if not cfg.n_experts else 10
        return mult * base
    # plus the live working set of one layer's recompute
    working = batch * seq * max(cfg.d_ff, 2 * cfg.ssm_expand * cfg.d_model
                                ) * dtype_bytes
    return base + working


def estimate_train(cfg: ModelConfig, batch: int, seq: int,
                   optimizer: str = "adamw",
                   param_dtype_bytes: int = BF16) -> FootprintEstimate:
    n = param_count(cfg)
    p = n * param_dtype_bytes
    g = n * param_dtype_bytes
    opt = n * 2 * FP32 if optimizer == "adamw" else 0
    act = activation_bytes_train(cfg, batch, seq)
    total = p + g + opt + act
    return FootprintEstimate(p, opt, g, act, 0, total)


def estimate_serve(cfg: ModelConfig, batch: int, context: int,
                   param_dtype_bytes: int = BF16) -> FootprintEstimate:
    n = param_count(cfg)
    p = n * param_dtype_bytes
    kv = kv_cache_bytes(cfg, batch, context)
    act = batch * max(cfg.d_model * 8, cfg.d_ff) * param_dtype_bytes * 4
    total = p + kv + act
    return FootprintEstimate(p, 0, 0, act, kv, total)
