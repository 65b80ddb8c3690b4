"""Unified model API over every family of the reference, routed by family
as in the reference: the encoder-decoder (whisper) to :mod:`models.encdec`,
the hybrid (zamba2) to :mod:`models.hybrid`, the dense, VLM, MoE and ssm
stacks to :mod:`models.transformer`; and the port's own hybrid MoE (IBM
Granite 4.0-H) to :mod:`models.hybrid_moe`.

A "batch" is a dict:
    tokens   [B, S] int             (all families)
    labels   [B, S] int             (training; -1 = masked)
    frames   [B, enc_seq, d]        (audio stub frontend)
    patches  [B, vision_tokens, d]  (VLM stub frontend)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, hybrid_moe, transformer
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.transformer import DecoderOutput


def init_params(generator: torch.Generator | None, cfg: ModelConfig,
                device: str | torch.device | None = None
                ) -> tuple[dict, dict]:
    """Returns (params, logical-axis specs), drawn from ``generator`` on its
    device (or on ``device``; ``'meta'`` takes no generator)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    if cfg.family == "audio":
        return encdec.init_encdec(generator, cfg, device)
    if cfg.family == "hybrid":
        return hybrid.init_hybrid(generator, cfg, device)
    if cfg.family == "hybrid_moe":
        return hybrid_moe.init_hybrid_moe(generator, cfg, device)
    return transformer.init_decoder(generator, cfg, device)


def forward(params: dict, cfg: ModelConfig, batch: dict) -> DecoderOutput:
    if cfg.family == "audio":
        return encdec.forward(params, cfg, batch["tokens"], batch["frames"])
    if cfg.family == "hybrid":
        return hybrid.forward(params, cfg, batch["tokens"])
    if cfg.family == "hybrid_moe":
        return hybrid_moe.forward(params, cfg, batch["tokens"])
    return transformer.forward(params, cfg, batch["tokens"],
                               extra_embeddings=batch.get("patches"))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            aux_weight: float = 0.01) -> tuple[torch.Tensor, DecoderOutput]:
    """The training loss: mean next-token CE over the batch's ``labels``
    plus ``aux_weight`` times the model's auxiliary loss (the MoE layers'
    summed load-balancing loss; zero for the other families)."""
    out = forward(params, cfg, batch)
    ce = cross_entropy_loss(out.logits, batch["labels"], cfg.vocab)
    return ce + aux_weight * out.aux_loss, out


def init_caches(cfg: ModelConfig, batch: int, context: int,
                device: str | torch.device = "cpu") -> dict:
    if cfg.family == "audio":
        return encdec.init_caches(cfg, batch, context, device)
    if cfg.family == "hybrid":
        return hybrid.init_caches(cfg, batch, context, device)
    if cfg.family == "hybrid_moe":
        return hybrid_moe.init_caches(cfg, batch, context, device)
    return transformer.init_caches(cfg, batch, context, device)


def prefill_encoder(params: dict, cfg: ModelConfig, batch: dict,
                    caches: dict) -> dict:
    """Enc-dec models: run the encoder once over ``batch["frames"]`` and
    stash the cross K/V in ``caches`` (in place); the other families'
    caches come back untouched."""
    if cfg.family == "audio":
        return encdec.prefill_cross_kv(params, cfg, batch["frames"], caches)
    return caches


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                index: int | torch.Tensor, caches: dict,
                capacity_moe: bool = False) -> tuple[torch.Tensor, dict]:
    """One decode step at position ``index``, an ``int`` or a 0-dim int64
    tensor on the step's device (then nothing reads it on the host, and
    with ``capacity_moe`` the step reads no device value on the host at
    all, so it can be captured as a CUDA graph); ``capacity_moe`` sends
    MoE layers through the capacity dispatch
    (:func:`transformer.decode_step`)."""
    if cfg.family == "audio":
        return encdec.decode_step(params, cfg, token, index, caches)
    if cfg.family == "hybrid":
        return hybrid.decode_step(params, cfg, token, index, caches)
    if cfg.family == "hybrid_moe":
        return hybrid_moe.decode_step(params, cfg, token, index, caches,
                                      capacity_moe=capacity_moe)
    return transformer.decode_step(params, cfg, token, index, caches,
                                   capacity_moe=capacity_moe)


def supports_long_context(cfg: ModelConfig) -> bool:
    return cfg.has_subquadratic_attention


def moe_layers(cfg: ModelConfig) -> int:
    """The layers with a routed MoE FFN (0 without experts)."""
    if not cfg.n_experts:
        return 0
    if cfg.family == "hybrid_moe":
        return cfg.n_layers
    return cfg.n_layers // cfg.moe_every


# -- logical-axis spec trees (read by the dry run to place each tensor) -------

KV_SPEC = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
SSM_CONV_SPEC = ("layers", "batch", None, "ssm_inner")
SSM_STATE_SPEC = ("layers", "batch", "ssm_inner", None, None)


WKV_LOCAL_SPEC = ("layers", "layers2", "batch", "cache_seq", "kv_heads",
                  "head_dim")
WKV_TAIL_SPEC = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")


def cache_specs(cfg: ModelConfig) -> dict:
    """Logical axes mirroring :func:`init_caches`' structure."""
    if cfg.family == "ssm":
        return {"ssm": {"conv": SSM_CONV_SPEC, "state": SSM_STATE_SPEC}}
    if cfg.kv_quant and cfg.family in ("dense", "vlm") \
            and not cfg.n_experts:
        return {"k_q": KV_SPEC, "k_s": KV_SPEC,
                "v_q": KV_SPEC, "v_s": KV_SPEC}
    if (cfg.windowed_cache and cfg.sliding_window and cfg.global_every
            and not cfg.n_experts and cfg.family not in ("audio", "hybrid")):
        from repro_torch.models.transformer import windowed_layout
        _, _, tail = windowed_layout(cfg)
        out = {"local_k": WKV_LOCAL_SPEC, "local_v": WKV_LOCAL_SPEC,
               "global_k": KV_SPEC, "global_v": KV_SPEC}
        if tail:
            out["tail_k"] = WKV_TAIL_SPEC
            out["tail_v"] = WKV_TAIL_SPEC
        return out
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import _group_shape
        _, remainder = _group_shape(cfg)
        out = {
            "ssm": {"conv": SSM_CONV_SPEC, "state": SSM_STATE_SPEC},
            "attn_k": KV_SPEC, "attn_v": KV_SPEC,
        }
        if remainder:
            out["ssm_tail"] = {"conv": SSM_CONV_SPEC,
                               "state": SSM_STATE_SPEC}
        return out
    if cfg.family == "audio":
        return {"k": KV_SPEC, "v": KV_SPEC,
                "cross_k": KV_SPEC, "cross_v": KV_SPEC}
    return {"k": KV_SPEC, "v": KV_SPEC}


def batch_specs(cfg: ModelConfig, with_labels: bool) -> dict:
    out = {"tokens": ("batch", "seq")}
    if with_labels:
        out["labels"] = ("batch", "seq")
    if cfg.family == "audio":
        out["frames"] = ("batch", None, None)
    if cfg.family == "vlm" and cfg.vision_tokens:
        out["patches"] = ("batch", None, None)
    return out


def prefill(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Forward over the prompt returning ONLY the last position's logits.
    Its MoE layers dispatch by capacity over groups of tokens, as the
    reference's ``forward`` does; the engine's :func:`prefill_caches`
    routes each token alone, as the reference engine's replay does."""
    if cfg.family == "audio":
        return encdec.forward(params, cfg, batch["tokens"], batch["frames"],
                              last_only=True).logits
    if cfg.family in ("hybrid", "hybrid_moe"):
        module = hybrid if cfg.family == "hybrid" else hybrid_moe
        return module.forward(params, cfg, batch["tokens"],
                              last_only=True).logits
    return transformer.forward(params, cfg, batch["tokens"],
                               extra_embeddings=batch.get("patches"),
                               last_only=True).logits


def prefill_caches(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   caches: dict) -> tuple[torch.Tensor, dict]:
    """The serving engine's prefill: one forward over the padded [B,S]
    prompt batch that fills ``caches`` in place as a replay of the prompt
    through :func:`decode_step` would, returning (last logits [B,1,V],
    caches).  For the encoder-decoder the caches' cross K/V must already
    hold the encoder's (:func:`prefill_encoder`)."""
    if cfg.family == "audio":
        return encdec.prefill(params, cfg, tokens, caches)
    if cfg.family == "hybrid":
        return hybrid.prefill(params, cfg, tokens, caches)
    if cfg.family == "hybrid_moe":
        return hybrid_moe.prefill(params, cfg, tokens, caches)
    return transformer.prefill(params, cfg, tokens, caches)


def make_dummy_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     device: str | torch.device = "cpu") -> dict:
    """Random tokens/labels (and audio frames or VLM patches) from a numpy
    seed; the stub-frontend tensors in bf16, as the reference's."""
    rng = np.random.default_rng(seed)
    out = {
        "tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int64)),
        "labels": torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int64)),
    }
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)
        ).to(torch.bfloat16)
    if cfg.family == "vlm" and cfg.vision_tokens:
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.d_model), dtype=np.float32)
        ).to(torch.bfloat16)
    return {k: v.to(device) for k, v in out.items()}
