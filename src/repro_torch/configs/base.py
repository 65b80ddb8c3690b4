"""Model/architecture configuration (the port's own copy).

Same fields and defaults as :class:`repro.configs.base.ModelConfig`, so a
config built for one package describes the same model in the other.  The
port runs every family of the reference: the dense decoder (qwen3, gemma,
gemma3's 5:1 local:global sliding window), the VLM decoder (pixtral, stub
patch embeddings), the MoE decoder (grok-1 with a MoE FFN in every layer,
llama4-maverick with dense and MoE layers interleaved and chunked local
attention), the Mamba2 (ssm) stack, the zamba2 hybrid and the whisper
encoder-decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    qk_norm: bool = False
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    rope_theta: float = 10_000.0
    # -- attention pattern ----------------------------------------------------
    sliding_window: int | None = None    # window for local layers
    global_every: int | None = None      # 1 global layer per N (gemma3 5:1 -> 6)
    attention_chunk: int | None = None   # llama4 iRoPE chunked-local attention
    # -- MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1                   # MoE layer every N layers (llama4: 2)
    # -- SSM (Mamba2 / SSD) -------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0                   # mamba2 value heads (P=64 head dim)
    ssm_chunk: int = 256                 # SSD chunk length
    ssm_expand: int = 2
    conv_width: int = 4
    # -- hybrid (zamba2) ----------------------------------------------------------
    attn_every: int = 0                  # shared attn block every N ssm blocks
    # -- enc-dec (whisper) ----------------------------------------------------------
    enc_layers: int = 0
    enc_seq: int = 0                     # encoder positions (stub frontend)
    # -- VLM (pixtral) ---------------------------------------------------------------
    vision_tokens: int = 0               # stub patch embeddings prepended
    vision_embed_dim: int = 0
    # -- misc ------------------------------------------------------------------------
    tie_embeddings: bool = True
    max_seq_len: int = 131_072
    norm_eps: float = 1e-6
    attn_q_block: int = 512              # q-block size for blocked attention
    windowed_cache: bool = False         # ring-buffer KV on local layers
    kv_quant: bool = False               # int8 KV cache
    # 'onehot' is a row lookup in the port (bit-identical to the one-hot
    # contraction, see models/layers.embed_tokens); 'gather' is the same
    embed_impl: str = "onehot"
    # 'xla' = plain blocked attention; 'pallas' = the hand-written flash
    # kernel (kernels/csrc/flash_attention.cu on the card)
    attn_impl: str = "xla"
    # 'xla' = plain chunked SSD (models/ssm.ssd_chunked); 'pallas' = the
    # hand-written SSD chunk-scan kernel (kernels/csrc/ssd_scan.cu)
    ssm_impl: str = "xla"
    source: str = ""                     # citation for the config

    @property
    def kv_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_subquadratic_attention(self) -> bool:
        """True if long-context decode (500k) is admissible."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None or self.attention_chunk is not None

    def layer_is_global(self, layer_idx: int) -> bool:
        """Attention-pattern schedule: gemma3 runs 5 local then 1 global."""
        if self.sliding_window is None and self.attention_chunk is None:
            return True
        if self.global_every is None:
            return False
        return (layer_idx + 1) % self.global_every == 0


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU tests (<=2 layers,
    d_model<=256, <=4 experts) -- the reference's reduction, unchanged."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    head_dim = d_model // n_heads if n_heads else None
    changes: dict = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=(min(cfg.n_kv_heads, max(1, n_heads // 2))
                    if cfg.n_kv_heads else 0),
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        max_seq_len=1024,
    )
    if cfg.n_experts:
        changes["n_experts"] = min(cfg.n_experts, 4)
        changes["top_k"] = min(cfg.top_k, 2)
    if cfg.ssm_state:
        changes["ssm_state"] = min(cfg.ssm_state, 16)
        changes["ssm_heads"] = min(cfg.ssm_heads or 4, 4)
        changes["ssm_chunk"] = 32
    if cfg.attn_every:
        changes["attn_every"] = 1
    if cfg.enc_layers:
        changes["enc_layers"] = 2
        changes["enc_seq"] = 64
    if cfg.vision_tokens:
        changes["vision_tokens"] = 16
        changes["vision_embed_dim"] = min(cfg.vision_embed_dim, 128)
    if cfg.sliding_window:
        changes["sliding_window"] = min(cfg.sliding_window, 64)
    if cfg.attention_chunk:
        changes["attention_chunk"] = min(cfg.attention_chunk, 64)
    if cfg.global_every:
        changes["global_every"] = 2
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
