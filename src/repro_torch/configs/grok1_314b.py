"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, act="geglu",
    n_experts=8, top_k=2, moe_every=1,
    max_seq_len=8192,
    source="hf:xai-org/grok-1")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
