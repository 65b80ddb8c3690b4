"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936, act="swiglu", qk_norm=True,
    rope_theta=1_000_000.0, max_seq_len=32_768,
    source="hf:Qwen/Qwen3-8B (qwen3 family)")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
