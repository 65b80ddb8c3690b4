"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt family card / Gemma 3 technical report]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144, act="geglu", qk_norm=True,
    sliding_window=1024, global_every=6, rope_theta=1_000_000.0,
    max_seq_len=131_072,
    source="hf:google/gemma-3-1b-pt (gemma-3 family report)")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
