"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend STUBBED (patch embeddings provided by
input_specs).  [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, act="swiglu",
    vision_tokens=256, vision_embed_dim=1024,
    rope_theta=1_000_000_000.0, max_seq_len=131_072,
    source="hf:mistralai/Pixtral-12B-2409")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
