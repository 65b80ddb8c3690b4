"""gemma-2b [dense]: 18L d_model=2048 8H d_ff=16384 vocab=256000, GeGLU,
head_dim=256, MQA (kv=1).  [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu",
    max_seq_len=8192,
    source="arXiv:2403.08295 (Gemma)")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
