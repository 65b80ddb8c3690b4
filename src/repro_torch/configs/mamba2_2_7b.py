"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free, ssm_state=128,
SSD (state-space duality).  [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=64,
    ssm_state=128, ssm_heads=80, ssm_expand=2, ssm_chunk=256, conv_width=4,
    tie_embeddings=True, max_seq_len=1_048_576,
    source="arXiv:2405.21060 (Mamba-2)")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
