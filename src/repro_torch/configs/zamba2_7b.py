"""zamba2-7b [hybrid]: 81L d_model=3584, Mamba2 backbone (ssm_state=64) +
weight-shared attention block (32H kv=32, d_ff=14336) every 6 layers.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, act="swiglu",
    ssm_state=64, ssm_heads=112, ssm_expand=2, ssm_chunk=256, conv_width=4,
    attn_every=6,
    max_seq_len=131_072,
    source="arXiv:2411.15242 (Zamba2)")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
