"""granite-4.0-h-small [hybrid_moe]: 40L d_model=4096, nine Mamba2 layers
(128 heads of 64, state 128) to one NoPE GQA layer (32 heads, 8 KV, 128
wide), every layer followed by a MoE of 72 experts of 768, top-10, and a
shared SwiGLU expert of 1536; vocab 100352, tied.
[hf:ibm-granite/granite-4.0-h-small config.json]

The published config gives the attention layers as ``layer_types``
(attention at 5, 15, 25 and 35); ``attn_layers`` keeps those indices, so a
config cut to fewer layers keeps the ones that remain.  ``intermediate_size``
(768) is read as one expert's width (``d_ff``), ``shared_intermediate_size``
as the shared expert's.  :data:`ONE_CARD` is the cut that one 80 GB card
serves: layers 0-19, two whole periods (18 Mamba2, 2 attention), 16.3e9
parameters, 30.4 GiB in bf16, the first stage of a two-stage pipeline.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab=100352,
    n_experts=72, top_k=10,
    ssm_state=128, ssm_heads=128, ssm_expand=2, ssm_chunk=256, conv_width=4,
    tie_embeddings=True, max_seq_len=131_072, norm_eps=1e-5,
    attn_layers=(5, 15, 25, 35), shared_ff=1536,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0, nope=True,
    source="hf:ibm-granite/granite-4.0-h-small")

#: the depth one 80 GB card serves, widths as published
ONE_CARD = dataclasses.replace(CONFIG, n_layers=20)


def smoke() -> ModelConfig:
    """A whole period at CPU size: layers 0-5 (five Mamba2, the attention
    layer at 5), 8 experts of 64 top-2, a shared expert of 96, every
    multiplier as published."""
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab=512, n_experts=8, top_k=2, ssm_state=16, ssm_heads=4,
        ssm_chunk=32, shared_ff=96, max_seq_len=1024)
