"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (routed expert), vocab=202048, MoE 128 experts top-1, MoE every
2nd layer (dense interleave d_ff=16384), chunked local attention (8192,
iRoPE) with 1 global layer per 4.  [hf:meta-llama/Llama-4-Scout-17B-16E
family card; maverick dims]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, act="swiglu",
    n_experts=128, top_k=1, moe_every=2,
    attention_chunk=8192, global_every=4,
    rope_theta=500_000.0, max_seq_len=1_048_576,
    attn_q_block=128,  # 40 heads don't shard over a 16-wide model axis;
                       # smaller q-blocks bound the unsharded score slab
    source="hf:meta-llama/Llama-4-Scout-17B-16E (llama4 family)")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
