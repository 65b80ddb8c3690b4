"""whisper-medium [audio]: 24L enc + 24L dec, d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865; conv/mel frontend STUBBED (frame embeddings via
input_specs).  [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865, act="gelu",
    enc_layers=24, enc_seq=1500,
    tie_embeddings=True, max_seq_len=32_768,
    source="arXiv:2212.04356 (Whisper)")


def smoke() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
