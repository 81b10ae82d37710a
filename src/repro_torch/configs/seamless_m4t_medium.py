"""seamless-m4t-medium [audio]: 12L enc + 12L dec d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 — enc-dec; audio frontend STUB (the batch carries
precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    enc_layers=12,
    dec_layers=12,
    frontend="audio",
    frontend_dim=160,
    source="arXiv:2308.11596",
)
