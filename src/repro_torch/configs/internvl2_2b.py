"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT frontend (STUB: input_specs provides precomputed
patch embeddings) + InternLM2 decoder. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    frontend="vit",
    frontend_dim=1024,
    n_frontend_tokens=256,
    source="arXiv:2404.16821",
)
