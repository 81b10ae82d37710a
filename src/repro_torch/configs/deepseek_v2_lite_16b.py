"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512, 64 routed experts top-6 + 2 shared experts.
[arXiv:2405.04434; hf] (header config: 64e top-6)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    kv_lora=512,
    source="arXiv:2405.04434",
)
