"""Architecture and shape configs (port of ``repro/configs/base.py``; the
port keeps its own copy — it imports nothing from the JAX package).

The port runs the dense decoder family (its ``vlm`` member, internvl2-2b,
with the modality frontend stub), the ``moe`` family, the ``hybrid``
family, the ``ssm`` (xLSTM) family and the ``encdec`` family: granite-8b,
minitron-4b, qwen2.5-32b, h2o-danube-3-4b, internvl2-2b, mixtral-8x22b,
deepseek-v2-lite-16b (MLA), zamba2-2.7b (Mamba2 with a shared attention
block), xlstm-125m (mLSTM and sLSTM blocks, tied embeddings) and
seamless-m4t-medium (encoder-decoder, the audio frontend stub) are
registered, all ten of the JAX package's configs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window attention
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    # MLA
    kv_lora: int = 0
    # hybrid / ssm
    ssm_state: int = 0
    attn_every: int = 0
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # modality frontend stub
    frontend: Optional[str] = None
    frontend_dim: int = 0
    n_frontend_tokens: int = 0
    tie_embeddings: bool = False
    remat_policy: str = "full"
    source: str = ""

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (the ssm and hybrid families, a window)."""
        return self.family in ("ssm", "hybrid") or self.window is not None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# in the JAX package's registry order (the order of its cells)
_ARCH_MODULES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-8b": "granite_8b",
    "minitron-4b": "minitron_4b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-2b": "internvl2_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def ported_archs() -> list:
    """The names :func:`get_arch` takes, sorted."""
    return sorted(_ARCH_MODULES)


def get_arch(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise ValueError(f"arch {name!r} is not ported yet; the port has {ported_archs()}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}"
    ).CONFIG


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise ValueError(f"unknown shape {name!r}; options {sorted(SHAPES)}")
    return SHAPES[name]


def runnable_cells() -> list:
    """All 40 (arch, shape, runnable) cells; long_500k runs only where the
    arch is subquadratic (a full-attention arch skips it, as in the JAX
    package)."""
    return [(a, s, s != "long_500k" or get_arch(a).subquadratic)
            for a in _ARCH_MODULES for s in SHAPES]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the JAX package's
    reduction, field for field)."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        kv_lora=32 if cfg.kv_lora else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=16 if cfg.ssm_state else 0,
        attn_every=2 if cfg.attn_every else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        dec_layers=2 if cfg.dec_layers else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
        window=64 if cfg.window else None,
    )
    if cfg.family == "hybrid":
        kw["n_layers"] = 4
    if cfg.family == "ssm":
        kw["n_layers"] = 3
        kw["head_dim"] = 16
    return dataclasses.replace(cfg, **kw)
