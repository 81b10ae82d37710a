"""Single-token decode (the serve path) of the attention families, with
their caches (port of ``repro/models/decode.py`` at tp = 1).

The cache is a flat dict of stacked leaves, as the params are, each with a
leading layer axis::

    dense / vlm / moe, GQA : {"layers/k", "layers/v": (L, B, S, Hkv, dh),
                              "layers/kv_pos": (L, B, S) int32}
    MLA (a ``kv_lora``)    : {"layers/c_kv": (L, B, S, kv_lora),
                              "layers/k_r": (L, B, S, 64), "layers/kv_pos"}

:func:`lm_decode_step` runs one token per sequence through the layers in a
Python loop over the stacked leaves (the JAX package's ``lax.scan``) and
writes each layer's cache in place; the final norm and the logits follow
``lm_logits_local``: the product in the step's type, then float32. The JAX
package's decode is plain XLA, so this is plain PyTorch (``torch.matmul``
and attention's explicit softmax); no TPU kernel stands behind it.

The hybrid (Mamba2), ssm (xLSTM) and encdec caches are refused: their
decode halves are not ported yet (ROADMAP item 12.5b). At tp = 1 the JAX
package's vocab-sharded greedy pick is the argmax (:func:`tp_greedy`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.attention import attention_decode, init_cache
from repro_torch.models.common import rmsnorm
from repro_torch.models.mla import init_mla_cache, mla_decode
from repro_torch.models.mlp import swiglu_mlp
from repro_torch.models.moe import moe_tp
from repro_torch.models.transformer import (
    _check_ported, _head_dim, _sub, lm_logits, params_from_jax,
)

Tree = Dict[str, torch.Tensor]
DECODE_FAMILIES = ("dense", "vlm", "moe")


def _check_decode(cfg) -> None:
    """Refuse a config whose decode is not ported yet."""
    if cfg.family not in DECODE_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: decode of family {cfg.family!r} is not ported yet (the port's "
            f"decode step runs the attention families {', '.join(DECODE_FAMILIES)}; the "
            "Mamba2, xLSTM and encoder-decoder caches are ROADMAP item 12.5b)")
    _check_ported(cfg)


def init_lm_cache(cfg, batch: int, seq: int, *, device, dtype=torch.bfloat16) -> Tree:
    """An empty cache of ``batch`` sequences of up to ``seq`` tokens for
    every layer: MLA's latent cache where the config has a ``kv_lora``,
    else the GQA KV cache."""
    _check_decode(cfg)
    if cfg.kv_lora:
        base = init_mla_cache(batch, seq, kv_lora=cfg.kv_lora, device=device, dtype=dtype)
    else:
        base = init_cache(batch, seq, n_kv_heads=cfg.n_kv_heads, head_dim=_head_dim(cfg),
                          device=device, dtype=dtype)
    return {f"layers/{k}": v.expand(cfg.n_layers, *v.shape).clone() for k, v in base.items()}


def cache_from_jax(tree_of_numpy, device) -> Tree:
    """JAX ``init_lm_cache`` / ``lm_decode_step`` cache pulled to the host
    (tp = 1, nested dict of numpy arrays, stacked layer axis kept) -> the
    port's flat cache on ``device``; bf16 entries stay bf16 (exactly)."""
    return params_from_jax(tree_of_numpy, device)


def _attn_decode_any(lp, h, pos, lc, cfg):
    if cfg.kv_lora:
        return mla_decode(lp, h, pos, lc, n_heads=cfg.n_heads, head_dim=_head_dim(cfg))
    return attention_decode(lp, h, pos, lc, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                            head_dim=_head_dim(cfg), rope_theta=cfg.rope_theta,
                            window=cfg.window)


def lm_decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, pos: torch.Tensor, cfg,
                   dtype=torch.bfloat16):
    """tokens: (B,) ids of this step; pos: (B,) their positions. Writes
    each layer's cache at ``pos`` in place. Returns ``(logits (B, V)
    float32, cache)``."""
    _check_decode(cfg)
    x = F.embedding(tokens[:, None], params["embed"]).to(dtype)
    layers = _sub(params, "layers/")
    caches = _sub(cache, "layers/")
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        a, _ = _attn_decode_any(_sub(lp, "attn/"), rmsnorm(x, lp["ln1"]), pos,
                                {k: v[i] for k, v in caches.items()}, cfg)
        x = x + a
        z = rmsnorm(x, lp["ln2"])
        if cfg.family == "moe":
            x = x + moe_tp(_sub(lp, "moe/"), z, n_experts=cfg.n_experts, top_k=cfg.top_k)
        else:
            x = x + swiglu_mlp(_sub(lp, "mlp/"), z)
    h = rmsnorm(x, params["ln_f"])
    return lm_logits(params, h, cfg)[:, 0], cache


def tp_greedy(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token per row: the argmax, ties to the first index (the
    JAX package's ``tp_greedy`` on one vocab shard)."""
    return torch.argmax(logits, dim=-1)
