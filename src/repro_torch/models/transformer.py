"""Decoder-only LM, dense family (port of ``repro/models/transformer.py`` at
tp = 1).

Parameters are a flat dict of leaves, not ``nn.Module`` state, because the
compressor works per leaf and the leaf set decides the integer images: each
leaf gets one encode seed, one PRNG counter range and one word array. The
port keeps the JAX package's leaves exactly — each per-layer weight is ONE
leaf with a leading layer axis — named by their pytree paths joined with
"/" (``layers/mlp/w_up``); :func:`repro_torch.utils.tree.leaf_names` sorts
them into ``jax.tree.flatten`` order. The layer loop indexes the stacked
tensors (via ``unbind``, whose backward is a single stack).

The forward runs in the activation type ``dtype`` (bf16 on the train path)
with float32 parameters, norms, attention softmax and logits, as the JAX
package does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.scaling import AlphaState
from repro_torch.models.attention import attention_train
from repro_torch.models.common import cross_entropy, dense_init, rmsnorm
from repro_torch.models.mlp import swiglu_mlp

Tree = Dict[str, torch.Tensor]

LAYER_LEAVES = (
    "attn/wk", "attn/wo", "attn/wq", "attn/wv", "ln1", "ln2",
    "mlp/w_down", "mlp/w_gate", "mlp/w_up",
)


def _check_ported(cfg) -> None:
    missing = [
        what for what, on in (
            (f"family {cfg.family!r}", cfg.family != "dense"),
            ("sliding-window attention", cfg.window is not None),
            ("QKV bias", cfg.qkv_bias),
            ("tied embeddings", cfg.tie_embeddings),
            ("a modality frontend", cfg.frontend is not None),
        ) if on
    ]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port runs "
            "the dense decoder family)"
        )


def _head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.n_heads


def param_shapes(cfg) -> Dict[str, tuple]:
    """Leaf name -> shape; layer leaves carry the leading layer axis."""
    _check_ported(cfg)
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    q, kv = cfg.n_heads * _head_dim(cfg), cfg.n_kv_heads * _head_dim(cfg)
    return {
        "embed": (v, d),
        "layers/attn/wk": (L, d, kv),
        "layers/attn/wo": (L, q, d),
        "layers/attn/wq": (L, d, q),
        "layers/attn/wv": (L, d, kv),
        "layers/ln1": (L, d),
        "layers/ln2": (L, d),
        "layers/mlp/w_down": (L, f, d),
        "layers/mlp/w_gate": (L, d, f),
        "layers/mlp/w_up": (L, d, f),
        "lm_head": (d, v),
        "ln_f": (d,),
    }


def init_lm_params(cfg, *, generator: torch.Generator, device,
                   dtype=torch.float32) -> Tree:
    """Random weights from ``generator`` (the JAX package's distributions:
    uniform ±1/√fan_in for matrices, ones for norms), on ``device``."""
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(("ln1", "ln2", "ln_f")):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan_in = cfg.d_model if name == "embed" else shape[-2]
            params[name] = dense_init(
                shape, fan_in, generator=generator, device=device, dtype=dtype
            )
    return params


def _dense_layer(lp, x, positions, cfg):
    attn = {k[len("attn/"):]: v for k, v in lp.items() if k.startswith("attn/")}
    mlp = {k[len("mlp/"):]: v for k, v in lp.items() if k.startswith("mlp/")}
    h = x + attention_train(
        attn, rmsnorm(x, lp["ln1"]), positions,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=_head_dim(cfg),
        rope_theta=cfg.rope_theta,
    )
    return h + swiglu_mlp(mlp, rmsnorm(h, lp["ln2"]))


def lm_forward(params: Tree, batch, cfg, dtype=torch.bfloat16) -> torch.Tensor:
    """Hidden states after the final norm: (B, T, d)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    x = F.embedding(tokens, params["embed"]).to(dtype)
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    layers = {n: params[f"layers/{n}"].unbind(0) for n in LAYER_LEAVES}
    for i in range(cfg.n_layers):
        x = _dense_layer({n: layers[n][i] for n in LAYER_LEAVES}, x, positions, cfg)
    return rmsnorm(x, params["ln_f"])


def lm_loss(params: Tree, batch, cfg, dtype=torch.bfloat16) -> torch.Tensor:
    """Mean next-token cross entropy over labelled positions (float32)."""
    h = lm_forward(params, batch, cfg, dtype)
    logits = (h @ params["lm_head"].to(h.dtype)).to(torch.float32)
    labels = batch["labels"]
    per_tok = cross_entropy(logits, labels)
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def params_from_jax(tree_of_numpy, device, prefix: str = "") -> Tree:
    """JAX ``init_lm_params`` output pulled to the host (tp = 1, nested dict
    of numpy arrays, stacked layer axis kept) -> the port's leaf dict on
    ``device``, names joined with "/"."""
    out = {}
    for k, v in tree_of_numpy.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(params_from_jax(v, device, name + "/"))
        else:
            out[name] = torch.from_numpy(np.array(v)).to(device)
    return out


def opt_state_from_jax(state_of_numpy, device) -> Dict[str, object]:
    """JAX fused-route optimizer state (``{"mom": tree}`` for SGD,
    ``{"mu": tree, "nu": tree, "count": int32 scalar}`` for AdamW) -> the
    port's: a leaf dict per tree, a tensor per scalar."""
    return {
        name: params_from_jax(t, device) if isinstance(t, dict)
        else torch.from_numpy(np.array(t)).to(device)
        for name, t in state_of_numpy.items()
    }


def _first(v, device) -> torch.Tensor:
    """Worker 0's entry of a leaf stacked over the workers."""
    return torch.from_numpy(np.array(np.array(v)[0])).to(device)


def _alpha_state_from_jax(alpha, device) -> AlphaState:
    """A stacked JAX ``AlphaState`` -> worker 0's: r a 0-d tensor (global
    rules) or a leaf dict of them (blockwise α)."""
    if isinstance(alpha.r, dict):
        r = {k: v[0].clone() for k, v in params_from_jax(alpha.r, device).items()}
    else:
        r = _first(alpha.r, device)
    return AlphaState(r=r, step=_first(alpha.step, device))


def comp_state_from_jax(state_of_numpy, device):
    """JAX compressor state, stacked over the workers as the JAX step and
    ``vmap_workers`` hold it (every leaf with a leading worker axis) -> the
    port's. IntSGD's is a bare ``AlphaState(r, step)`` (r a per-leaf tree
    for blockwise α), taken from worker 0. IntDIANA's is ``{"alpha":
    AlphaState, "h_local": tree, "h_global": tree}``: h_local kept stacked
    ``(n, *shape)`` per leaf, the replicated h_global and α state taken
    from worker 0."""
    if not isinstance(state_of_numpy, dict):
        return _alpha_state_from_jax(state_of_numpy, device)
    return {
        "alpha": _alpha_state_from_jax(state_of_numpy["alpha"], device),
        "h_local": params_from_jax(state_of_numpy["h_local"], device),
        "h_global": {
            k: v[0].clone()
            for k, v in params_from_jax(state_of_numpy["h_global"], device).items()
        },
    }
