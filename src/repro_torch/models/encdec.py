"""Encoder-decoder transformer, train path (port of the train half of
``repro/models/encdec.py`` at tp = 1: the seamless-m4t backbone).

Encoder: the audio frontend is a stub, as in the JAX package: the batch
carries precomputed frame embeddings (B, T_src, frontend_dim), cast to
the activation type and projected by ``frontend_proj``; then per layer a
LayerNorm, QKV with RoPE on q and k, bidirectional attention, ``wo`` and
the residual, then a LayerNorm and the GELU MLP with its residual; after
the last layer ``ln_enc``. Decoder: per layer causal self-attention (the
port's ``attention_train`` with the JAX package's defaults, θ 10,000 and
no window), cross attention to the encoder states (no RoPE on either
side; K and V projected in every layer from the one encoder output, so
autograd sums ``enc_out``'s gradient over the layers) and the GELU MLP,
each behind its LayerNorm; then ``ln_dec``, float32 logits through the
untied ``lm_head`` and the masked mean cross entropy.

Parameters are a flat dict of leaves named by their JAX pytree paths
(``enc_layers/attn/wq``, ``dec_layers/ln_x/w``), every per-layer weight
one leaf with a leading layer axis, as in ``models/transformer.py``. The
JAX package wraps each layer in ``jax.checkpoint``; that changes memory,
not values, and the port keeps the activations instead. The decode half
(``init_encdec_cache``, ``encdec_prefill``, ``encdec_decode_step``) is not
ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.attention import attention_train, gqa_attend
from repro_torch.models.common import cross_entropy, dense_init, layernorm, rope
from repro_torch.models.mlp import gelu_mlp
from repro_torch.models.transformer import _attn_shapes, _head_dim, _sub

Tree = Dict[str, torch.Tensor]


def _ln_shapes(name: str, d: int) -> Dict[str, tuple]:
    return {f"{name}/b": (d,), f"{name}/w": (d,)}


def _layer_shapes(cfg, attn_names) -> Dict[str, tuple]:
    """One layer's leaves without the leading layer axis: a LayerNorm
    before each attention of ``attn_names`` (ln1, then ln_x) and before the
    GELU MLP (ln2)."""
    d, f = cfg.d_model, cfg.d_ff
    shapes = {}
    for attn, ln in zip(attn_names, ("ln1", "ln_x")):
        shapes.update(_ln_shapes(ln, d))
        shapes.update({f"{attn}/{k}": s for k, s in _attn_shapes(cfg).items()})
    shapes.update(_ln_shapes("ln2", d))
    shapes.update({"mlp/b_in": (f,), "mlp/b_out": (d,), "mlp/w_in": (d, f),
                   "mlp/w_out": (f, d)})
    return shapes


def param_shapes(cfg) -> Dict[str, tuple]:
    """Leaf name -> shape of the encoder-decoder (37 leaves); the layer
    leaves carry the leading axis ``enc_layers`` or ``dec_layers``."""
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not the encoder-decoder")
    d = cfg.d_model
    shapes = {"frontend_proj": (cfg.frontend_dim, d), "embed": (cfg.vocab, d)}
    for stack, n, attn in (("enc_layers", cfg.enc_layers, ("attn",)),
                           ("dec_layers", cfg.dec_layers, ("self_attn", "cross_attn"))):
        shapes.update({f"{stack}/{k}": (n, *s) for k, s in _layer_shapes(cfg, attn).items()})
    shapes.update({**_ln_shapes("ln_enc", d), **_ln_shapes("ln_dec", d),
                   "lm_head": (d, cfg.vocab)})
    return shapes


def _constant(name: str):
    """A leaf's constant initial value: 1 for a LayerNorm's scale (``ln*/w``),
    0 for its shift (``ln*/b``) and the MLP's ``b_in``/``b_out``; None for a
    matrix. (The decoder-only LM's ``CONSTANT_INIT`` keys on a leaf's last
    name, which here is ``w`` or ``b``.)"""
    parts = name.split("/")
    parent, last = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if parent.startswith("ln"):
        return 1.0 if last == "w" else 0.0
    return 0.0 if parent == "mlp" and last.startswith("b_") else None


def init_encdec_params(cfg, *, generator: torch.Generator, device,
                       dtype=torch.float32) -> Tree:
    """Random weights from ``generator`` (the JAX package's distributions:
    every matrix uniform ±1/√fan_in, fan_in its next-to-last axis, the
    embedding's d_model; the :func:`_constant` leaves filled), on
    ``device``, in ``dtype``."""
    params = {}
    for name, shape in param_shapes(cfg).items():
        const = _constant(name)
        if const is not None:
            params[name] = torch.full(shape, const, dtype=dtype, device=device)
        else:
            fan_in = cfg.d_model if name == "embed" else shape[-2]
            params[name] = dense_init(shape, fan_in, generator=generator, device=device,
                                      dtype=dtype)
    return params


def _layers(params: Tree, stack: str):
    """Layer i's leaves of ``stack`` (the stacked tensors unbound once)."""
    unbound = {k: v.unbind(0) for k, v in _sub(params, f"{stack}/").items()}
    n = len(next(iter(unbound.values())))
    return [{k: v[i] for k, v in unbound.items()} for i in range(n)]


def _ln(x: torch.Tensor, p, name: str) -> torch.Tensor:
    return layernorm(x, p[f"{name}/w"], p[f"{name}/b"])


def _heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return t.reshape(*t.shape[:2], n, dh)


def _project_enc_kv(p, enc_out: torch.Tensor, cfg):
    """Cross attention's K and V from the encoder states (B, Ts, Hkv, dh),
    no RoPE."""
    hkv, dh = cfg.n_kv_heads, _head_dim(cfg)
    k = enc_out @ p["wk"].to(enc_out.dtype)
    v = enc_out @ p["wv"].to(enc_out.dtype)
    return _heads(k, hkv, dh), _heads(v, hkv, dh)


def _cross_attention(p, x: torch.Tensor, enc_kv, cfg) -> torch.Tensor:
    """x: (B, Tq, d) attends every encoder position (no mask, no RoPE);
    ``enc_kv``: (k, v), each (B, Ts, Hkv, dh)."""
    q = _heads(x @ p["wq"].to(x.dtype), cfg.n_heads, _head_dim(cfg))
    return gqa_attend(q, *enc_kv, causal=False) @ p["wo"].to(x.dtype)


def _encoder_attention(p, z: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """Bidirectional self-attention: RoPE (θ 10,000) on q and k."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, _head_dim(cfg)
    q = rope(_heads(z @ p["wq"].to(z.dtype), hq, dh), positions)
    k = rope(_heads(z @ p["wk"].to(z.dtype), hkv, dh), positions)
    v = _heads(z @ p["wv"].to(z.dtype), hkv, dh)
    return gqa_attend(q, k, v, causal=False) @ p["wo"].to(z.dtype)


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, t = x.shape[:2]
    return torch.arange(t, device=x.device).expand(b, t)


def encoder_layer(lp, x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """One encoder layer: LayerNorm, bidirectional attention and the
    residual; LayerNorm, the GELU MLP and the residual."""
    x = x + _encoder_attention(_sub(lp, "attn/"), _ln(x, lp, "ln1"), positions, cfg)
    return x + gelu_mlp(_sub(lp, "mlp/"), _ln(x, lp, "ln2"))


def decoder_layer(lp, x: torch.Tensor, enc_out: torch.Tensor, positions: torch.Tensor,
                  cfg) -> torch.Tensor:
    """One decoder layer: causal self-attention, cross attention to
    ``enc_out`` (K and V projected here) and the GELU MLP, each behind its
    LayerNorm and added to the residual."""
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=_head_dim(cfg))
    x = x + attention_train(_sub(lp, "self_attn/"), _ln(x, lp, "ln1"), positions, **kw)
    cross = _sub(lp, "cross_attn/")
    kv = _project_enc_kv(cross, enc_out, cfg)
    x = x + _cross_attention(cross, _ln(x, lp, "ln_x"), kv, cfg)
    return x + gelu_mlp(_sub(lp, "mlp/"), _ln(x, lp, "ln2"))


def encode(params: Tree, frames: torch.Tensor, cfg, dtype=torch.bfloat16) -> torch.Tensor:
    """frames: (B, Ts, frontend_dim) -> encoder states (B, Ts, d) in
    ``dtype``."""
    x = frames.to(dtype) @ params["frontend_proj"].to(dtype)
    positions = _positions(x)
    for lp in _layers(params, "enc_layers"):
        x = encoder_layer(lp, x, positions, cfg)
    return _ln(x, params, "ln_enc")


def decode_states(params: Tree, enc_out: torch.Tensor, tokens: torch.Tensor, cfg,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """The decoder's hidden states after ``ln_dec``, (B, Tt, d), teacher
    forced on ``tokens`` over the encoder states ``enc_out``."""
    x = F.embedding(tokens, params["embed"]).to(dtype)
    positions = _positions(x)
    for lp in _layers(params, "dec_layers"):
        x = decoder_layer(lp, x, enc_out, positions, cfg)
    return _ln(x, params, "ln_dec")


def encdec_loss(params: Tree, batch, cfg, dtype=torch.bfloat16) -> torch.Tensor:
    """batch: frames (B, Ts, fd), tokens (B, Tt), labels (B, Tt). The mean
    cross entropy over labelled positions (float32 logits)."""
    enc_out = encode(params, batch["frames"], cfg, dtype)
    h = decode_states(params, enc_out, batch["tokens"], cfg, dtype)
    logits = (h @ params["lm_head"].to(h.dtype)).to(torch.float32)
    labels = batch["labels"]
    per_tok = cross_entropy(logits, labels)
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)
