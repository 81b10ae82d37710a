"""Encoder-decoder transformer (port of ``repro/models/encdec.py``: the
seamless-m4t backbone), train and decode at any tp.

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
not values, and the port keeps the activations instead.

Tensor parallelism, as in the JAX package: :func:`param_shapes` and
:func:`init_encdec_params` take ``tp`` (the global tree padded for it, or
one rank's shard with ``n_shards=tp``), and the train path takes the
model axis (``models.common.Axes``): the embedding and ``lm_head``
vocab-sharded (``embed_lookup``, ``tp_cross_entropy``), every attention
on the rank's heads (the cross attention's K and V projected on its local
KV heads) with its out projection row-parallel, the GELU MLP column- and
row-parallel (``b_out`` added once, after the sum), and ``frontend_proj``
and every LayerNorm replicated. Unlike the hybrid and ssm families, this
family computes the same function at every tp from the same global
params (up to the padding of a vocabulary or head count that tp does not
divide).

Decode (:func:`init_encdec_cache`, :func:`encdec_prefill`,
:func:`encdec_decode_step`): the prefill runs the encoder and projects
every decoder layer's cross-attention K and V once; each step then runs
the decoder on one token per sequence, its causal self-attention through
``attention_decode`` (θ 10,000, no window; the cache written in place at
``pos``) and its cross attention over the whole encoder cache in float32,
unmasked, with ``torch.softmax`` (the JAX package's ``jax.nn.softmax``).
The cache is a flat dict of stacked leaves with a leading decoder-layer
axis: ``self/k``, ``self/v`` (L, B, S, Hkv, dh), ``self/kv_pos`` (L, B,
S) and ``cross/k``, ``cross/v`` (L, B, S_src, Hkv, dh), ``cross/pos`` (L,
B, S_src). The JAX package has no engine for this family; a greedy loop
over :func:`encdec_decode_step` drives it (``launch/step.py``'s
``build_serve_step`` on a grid). At tp > 1 the decode runs the rank's
heads as the train path does: the vocab-sharded lookup, the self- and
cross-attention caches of the rank's KV heads, both out projections and
the MLP row-parallel, and the rank's vocab slice of the logits. With
``axes.sp`` (a sequence-sharded decode) the self-attention cache's
sequence is sharded over the data group; the cross attention, as the JAX
package's, has no such branch: it attends every slot of the shard's own
cross cache, which :func:`encdec_prefill` fills whole on every shard.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.attention import (
    attention_decode, attention_train, f32_scale, gqa_attend, init_cache,
)
from repro_torch.models.common import (
    SINGLE, Axes, HeadLayout, dense_init, embed_lookup, layernorm, rope, tp_cross_entropy,
)
from repro_torch.models.mlp import gelu_mlp
from repro_torch.models.transformer import Dims, _attn_shapes, _sub, resolve_dims

Tree = Dict[str, torch.Tensor]


def _ln_shapes(name: str, d: int) -> Dict[str, tuple]:
    return {f"{name}/b": (d,), f"{name}/w": (d,)}


def _layer_shapes(cfg, attn_names, dims: Dims) -> Dict[str, tuple]:
    """One layer's leaves without the leading layer axis: a LayerNorm
    before each attention of ``attn_names`` (ln1, then ln_x) and before the
    GELU MLP (ln2); ``dims``' heads and d_ff columns."""
    d, f = cfg.d_model, dims.d_ff_loc
    shapes = {}
    for attn, ln in zip(attn_names, ("ln1", "ln_x")):
        shapes.update(_ln_shapes(ln, d))
        shapes.update({f"{attn}/{k}": s for k, s in _attn_shapes(cfg, dims.layout).items()})
    shapes.update(_ln_shapes("ln2", d))
    shapes.update({"mlp/b_in": (f,), "mlp/b_out": (d,), "mlp/w_in": (d, f),
                   "mlp/w_out": (f, d)})
    return shapes


def param_shapes(cfg, tp: int = 1, n_shards: int = 1) -> Dict[str, tuple]:
    """Leaf name -> shape of the encoder-decoder (37 leaves); the layer
    leaves carry the leading axis ``enc_layers`` or ``dec_layers``. With
    ``tp`` the shapes are padded for it: global with ``n_shards=1``, one
    rank's with ``n_shards=tp`` (the JAX package's ``init_encdec_params``
    shapes)."""
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not the encoder-decoder")
    d, dims = cfg.d_model, resolve_dims(cfg, tp, n_shards)
    shapes = {"frontend_proj": (cfg.frontend_dim, d), "embed": (dims.vocab_loc, d)}
    for stack, n, attn in (("enc_layers", cfg.enc_layers, ("attn",)),
                           ("dec_layers", cfg.dec_layers, ("self_attn", "cross_attn"))):
        shapes.update({f"{stack}/{k}": (n, *s)
                       for k, s in _layer_shapes(cfg, attn, dims).items()})
    shapes.update({**_ln_shapes("ln_enc", d), **_ln_shapes("ln_dec", d),
                   "lm_head": (d, dims.vocab_loc)})
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
                       dtype=torch.float32, tp: int = 1) -> Tree:
    """Random weights from ``generator`` (the JAX package's distributions:
    every matrix uniform ±1/√fan_in, fan_in its next-to-last axis, the
    embedding's d_model; the :func:`_constant` leaves filled), on
    ``device``, in ``dtype``. With ``tp`` the tree is the global one padded
    for it (the JAX package's ``n_shards=1``); each rank takes its slice
    (``models.common.TpShard``)."""
    params = {}
    for name, shape in param_shapes(cfg, tp).items():
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


def _layout(cfg, axes: Axes) -> HeadLayout:
    """The rank's heads over ``axes``' model group (all of them at tp = 1)."""
    return resolve_dims(cfg, axes.tp_size, axes.tp_size).layout


def _project_enc_kv(p, enc_out: torch.Tensor, cfg, axes: Axes = SINGLE):
    """Cross attention's K and V from the encoder states (B, Ts, Hkv, dh)
    on the rank's KV heads, no RoPE."""
    heads = _layout(cfg, axes)
    k = enc_out @ p["wk"].to(enc_out.dtype)
    v = enc_out @ p["wv"].to(enc_out.dtype)
    return (_heads(k, heads.kv_local, heads.head_dim),
            _heads(v, heads.kv_local, heads.head_dim))


def _cross_attention(p, x: torch.Tensor, enc_kv, cfg, axes: Axes = SINGLE) -> torch.Tensor:
    """x: (B, Tq, d) attends every encoder position (no mask, no RoPE);
    ``enc_kv``: (k, v), each (B, Ts, Hkv, dh). The out projection is
    row-parallel over ``axes``."""
    heads = _layout(cfg, axes)
    q = _heads(x @ p["wq"].to(x.dtype), heads.q_local, heads.head_dim)
    return axes.psum_tp(gqa_attend(q, *enc_kv, causal=False) @ p["wo"].to(x.dtype))


def _encoder_attention(p, z: torch.Tensor, positions: torch.Tensor, cfg,
                       axes: Axes = SINGLE) -> torch.Tensor:
    """Bidirectional self-attention on the rank's heads: RoPE (θ 10,000) on
    q and k, the out projection row-parallel over ``axes``."""
    heads = _layout(cfg, axes)
    hq, hkv, dh = heads.q_local, heads.kv_local, heads.head_dim
    q = rope(_heads(z @ p["wq"].to(z.dtype), hq, dh), positions)
    k = rope(_heads(z @ p["wk"].to(z.dtype), hkv, dh), positions)
    v = _heads(z @ p["wv"].to(z.dtype), hkv, dh)
    return axes.psum_tp(gqa_attend(q, k, v, causal=False) @ p["wo"].to(z.dtype))


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, t = x.shape[:2]
    return torch.arange(t, device=x.device).expand(b, t)


def encoder_layer(lp, x: torch.Tensor, positions: torch.Tensor, cfg,
                  axes: Axes = SINGLE) -> torch.Tensor:
    """One encoder layer: LayerNorm, bidirectional attention and the
    residual; LayerNorm, the GELU MLP and the residual."""
    x = x + _encoder_attention(_sub(lp, "attn/"), _ln(x, lp, "ln1"), positions, cfg, axes)
    return x + gelu_mlp(_sub(lp, "mlp/"), _ln(x, lp, "ln2"), axes)


def decoder_layer(lp, x: torch.Tensor, enc_out: torch.Tensor, positions: torch.Tensor,
                  cfg, axes: Axes = SINGLE) -> torch.Tensor:
    """One decoder layer: causal self-attention, cross attention to
    ``enc_out`` (K and V projected here) and the GELU MLP, each behind its
    LayerNorm and added to the residual."""
    heads = _layout(cfg, axes)
    kw = dict(n_heads=heads.q_local, n_kv_heads=heads.kv_local, head_dim=heads.head_dim,
              axes=axes)
    x = x + attention_train(_sub(lp, "self_attn/"), _ln(x, lp, "ln1"), positions, **kw)
    cross = _sub(lp, "cross_attn/")
    kv = _project_enc_kv(cross, enc_out, cfg, axes)
    x = x + _cross_attention(cross, _ln(x, lp, "ln_x"), kv, cfg, axes)
    return x + gelu_mlp(_sub(lp, "mlp/"), _ln(x, lp, "ln2"), axes)


def encode(params: Tree, frames: torch.Tensor, cfg, dtype=torch.bfloat16,
           axes: Axes = SINGLE) -> torch.Tensor:
    """frames: (B, Ts, frontend_dim) -> encoder states (B, Ts, d) in
    ``dtype``."""
    x = frames.to(dtype) @ params["frontend_proj"].to(dtype)
    positions = _positions(x)
    for lp in _layers(params, "enc_layers"):
        x = encoder_layer(lp, x, positions, cfg, axes)
    return _ln(x, params, "ln_enc")


def decode_states(params: Tree, enc_out: torch.Tensor, tokens: torch.Tensor, cfg,
                  dtype=torch.bfloat16, axes: Axes = SINGLE) -> torch.Tensor:
    """The decoder's hidden states after ``ln_dec``, (B, Tt, d), teacher
    forced on ``tokens`` over the encoder states ``enc_out``."""
    x = embed_lookup(params["embed"], tokens, axes).to(dtype)
    positions = _positions(x)
    for lp in _layers(params, "dec_layers"):
        x = decoder_layer(lp, x, enc_out, positions, cfg, axes)
    return _ln(x, params, "ln_dec")


def encdec_loss(params: Tree, batch, cfg, dtype=torch.bfloat16,
                axes: Axes = SINGLE) -> torch.Tensor:
    """batch: frames (B, Ts, fd), tokens (B, Tt), labels (B, Tt). The mean
    cross entropy over labelled positions (float32 logits; at tp > 1 the
    parallel cross entropy over the rank's vocab slice)."""
    enc_out = encode(params, batch["frames"], cfg, dtype, axes)
    h = decode_states(params, enc_out, batch["tokens"], cfg, dtype, axes)
    logits = (h @ params["lm_head"].to(h.dtype)).to(torch.float32)
    labels = batch["labels"]
    per_tok = tp_cross_entropy(logits, labels, axes)
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_encdec_cache(cfg, batch: int, seq: int, s_src: int, *, device,
                      dtype=torch.bfloat16, tp: int = 1, n_shards: int = 1) -> Tree:
    """An empty decode cache for every decoder layer (the module
    docstring's layout): the self-attention's KV cache of ``seq`` slots,
    every slot empty, and a zero cross-attention cache of ``s_src``
    encoder positions, both in ``dtype``. With ``tp`` the KV heads are
    padded for it: all of them with ``n_shards=1``, one rank's with
    ``n_shards=tp`` (the JAX package's ``init_encdec_cache(cfg, tp,
    n_shards, ...)``)."""
    heads = resolve_dims(cfg, tp, n_shards).layout
    hkv, dh = heads.kv_local, heads.head_dim
    base = {f"self/{k}": v for k, v in init_cache(batch, seq, n_kv_heads=hkv, head_dim=dh,
                                                  device=device, dtype=dtype).items()}
    base.update({f"cross/{k}": torch.zeros(batch, s_src, hkv, dh, dtype=dtype, device=device)
                 for k in ("k", "v")})
    base["cross/pos"] = torch.zeros(batch, s_src, dtype=torch.int32, device=device)
    return {k: v.expand(cfg.dec_layers, *v.shape).clone() for k, v in base.items()}


def encdec_prefill(params: Tree, frames: torch.Tensor, cache: Tree, cfg,
                   dtype=torch.bfloat16, axes: Axes = SINGLE) -> Tree:
    """Run the encoder on ``frames`` (B, Ts, frontend_dim) and fill the
    cross-attention cache: each decoder layer's K and V of the encoder
    states (the rank's KV heads over ``axes``), cast to ``dtype``, and
    their positions 0 ... Ts - 1. As in the JAX package the cross entries
    are replaced (their S_src becomes Ts); the self-attention cache is
    kept. Returns the cache."""
    enc_out = encode(params, frames, cfg, dtype, axes)
    b, ts = enc_out.shape[:2]
    ks, vs = [], []
    for lp in _layers(params, "dec_layers"):
        k, v = _project_enc_kv(_sub(lp, "cross_attn/"), enc_out, cfg, axes)
        ks.append(k.to(dtype))
        vs.append(v.to(dtype))
    pos = torch.arange(ts, dtype=torch.int32, device=enc_out.device).expand(b, ts)
    cache.update({"cross/k": torch.stack(ks), "cross/v": torch.stack(vs),
                  "cross/pos": pos.expand(len(ks), b, ts).clone()})
    return cache


def _cross_attention_decode(p, z: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            cfg, axes: Axes = SINGLE) -> torch.Tensor:
    """One query per sequence, z (B, 1, d), over every cached encoder
    position (k, v: (B, S_src, Hkv, dh), the rank's KV heads) in float32,
    no mask: the logits times 1/√dh (float32), ``torch.softmax``, then
    ``wo`` in z's type, row-parallel over ``axes``."""
    heads = _layout(cfg, axes)
    b, hq, hkv, dh = z.shape[0], heads.q_local, heads.kv_local, heads.head_dim
    q = (z @ p["wq"].to(z.dtype)).reshape(b, hkv, hq // hkv, dh)
    logits = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32), k.to(torch.float32))
    w = torch.softmax(logits * f32_scale(dh), dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v.to(torch.float32))
    return axes.psum_tp(o.reshape(b, 1, hq * dh).to(z.dtype) @ p["wo"].to(z.dtype))


def encdec_decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, pos: torch.Tensor,
                       cfg, dtype=torch.bfloat16, axes: Axes = SINGLE):
    """tokens: (B,) ids of this step; pos: (B,) their positions. Each
    decoder layer: causal self-attention against the cache (written at
    ``pos`` in place), cross attention to the prefilled encoder cache, the
    GELU MLP, each behind its LayerNorm. Returns ``(logits (B, V/tp)
    float32, cache)``: at tp > 1 (``axes``) the rank's vocab slice, from
    its shard of the params."""
    x = embed_lookup(params["embed"], tokens[:, None], axes).to(dtype)
    heads = _layout(cfg, axes)
    kw = dict(n_heads=heads.q_local, n_kv_heads=heads.kv_local, head_dim=heads.head_dim,
              axes=axes)
    selfc, cross = _sub(cache, "self/"), _sub(cache, "cross/")
    for i, lp in enumerate(_layers(params, "dec_layers")):
        a, _ = attention_decode(_sub(lp, "self_attn/"), _ln(x, lp, "ln1"), pos,
                                {k: v[i] for k, v in selfc.items()}, **kw)
        x = x + a
        x = x + _cross_attention_decode(_sub(lp, "cross_attn/"), _ln(x, lp, "ln_x"),
                                        cross["k"][i], cross["v"][i], cfg, axes)
        x = x + gelu_mlp(_sub(lp, "mlp/"), _ln(x, lp, "ln2"), axes)
    x = _ln(x, params, "ln_dec")
    return (x @ params["lm_head"].to(x.dtype)).to(torch.float32)[:, 0], cache
