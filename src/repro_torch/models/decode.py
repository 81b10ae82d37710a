"""Single-token decode (the serve path) of the decoder-only families, with
their caches (port of ``repro/models/decode.py``; at tp > 1 for the
attention families).

The cache is a flat dict of stacked leaves, as the params are, each with
the layer leaves' leading axes::

    dense / vlm / moe, GQA : {"layers/k", "layers/v": (L, B, S, Hkv, dh),
                              "layers/kv_pos": (L, B, S) int32}
    MLA (a ``kv_lora``)    : {"layers/c_kv": (L, B, S, kv_lora),
                              "layers/k_r": (L, B, S, 64), "layers/kv_pos"}
    hybrid (Mamba2)        : {"mamba/conv": (nb, per, B, K - 1, H·P) float32,
                              "mamba/h": (nb, per, B, H, N, P) float32,
                              "attn/k", "attn/v": (nb, B, S, Hkv, dh),
                              "attn/kv_pos": (nb, B, S)}
    ssm (xLSTM)            : {"blocks/m1/C", "blocks/m2/C": (nb, B, H, dh, dh),
                              "blocks/m1/n", "blocks/m2/n": (nb, B, H, dh),
                              "blocks/s/h", "blocks/s/c": (nb, B, H, dh)},
                             all float32

with nb = n_layers // attn_every blocks of per = attn_every Mamba2 layers
(one application of the shared attention block each) in the hybrid
family, and nb = n_layers // 3 (m, m, s) blocks in the ssm family. The
recurrent state is O(1) in the sequence: S does not appear in it.

:func:`lm_decode_step` runs one token per sequence through the layers in a
Python loop over the stacked leaves (the JAX package's ``lax.scan``) and
writes each layer's cache in place; the final norm and the logits follow
``lm_logits_local``: the product in the step's type, then float32. In the
hybrid family the shared block reads ``[h, emb0]``, emb0 the step's
embedding, and attends with the config's ``rope_theta`` and no window. The
JAX package's decode is plain XLA, so this is plain PyTorch
(``torch.matmul``, attention's explicit softmax, the recurrences' einsums);
no TPU kernel stands behind it.

The encoder-decoder family has no decoder-only cache: :func:`init_lm_cache`
raises ``ValueError`` for it, as the JAX package's does; its decode is
``models/encdec.py``'s.

Tensor parallelism (``axes``, the model group of a data × model grid):
every family decodes on the rank's shard of the params as the JAX
package's ``lm_decode_step`` does inside its ``shard_map``: the
vocab-sharded embedding lookup, the rank's local heads (a GQA cache of
``kv_local`` heads; MLA's latent cache whole on every rank; the Mamba2 and
xLSTM states of the rank's ``ssm_heads_loc`` or ``xl_heads_loc`` heads,
each cell's out projection row-parallel), the MoE block by
``pick_strategy`` (``moe_ep`` when tp divides the experts) and the rank's
vocab slice of the logits; :func:`tp_greedy` picks the token without
gathering them. With ``axes.sp`` the GQA cache's sequence is sharded over
the data group (``attention_decode``), the hybrid's shared-block cache
too; its recurrent states, which have no sequence, are whole on every
sequence shard. At tp > 1 the hybrid and ssm families compute another
function of the same global params than at tp = 1, as the JAX package's
do (ROADMAP's reference behaviours).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.attention import attention_decode, init_cache
from repro_torch.models.common import SINGLE, Axes, embed_lookup, rmsnorm
from repro_torch.models.mla import init_mla_cache, mla_decode
from repro_torch.models.mlp import swiglu_mlp
from repro_torch.models.moe import moe_block
from repro_torch.models.ssm import init_mamba2_cache, mamba2_decode
from repro_torch.models.transformer import (
    XLSTM_CELLS, _check_ported, _layer_axes, _sub, lm_logits, params_from_jax, resolve_dims,
)
from repro_torch.models.xlstm import (
    init_mlstm_cache, init_slstm_cache, mlstm_decode, slstm_decode,
)

Tree = Dict[str, torch.Tensor]


def _check_decode(cfg) -> None:
    """Refuse the encoder-decoder (no decoder-only cache, as in the JAX
    package) and any config the decoder-only LM does not run."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: family 'encdec' has no decoder-only cache (the JAX package's "
            "init_lm_cache raises ValueError too); its decode is models/encdec.py's "
            "init_encdec_cache, encdec_prefill and encdec_decode_step")
    _check_ported(cfg)


def _stacked(base: Tree, lead: tuple, prefix: str) -> Tree:
    return {f"{prefix}{k}": v.expand(*lead, *v.shape).clone() for k, v in base.items()}


def init_lm_cache(cfg, batch: int, seq: int, *, device, dtype=torch.bfloat16, tp: int = 1,
                  n_shards: int = 1) -> Tree:
    """An empty cache of ``batch`` sequences of up to ``seq`` tokens for
    every layer (the module docstring's layout): MLA's latent cache where
    the config has a ``kv_lora``, else the GQA KV cache (in ``dtype``); the
    hybrid family's Mamba2 states and the shared block's KV cache; the ssm
    family's mLSTM and sLSTM states. The JAX package's ``init_lm_cache(cfg,
    tp, n_shards, b_local, s_local)``: with ``n_shards=tp`` the cache holds
    one rank's heads of the heads padded for ``tp`` (the GQA cache's
    ``kv_local``, the Mamba2 or xLSTM states' local heads; ``batch`` and
    ``seq`` the rank's rows and slots)."""
    _check_decode(cfg)
    lead = _layer_axes(cfg)
    dims = resolve_dims(cfg, tp, n_shards)
    layout = dims.layout
    kv = dict(n_kv_heads=layout.kv_local, head_dim=layout.head_dim, device=device, dtype=dtype)
    if cfg.family == "hybrid":
        m = init_mamba2_cache(batch, n_heads=dims.ssm_heads_loc, head_dim=dims.ssm_head_dim,
                              d_state=cfg.ssm_state, device=device)
        return {**_stacked(m, lead, "mamba/"),
                **_stacked(init_cache(batch, seq, **kv), lead[:1], "attn/")}
    if cfg.family == "ssm":
        heads = dict(n_heads=dims.xl_heads_loc, head_dim=dims.xl_head_dim, device=device)
        cache = {}
        for cell in XLSTM_CELLS:
            init = init_slstm_cache if cell == "s" else init_mlstm_cache
            cache.update(_stacked(init(batch, **heads), lead, f"blocks/{cell}/"))
        return cache
    if cfg.kv_lora:
        base = init_mla_cache(batch, seq, kv_lora=cfg.kv_lora, device=device, dtype=dtype)
    else:
        base = init_cache(batch, seq, **kv)
    return _stacked(base, lead, "layers/")


def cache_from_jax(tree_of_numpy, device) -> Tree:
    """JAX ``init_lm_cache`` / ``lm_decode_step`` cache pulled to the host
    (tp = 1, nested dict of numpy arrays, stacked layer axis kept) -> the
    port's flat cache on ``device``; bf16 entries stay bf16 (exactly)."""
    return params_from_jax(tree_of_numpy, device)


def _attn_decode_any(lp, h, pos, lc, cfg, axes: Axes = SINGLE):
    layout = resolve_dims(cfg, axes.tp_size, axes.tp_size).layout
    if cfg.kv_lora:
        return mla_decode(lp, h, pos, lc, n_heads=layout.q_local, head_dim=layout.head_dim,
                          axes=axes)
    return attention_decode(lp, h, pos, lc, n_heads=layout.q_local,
                            n_kv_heads=layout.kv_local, head_dim=layout.head_dim,
                            rope_theta=cfg.rope_theta, window=cfg.window, axes=axes)


def _index(tree: Tree, *idx) -> Tree:
    return {k: v[idx] for k, v in tree.items()}


def _hybrid_layers(params, cache, x, pos, cfg, axes: Axes):
    """The Mamba2 layers, each block followed by the shared block on
    ``[h, emb0]``; on the rank's heads (Mamba2's and the shared
    attention's) and d_ff columns."""
    layers, emb0 = _sub(params, "layers/"), x
    mamba, attn = _sub(cache, "mamba/"), _sub(cache, "attn/")
    sp = _sub(params, "shared_attn/")
    nb, per = _layer_axes(cfg)
    dims = resolve_dims(cfg, axes.tp_size, axes.tp_size)
    heads = dims.layout
    kw = dict(n_heads=dims.ssm_heads_loc, head_dim=dims.ssm_head_dim, d_state=cfg.ssm_state,
              axes=axes)
    for i in range(nb):
        for j in range(per):
            lp = _index(layers, i, j)
            out, _ = mamba2_decode(_sub(lp, "m/"), rmsnorm(x, lp["ln"]), _index(mamba, i, j),
                                   **kw)
            x = x + out
        z = rmsnorm(torch.cat([x, emb0], dim=-1), sp["ln"])
        z = z @ sp["w_in"].to(z.dtype)
        a, _ = attention_decode(_sub(sp, "attn/"), z, pos, _index(attn, i),
                                n_heads=heads.q_local, n_kv_heads=heads.kv_local,
                                head_dim=heads.head_dim, rope_theta=cfg.rope_theta, axes=axes)
        z = z + a
        z = z + swiglu_mlp(_sub(sp, "mlp/"), rmsnorm(z, sp["ln2"]), axes)
        x = x + z
    return x


def _ssm_layers(params, cache, x, cfg, axes: Axes):
    """The (mLSTM, mLSTM, sLSTM) blocks, each cell behind its RMSNorm and
    added to the residual, on the rank's heads."""
    layers, blocks = _sub(params, "layers/"), _sub(cache, "blocks/")
    dims = resolve_dims(cfg, axes.tp_size, axes.tp_size)
    kw = dict(n_heads=dims.xl_heads_loc, head_dim=dims.xl_head_dim, axes=axes)
    for i in range(_layer_axes(cfg)[0]):
        bp, bc = _index(layers, i), _index(blocks, i)
        for cell, step in zip(XLSTM_CELLS, (mlstm_decode, mlstm_decode, slstm_decode)):
            lp = _sub(bp, f"{cell}/")
            out, _ = step(_sub(lp, "cell/"), rmsnorm(x, lp["ln"]), _sub(bc, f"{cell}/"), **kw)
            x = x + out
    return x


def _attn_layers(params, cache, x, pos, cfg, axes: Axes):
    """The attention families' layers: attention (GQA or MLA), then the
    SwiGLU or the MoE block."""
    layers, caches = _sub(params, "layers/"), _sub(cache, "layers/")
    for i in range(cfg.n_layers):
        lp = _index(layers, i)
        a, _ = _attn_decode_any(_sub(lp, "attn/"), rmsnorm(x, lp["ln1"]), pos,
                                _index(caches, i), cfg, axes)
        x = x + a
        z = rmsnorm(x, lp["ln2"])
        if cfg.family == "moe":
            x = x + moe_block(_sub(lp, "moe/"), z, n_experts=cfg.n_experts, top_k=cfg.top_k,
                              axes=axes)
        else:
            x = x + swiglu_mlp(_sub(lp, "mlp/"), z, axes)
    return x


def lm_decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, pos: torch.Tensor, cfg,
                   dtype=torch.bfloat16, axes: Axes = SINGLE):
    """tokens: (B,) ids of this step; pos: (B,) their positions. Writes
    each layer's cache (at ``pos``, or the recurrent state) in place.
    Returns ``(logits (B, V/tp) float32, cache)``: at tp > 1 (``axes``)
    the rank's vocab slice, from its shard of the params."""
    _check_decode(cfg)
    x = embed_lookup(params["embed"], tokens[:, None], axes).to(dtype)
    if cfg.family == "hybrid":
        x = _hybrid_layers(params, cache, x, pos, cfg, axes)
    elif cfg.family == "ssm":
        x = _ssm_layers(params, cache, x, cfg, axes)
    else:
        x = _attn_layers(params, cache, x, pos, cfg, axes)
    h = rmsnorm(x, params["ln_f"])
    return lm_logits(params, h, cfg)[:, 0], cache


def tp_greedy(logits: torch.Tensor, axes: Axes = SINGLE) -> torch.Tensor:
    """The greedy token per row from vocab-sharded ``logits`` (B, V/tp),
    without gathering them (the JAX package's ``tp_greedy``): each rank's
    argmax (ties to the first index), its global id, and the max over the
    model group; every rank whose best equals that max contributes its id,
    the others 0, and the ids are summed. So on a tie across vocab shards
    the token is the sum of the tied ids (ROADMAP's reference behaviours);
    at tp = 1 it is the argmax."""
    v_local = logits.shape[-1]
    best = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, best[:, None])[:, 0]
    gid = best + axes.tp_index * v_local
    winner = torch.where(val >= axes.pmax_tp(val), gid, torch.zeros_like(gid))
    return axes.psum_tp(winner)
