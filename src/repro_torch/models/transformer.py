"""Decoder-only LM, dense, MoE, hybrid and xLSTM families (port of
``repro/models/transformer.py``), and tensor parallelism (TP) over a model
axis for every family.

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
package does. The dense family's options run as there: QKV biases
(``layers/attn/b{q,k,v}``, initialised to zeros), a sliding window, any
head_dim and ``rope_theta``, and the ``vit`` modality frontend stub of the
``vlm`` family: precomputed ``patch_embeds`` projected by ``frontend_proj``
and put before the text tokens, the loss on the text positions only. The
``moe`` family's layers run attention (GQA, or MLA where the config has a
``kv_lora``) and then the MoE block (``models/moe.py``), each behind an
RMSNorm. Its router is float32 whatever the params' type, as in the JAX
package (``FLOAT32_LEAVES``), and each layer's three expert matrices start
from one draw, as the JAX package draws them from one key
(:func:`init_lm_params`). The ``hybrid`` family (zamba2) stacks Mamba2
layers (``models/ssm.py``) with two leading axes, ``(n_layers //
attn_every, attn_every, ...)``, and after every ``attn_every`` of them
applies one shared attention block to concat[h, embedding]: its
``shared_attn/*`` leaves exist once, so autograd sums their gradients over
the blocks. The ``ssm`` family (xlstm) stacks (mLSTM, mLSTM, sLSTM) blocks
(``models/xlstm.py``) with one leading axis, ``(n_layers // 3, ...)``,
each cell behind its RMSNorm (``m1``, ``m2``, ``s``). With
``tie_embeddings`` (any family) there is no ``lm_head`` leaf: the head is
``embed``'s transpose, and autograd sums ``embed``'s gradient over the
lookup and the head.

Tensor parallelism follows the JAX package: :func:`resolve_dims` gives
each leaf's padded global (``n_shards=1``) or local (``n_shards=tp``)
dims, :func:`param_shapes` the shapes, and ``launch/specs.py`` diffs the
two to find each leaf's sharded dimension. :func:`init_lm_params` with
``tp`` draws the global padded tree the JAX package draws
(``init_lm_params(key, cfg, tp, n_shards=1)``), and each rank takes its
slice (``models.common.TpShard``). :func:`lm_forward` and :func:`lm_loss`
take the model axis (``models.common.Axes``), every family: the Mamba2
and xLSTM heads are sharded like attention heads (``Dims.ssm_heads_loc``,
``Dims.xl_heads_loc``), each cell's out projection row-parallel, Mamba2's
``w_bc`` replicated, and the hybrid's shared block runs the dense
family's column- and row-parallel attention and SwiGLU behind its
replicated ``ln`` and ``w_in``. Two reference behaviours follow from the
JAX package's contiguous split of each global leaf, and the port keeps
both (ROADMAP's reference behaviours): a packed leaf is split down the
middle, so at tp = 2 rank 0 holds all of Mamba2's ``x`` columns of
``w_xz`` and rank 1 all of its ``z`` columns (the mLSTM's ``w_if`` and
``if_bias``: rank 0 the input gates, rank 1 the forget gates), and each
rank splits its own columns in half again; and the gated RMSNorms
(Mamba2's, the mLSTM's and the sLSTM's ``norm_w``) take the mean over the
rank's own ``d_inner/tp`` or ``H_loc·dh``. So at tp > 1 the hybrid and
ssm families compute another function of the same global params than at
tp = 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.compressor import PowerSGD
from repro_torch.core.scaling import AlphaState
from repro_torch.models.attention import attention_train
from repro_torch.models.common import (
    SINGLE, Axes, HeadLayout, TpShard, dense_init, embed_lookup, pad_to_multiple, plan_heads,
    rmsnorm, tp_cross_entropy,
)
from repro_torch.models.mla import DH_ROPE, mla_train
from repro_torch.models.mlp import swiglu_mlp
from repro_torch.models.moe import moe_block, pick_strategy
from repro_torch.models.ssm import CONV_K, mamba2_train
from repro_torch.models.xlstm import mlstm_train, slstm_train

Tree = Dict[str, torch.Tensor]

# leaves kept in float32 whatever the params' type (the JAX package's
# ``_init_moe_layer`` makes the router float32)
FLOAT32_LEAVES = ("layers/moe/router",)
# constant initialisers by a leaf's last name: the norms' ones, and the
# Mamba2 layers' (the JAX package's ``init_mamba2_params``)
CONSTANT_INIT = {"ln": 1.0, "ln1": 1.0, "ln2": 1.0, "ln_f": 1.0, "norm_w": 1.0,
                 "d_skip": 1.0, "a_log": 0.0, "dt_bias": -4.0}
# leaves that start at zeros: the QKV biases and the sLSTM's gate bias
ZERO_INIT = ("attn/bk", "attn/bq", "attn/bv", "layers/s/cell/b")
SSM_HEAD_DIM = 64  # the JAX package's ``Dims.ssm_head_dim``
XLSTM_CELLS = ("m1", "m2", "s")  # one xLSTM block: (mLSTM, mLSTM, sLSTM)


@dataclasses.dataclass(frozen=True)
class Dims:
    """Every leaf dimension that depends on (tp, n_shards): padded global
    counts with ``n_shards=1``, one rank's with ``n_shards=tp``."""

    layout: HeadLayout
    d_ff_loc: int
    vocab_loc: int
    # moe
    e_loc: int = 0
    ff_e_loc: int = 0
    ff_shared_loc: int = 0
    # the hybrid family's Mamba2 heads, the ssm family's xLSTM heads
    ssm_heads_loc: int = 0
    ssm_head_dim: int = SSM_HEAD_DIM
    xl_heads_loc: int = 0
    xl_head_dim: int = 0


def resolve_dims(cfg, tp: int = 1, n_shards: int = 1) -> Dims:
    """The JAX package's ``resolve_dims``: attention heads by
    :func:`~repro_torch.models.common.plan_heads`, d_ff and the vocabulary
    padded to a multiple of tp, the experts split by ``pick_strategy``
    ("ep": E/tp experts of full d_ff; "tp": all E, d_ff padded and split),
    the shared experts' d_ff padded and split, the Mamba2 heads (of
    ``SSM_HEAD_DIM``) and the xLSTM heads padded to a multiple of tp."""
    head_dim = _head_dim(cfg)
    g = plan_heads(cfg.n_heads, cfg.n_kv_heads, head_dim, tp)
    layout = HeadLayout(g.n_q, g.n_kv, head_dim, g.n_q // n_shards, g.n_kv // n_shards)
    kw = {}
    if cfg.n_experts:
        if pick_strategy(cfg.n_experts, tp) == "ep":
            kw.update(e_loc=cfg.n_experts // n_shards, ff_e_loc=cfg.d_ff)
        else:
            kw.update(e_loc=cfg.n_experts, ff_e_loc=pad_to_multiple(cfg.d_ff, tp) // n_shards)
        if cfg.n_shared_experts:
            ff_sh = pad_to_multiple(cfg.d_ff * cfg.n_shared_experts, tp)
            kw["ff_shared_loc"] = ff_sh // n_shards
    if cfg.ssm_state:
        kw["ssm_heads_loc"] = pad_to_multiple(_ssm_heads(cfg), tp) // n_shards
    if cfg.family == "ssm":
        kw.update(xl_heads_loc=pad_to_multiple(cfg.n_heads, tp) // n_shards, xl_head_dim=head_dim)
    return Dims(
        layout=layout,
        d_ff_loc=pad_to_multiple(max(cfg.d_ff, tp), tp) // n_shards,
        vocab_loc=pad_to_multiple(cfg.vocab, tp) // n_shards,
        **kw,
    )


def _check_ported(cfg) -> None:
    encdec = [what for what, on in ((f"family {cfg.family!r}", cfg.family == "encdec"),
                                    (f"the {cfg.frontend!r} frontend", cfg.frontend == "audio"))
              if on]
    if encdec:  # the JAX package's init_lm_params raises for them too
        raise ValueError(
            f"{cfg.name}: {' and '.join(encdec)} is the encoder-decoder's, not the "
            "decoder-only LM's: its params and loss are models/encdec.py's "
            "(param_shapes, init_encdec_params, encdec_loss)")
    missing = [
        what for what, on in (
            (f"family {cfg.family!r}",
             cfg.family not in ("dense", "vlm", "moe", "hybrid", "ssm")),
            (f"the {cfg.frontend!r} frontend", cfg.frontend not in (None, "vit")),
        ) if on
    ]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port's "
            "decoder-only LM runs the dense family, its vlm frontend stub, the moe "
            "family, the hybrid family and the ssm (xLSTM) family; models/encdec.py "
            "the encdec family)"
        )


def _head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.n_heads


def _attn_shapes(cfg, layout: Optional[HeadLayout] = None) -> Dict[str, tuple]:
    """The attention's weight matrices of one layer (``layout``'s local
    heads; the unpadded heads without one): MLA's with a ``kv_lora``, else
    GQA's."""
    d, hd = cfg.d_model, _head_dim(cfg)
    nq, nkv = (cfg.n_heads, cfg.n_kv_heads) if layout is None else (layout.q_local,
                                                                  layout.kv_local)
    q = nq * hd
    if cfg.kv_lora:
        return {"w_dkv": (d, cfg.kv_lora), "w_kr": (d, DH_ROPE),
                "w_q": (d, nq * (hd + DH_ROPE)), "w_uk": (cfg.kv_lora, q),
                "w_uv": (cfg.kv_lora, q), "wo": (q, d)}
    kv = nkv * hd
    return {"wk": (d, kv), "wo": (q, d), "wq": (d, q), "wv": (d, kv)}


def _ffn_shapes(cfg, dims: Dims) -> Dict[str, tuple]:
    """The feed-forward leaves of one layer: the dense SwiGLU's, or the
    MoE block's (router, experts and shared experts)."""
    d = cfg.d_model
    if cfg.family != "moe":
        f = dims.d_ff_loc
        return {"mlp/w_down": (f, d), "mlp/w_gate": (d, f), "mlp/w_up": (d, f)}
    e, f = dims.e_loc, dims.ff_e_loc
    shapes = {"moe/router": (d, cfg.n_experts), "moe/w_down": (e, f, d),
              "moe/w_gate": (e, d, f), "moe/w_up": (e, d, f)}
    if cfg.n_shared_experts:
        fs = dims.ff_shared_loc
        shapes.update({"moe/shared/w_down": (fs, d), "moe/shared/w_gate": (d, fs),
                       "moe/shared/w_up": (d, fs)})
    return shapes


def _ssm_heads(cfg) -> int:
    """Mamba2 heads of ``SSM_HEAD_DIM`` (d_inner = 2·d_model)."""
    return 2 * cfg.d_model // SSM_HEAD_DIM


def _layer_axes(cfg) -> tuple:
    """The leading axes of the layer leaves: (n_layers,), in the hybrid
    family (n_layers // attn_every, attn_every), in the ssm family
    (n_layers // 3,)."""
    if cfg.family == "ssm":
        if cfg.n_layers <= 0 or cfg.n_layers % len(XLSTM_CELLS):
            raise ValueError(
                f"{cfg.name}: n_layers {cfg.n_layers} is not a positive multiple of 3 "
                "(the xLSTM layers stack in (m, m, s) blocks of 3: two mLSTM layers "
                "and one sLSTM layer)")
        return (cfg.n_layers // len(XLSTM_CELLS),)
    if cfg.family != "hybrid":
        return (cfg.n_layers,)
    if cfg.n_layers <= 0 or cfg.n_layers % cfg.attn_every:
        raise ValueError(
            f"{cfg.name}: n_layers {cfg.n_layers} is not a positive multiple of "
            f"attn_every {cfg.attn_every} (the Mamba2 layers stack in blocks of "
            "attn_every, each followed by the shared attention block)")
    return (cfg.n_layers // cfg.attn_every, cfg.attn_every)


def _layer_shapes(cfg, dims: Dims) -> Dict[str, tuple]:
    """One layer's leaves, without the leading layer axes: a Mamba2 layer
    in the hybrid family, an (m, m, s) block in the ssm family, else
    attention and the feed-forward."""
    d = cfg.d_model
    if cfg.family == "ssm":
        h, dh = dims.xl_heads_loc, dims.xl_head_dim
        dk = h * dh
        mlstm = {"if_bias": (2 * h,), "norm_w": (dk,), "w_if": (d, 2 * h), "w_k": (d, dk),
                 "w_out": (dk, d), "w_q": (d, dk), "w_v": (d, dk)}
        slstm = {"b": (4 * dk,), "norm_w": (dk,), "r_h": (h, dh, 4 * dh), "w_in": (d, 4 * dk),
                 "w_out": (dk, d)}
        shapes = {}
        for cell, leaves in (("m1", mlstm), ("m2", mlstm), ("s", slstm)):
            shapes[f"{cell}/ln"] = (d,)
            shapes.update({f"{cell}/cell/{k}": s for k, s in leaves.items()})
        return shapes
    if cfg.family == "hybrid":
        n, h = cfg.ssm_state, dims.ssm_heads_loc
        di = h * dims.ssm_head_dim
        return {"ln": (d,), "m/a_log": (h,), "m/conv_w": (CONV_K, di), "m/d_skip": (h,),
                "m/dt_bias": (h,), "m/norm_w": (di,), "m/w_bc": (d, 2 * n), "m/w_dt": (d, h),
                "m/w_out": (di, d), "m/w_xz": (d, 2 * di)}
    layer = {f"attn/{k}": s for k, s in _attn_shapes(cfg, dims.layout).items()}
    layer.update({"ln1": (d,), "ln2": (d,), **_ffn_shapes(cfg, dims)})
    return layer


def param_shapes(cfg, tp: int = 1, n_shards: int = 1) -> Dict[str, tuple]:
    """Leaf name -> shape; layer leaves carry the leading layer axes. The
    dict's order is the order in which :func:`init_lm_params` draws. With
    ``tp`` the shapes are padded for it: global with ``n_shards=1``, one
    rank's with ``n_shards=tp`` (the JAX package's ``param_shapes``)."""
    _check_ported(cfg)
    dims = resolve_dims(cfg, tp, n_shards)
    L, d = cfg.n_layers, cfg.d_model
    lead = _layer_axes(cfg)
    shapes = {"embed": (dims.vocab_loc, d)}
    shapes.update({f"layers/{k}": (*lead, *s) for k, s in _layer_shapes(cfg, dims).items()})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, dims.vocab_loc)
    shapes["ln_f"] = (d,)
    if cfg.family == "hybrid":  # the shared attention block, once
        shared = {f"attn/{k}": s for k, s in _attn_shapes(cfg, dims.layout).items()}
        shared.update({"ln": (2 * d,), "ln2": (d,), "w_in": (2 * d, d),
                       **_ffn_shapes(cfg, dims)})
        shapes.update({f"shared_attn/{k}": s for k, s in shared.items()})
    if cfg.qkv_bias:
        hd = _head_dim(cfg)
        q, kv = dims.layout.q_local * hd, dims.layout.kv_local * hd
        shapes.update({"layers/attn/bk": (L, kv), "layers/attn/bq": (L, q),
                       "layers/attn/bv": (L, kv)})
    if cfg.frontend == "vit":
        shapes["frontend_proj"] = (cfg.frontend_dim, d)
    return shapes


def init_lm_params(cfg, *, generator: torch.Generator, device,
                   dtype=torch.float32, tp: int = 1) -> Tree:
    """Random weights from ``generator`` (the JAX package's distributions:
    uniform ±1/√fan_in for matrices, fan_in their next-to-last axis; the
    ``CONSTANT_INIT`` leaves filled; zeros for the ``ZERO_INIT`` leaves;
    each mLSTM's ``if_bias`` -2 for the input gates and 3 for the forget
    gates of its heads), on
    ``device``, in ``dtype`` but the ``FLOAT32_LEAVES``. The
    JAX package draws an MoE layer's three expert matrices from one key,
    so its ``w_up`` equals its ``w_gate`` and its ``w_down`` holds the same
    uniforms at the bound 1/√d_ff: here too (``w_down`` is ``w_gate``'s
    values in its shape, times √(d_model/d_ff)). With ``tp`` the tree is
    the global one padded for it (the JAX package's ``n_shards=1``), the
    fan-ins the padded counts; each rank takes its slice."""
    shapes = param_shapes(cfg, tp)
    params = {}
    for name, shape in shapes.items():
        dt = torch.float32 if name in FLOAT32_LEAVES else dtype
        if name in ("layers/moe/w_up", "layers/moe/w_down"):
            continue  # from w_gate, below
        const = CONSTANT_INIT.get(name.rsplit("/", 1)[-1])
        if const is not None:
            params[name] = torch.full(shape, const, dtype=dt, device=device)
        elif name.endswith(ZERO_INIT):  # zeros, not fan-in L
            params[name] = torch.zeros(shape, dtype=dt, device=device)
        elif name.endswith("cell/if_bias"):  # [-2]·H ++ [3]·H per block
            params[name] = torch.full(shape, -2.0, dtype=dt, device=device)
            params[name][..., shape[-1] // 2:] = 3.0
        else:
            fan_in = cfg.d_model if name == "embed" else shape[-2]
            params[name] = dense_init(
                shape, fan_in, generator=generator, device=device, dtype=dt
            )
    if "layers/moe/w_gate" in params:
        gate = params["layers/moe/w_gate"]
        params["layers/moe/w_up"] = gate.clone()
        down = torch.empty(shapes["layers/moe/w_down"], dtype=dtype, device=device)
        d_ff = down.shape[-2]  # padded for tp
        for i in range(down.shape[0]):  # a layer at a time: float32 copies of one layer
            down[i] = (gate[i].to(torch.float32).reshape(down.shape[1:])
                       * math.sqrt(cfg.d_model / d_ff)).to(dtype)
        params["layers/moe/w_down"] = down
    return params


def _sub(lp, prefix: str):
    """The leaves of ``lp`` under ``prefix``, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in lp.items() if k.startswith(prefix)}


def _layer(lp, x, positions, cfg, dims: Dims, axes: Axes):
    """One decoder layer (the JAX package's ``_dense_layer`` or
    ``_moe_layer``): attention, then the SwiGLU or the MoE block, on the
    rank's local heads and columns."""
    attn, xn = _sub(lp, "attn/"), rmsnorm(x, lp["ln1"])
    heads = dims.layout
    if cfg.kv_lora:
        h = x + mla_train(attn, xn, positions, n_heads=heads.q_local, head_dim=heads.head_dim,
                          axes=axes)
    else:
        h = x + attention_train(
            attn, xn, positions,
            n_heads=heads.q_local, n_kv_heads=heads.kv_local, head_dim=heads.head_dim,
            rope_theta=cfg.rope_theta, window=cfg.window, axes=axes,
        )
    if cfg.family == "moe":
        return h + moe_block(_sub(lp, "moe/"), rmsnorm(h, lp["ln2"]),
                             n_experts=cfg.n_experts, top_k=cfg.top_k, axes=axes)
    return h + swiglu_mlp(_sub(lp, "mlp/"), rmsnorm(h, lp["ln2"]), axes)


def _mamba_layer(lp, x, dims: Dims, cfg, axes: Axes):
    """One Mamba2 layer of the hybrid family, behind its RMSNorm, on the
    rank's local heads."""
    return x + mamba2_train(_sub(lp, "m/"), rmsnorm(x, lp["ln"]), n_heads=dims.ssm_heads_loc,
                            head_dim=dims.ssm_head_dim, d_state=cfg.ssm_state, axes=axes)


def _xlstm_block(bp, x, dims: Dims, axes: Axes):
    """One (mLSTM, mLSTM, sLSTM) block of the ssm family, each cell behind
    its RMSNorm and added to the residual, on the rank's local heads."""
    kw = dict(n_heads=dims.xl_heads_loc, head_dim=dims.xl_head_dim, axes=axes)
    for name, cell in zip(XLSTM_CELLS, (mlstm_train, mlstm_train, slstm_train)):
        lp = _sub(bp, f"{name}/")
        x = x + cell(_sub(lp, "cell/"), rmsnorm(x, lp["ln"]), **kw)
    return x


def _shared_attn_block(p, h, emb, positions, cfg, dims: Dims, axes: Axes):
    """The hybrid family's shared block: RMSNorm of concat[h, emb] over
    2·d_model, ``w_in`` back to d_model (both replicated), attention (no
    window) and the SwiGLU on the rank's heads and columns, each residual;
    added to h."""
    z = rmsnorm(torch.cat([h, emb], dim=-1), p["ln"])
    z = z @ p["w_in"].to(z.dtype)
    heads = dims.layout
    z = z + attention_train(
        _sub(p, "attn/"), z, positions, n_heads=heads.q_local, n_kv_heads=heads.kv_local,
        head_dim=heads.head_dim, rope_theta=cfg.rope_theta, axes=axes,
    )
    z = z + swiglu_mlp(_sub(p, "mlp/"), rmsnorm(z, p["ln2"]), axes)
    return h + z


def _embed_inputs(params: Tree, batch, cfg, axes: Axes = SINGLE) -> torch.Tensor:
    """Token embeddings (B, T, d) in the params' type (the vocab-sharded
    lookup at tp > 1); with the vit frontend the projected patch
    embeddings come first (B, N + T, d), projected in the embedding's type
    as the JAX package does (``frontend_proj`` replicated)."""
    x = embed_lookup(params["embed"], batch["tokens"], axes)
    if cfg.frontend == "vit":
        pe = batch["patch_embeds"].to(x.dtype) @ params["frontend_proj"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def lm_forward(params: Tree, batch, cfg, dtype=torch.bfloat16,
               axes: Axes = SINGLE) -> torch.Tensor:
    """Hidden states after the final norm: (B, T', d), T' counting the
    frontend's positions. In the hybrid family the shared attention block
    follows every ``attn_every`` Mamba2 layers, reading the embedded input
    in the activation type beside h; in the ssm family each step of the
    loop is an (m, m, s) block. ``params`` is the rank's shard of the
    model axis ``axes`` (the whole model at tp = 1)."""
    _check_ported(cfg)
    dims = resolve_dims(cfg, axes.tp_size, axes.tp_size)
    x = _embed_inputs(params, batch, cfg, axes).to(dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device).expand(b, t)
    lead = _layer_axes(cfg)
    layers = {k: v.flatten(0, len(lead) - 1).unbind(0)
              for k, v in _sub(params, "layers/").items()}
    emb0, shared = x, _sub(params, "shared_attn/")
    for i in range(math.prod(lead)):
        lp = {k: v[i] for k, v in layers.items()}
        if cfg.family == "ssm":
            x = _xlstm_block(lp, x, dims, axes)
        elif cfg.family == "hybrid":
            x = _mamba_layer(lp, x, dims, cfg, axes)
            if (i + 1) % cfg.attn_every == 0:
                x = _shared_attn_block(shared, x, emb0, positions, cfg, dims, axes)
        else:
            x = _layer(lp, x, positions, cfg, dims, axes)
    return rmsnorm(x, params["ln_f"])


def lm_logits(params: Tree, h: torch.Tensor, cfg) -> torch.Tensor:
    """The JAX package's ``lm_logits_local``: h @ head in h's type, then
    float32 (the rank's vocab slice at tp > 1); the head is ``embed``'s
    transpose when tied."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ head.to(h.dtype)).to(torch.float32)


def lm_loss(params: Tree, batch, cfg, dtype=torch.bfloat16,
            axes: Axes = SINGLE) -> torch.Tensor:
    """Mean next-token cross entropy over labelled positions (float32); with
    the vit frontend only the text positions carry labels. With tied
    embeddings the head is ``embed``'s transpose. At tp > 1 the parallel
    cross entropy over the rank's vocab slice (a padded vocabulary's extra
    logits enter its exp-sum, as in the JAX package)."""
    h = lm_forward(params, batch, cfg, dtype, axes)
    if cfg.frontend == "vit":
        h = h[:, -batch["tokens"].shape[1]:]
    logits = lm_logits(params, h, cfg)
    labels = batch["labels"]
    per_tok = tp_cross_entropy(logits, labels, axes)
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def params_from_jax(tree_of_numpy, device, prefix: str = "",
                    shard: Optional[TpShard] = None, lead: int = 0) -> Tree:
    """JAX ``init_lm_params`` output pulled to the host (nested dict of
    numpy arrays, stacked layer axis kept; the global tree, ``n_shards=1``)
    -> the port's leaf dict on ``device``, names joined with "/". With
    ``shard`` each leaf is that rank's slice over the model axis, its
    sharded dimension counted after ``lead`` leading axes."""
    out = {}
    for k, v in tree_of_numpy.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(params_from_jax(v, device, name + "/", shard, lead))
        else:
            t = _tensor(v, device)
            out[name] = t if shard is None else shard.take(name, t, lead)
    return out


def _tensor(v, device) -> torch.Tensor:
    a = np.array(v)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: through float32, exact
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def opt_state_from_jax(state_of_numpy, device, shard: Optional[TpShard] = None
                       ) -> Dict[str, object]:
    """JAX fused-route optimizer state (``{"mom": tree}`` for SGD,
    ``{"mu": tree, "nu": tree, "count": int32 scalar}`` for AdamW) -> the
    port's: a leaf dict per tree (with ``shard``, the rank's slices), a
    tensor per scalar."""
    return {
        name: params_from_jax(t, device, shard=shard) if isinstance(t, dict)
        else torch.from_numpy(np.array(t)).to(device)
        for name, t in state_of_numpy.items()
    }


def _rank_rows(tree: dict, rank) -> dict:
    """Every leaf's row ``rank`` (kept as a (1, ...) tensor), or the tree
    itself with ``rank`` None."""
    if rank is None:
        return tree
    return {k: v[rank:rank + 1].clone() for k, v in tree.items()}


def _row_columns(tree: dict, shard: Optional[TpShard]) -> dict:
    """The JAX package's global ZeRO-1 rows are ``(n_dp, tp·per)``, the
    model axis over dim 1 for every leaf (a replicated leaf's tp copies
    side by side): the rank's ``per`` columns."""
    if shard is None or shard.size == 1:
        return tree
    out = {}
    for k, v in tree.items():
        per = v.shape[1] // shard.size
        out[k] = v.narrow(1, shard.index * per, per).clone()
    return out


def zero1_state_from_jax(opt_state_of_numpy, comp_state_of_numpy, device, rank=None,
                         shard: Optional[TpShard] = None):
    """JAX ZeRO-1 state as ``build_init_state(fused=False)`` and the train
    step hold it globally — ``{"master": tree, "base": state}``, every
    tensor leaf in its ``(n_dp, ceil(k/n_dp))`` row layout with the leading
    dp dim, AdamW's ``count`` a scalar — and the dp-stacked compressor
    state -> the port's ``(opt_state, comp_state)``: the same rows per leaf
    name (``optim.zero1``'s layout), the base state as the port's optimizer
    holds it (SGD: a leaf dict of momentum rows; AdamW: ``{"mu", "nu",
    "count"}``), the compressor state as :func:`comp_state_from_jax` gives
    it. With ``rank``: the state that rank of a process group holds — row
    ``rank`` of the masters, the optimizer state and IntDIANA's h_local
    (``rank`` the dp index on a data × model grid). With ``shard``: the
    rank's columns of every row and its slice of the compressor state over
    the model axis."""
    def rows(tree):
        return _row_columns(_rank_rows(tree, rank), shard)

    base = opt_state_of_numpy["base"]
    if isinstance(base, dict) and "count" in base:
        base = opt_state_from_jax(base, device)
        base = dict(base, mu=rows(base["mu"]), nu=rows(base["nu"]))
    elif isinstance(base, dict):
        base = rows(params_from_jax(base, device))
    else:  # SGD without momentum keeps no state
        base = ()
    master = rows(params_from_jax(opt_state_of_numpy["master"], device))
    opt_state = {"master": master, "base": base}
    return opt_state, comp_state_from_jax(comp_state_of_numpy, device, rank, shard)


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


def _drop_none(tree: dict) -> dict:
    """A nested dict without its None leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _drop_none(v)
        elif v is not None:
            out[k] = v
    return out


def comp_state_from_jax(state_of_numpy, device, rank=None, shard: Optional[TpShard] = None):
    """JAX compressor state, stacked over the workers as the JAX step and
    ``vmap_workers`` hold it (every leaf with a leading worker axis) -> the
    port's. IntSGD's is a bare ``AlphaState(r, step)`` (r a per-leaf tree
    for blockwise α), taken from worker 0. IntDIANA's is ``{"alpha":
    AlphaState, "h_local": tree, "h_global": tree}``: h_local kept stacked
    ``(n, *shape)`` per leaf (with ``rank``, that rank's row alone, as a
    process group holds it), the replicated h_global and α state taken
    from worker 0. IntSGD on a gather codec's ``{"alpha", "ef"}``: the α
    state from worker 0, the residual stacked. PowerSGD's ``{"q", "err"}``:
    the replicated Q from worker 0 (its matrix leaves only; JAX holds None
    for the others), the error feedback stacked. SignSGD's and TopK's state
    is the error-feedback tree itself, stacked. The float baselines' (and
    Heuristic IntSGD's, QSGD's, NatSGD's) is empty. With ``shard``, every
    per-leaf tensor is the rank's slice over the model axis (α's state is
    replicated), PowerSGD's Q along its own model dimension
    (``PowerSGD.q_model_dim``: its rows where the param is sharded past
    its rows; else the global array's copy, which is model rank 0's where
    the JAX devices' buffers differ)."""
    if isinstance(state_of_numpy, tuple) and not state_of_numpy:
        return ()
    if not isinstance(state_of_numpy, dict):
        return _alpha_state_from_jax(state_of_numpy, device)
    def stacked(tree):  # (n, *leaf) per leaf: the rank's rows, its slice
        return _rank_rows(params_from_jax(tree, device, shard=shard, lead=1), rank)

    def first(tree):
        return {k: v[0].clone() for k, v in params_from_jax(tree, device, shard=shard,
                                                              lead=1).items()}

    if set(state_of_numpy) == {"alpha", "ef"}:
        return {"alpha": _alpha_state_from_jax(state_of_numpy["alpha"], device),
                "ef": stacked(state_of_numpy["ef"])}
    if set(state_of_numpy) == {"q", "err"}:
        err = state_of_numpy["err"]
        q = params_from_jax(_drop_none(state_of_numpy["q"]), device, lead=1)
        q_shard = None if shard is None else dataclasses.replace(
            shard, specs={k: PowerSGD.q_model_dim(shard.specs[k]) for k in q})
        return {"q": {k: (v if q_shard is None else q_shard.take(k, v, 1))[0].clone()
                      for k, v in q.items()},
                "err": None if err is None else stacked(err)}
    if "alpha" not in state_of_numpy:  # an error-feedback tree
        return stacked(state_of_numpy)
    return {
        "alpha": _alpha_state_from_jax(state_of_numpy["alpha"], device),
        "h_local": stacked(state_of_numpy["h_local"]),
        "h_global": first(state_of_numpy["h_global"]),
    }
