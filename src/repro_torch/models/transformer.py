"""Decoder-only LM, dense, MoE, hybrid and xLSTM families (port of
``repro/models/transformer.py`` at tp = 1).

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
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.scaling import AlphaState
from repro_torch.models.attention import attention_train
from repro_torch.models.common import cross_entropy, dense_init, rmsnorm
from repro_torch.models.mla import DH_ROPE, mla_train
from repro_torch.models.mlp import swiglu_mlp
from repro_torch.models.moe import moe_tp
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


def _attn_shapes(cfg) -> Dict[str, tuple]:
    """The attention's weight matrices of one layer: MLA's with a
    ``kv_lora``, else GQA's."""
    d, hd = cfg.d_model, _head_dim(cfg)
    q = cfg.n_heads * hd
    if cfg.kv_lora:
        return {"w_dkv": (d, cfg.kv_lora), "w_kr": (d, DH_ROPE),
                "w_q": (d, cfg.n_heads * (hd + DH_ROPE)), "w_uk": (cfg.kv_lora, q),
                "w_uv": (cfg.kv_lora, q), "wo": (q, d)}
    kv = cfg.n_kv_heads * hd
    return {"wk": (d, kv), "wo": (q, d), "wq": (d, q), "wv": (d, kv)}


def _ffn_shapes(cfg) -> Dict[str, tuple]:
    """The feed-forward leaves of one layer: the dense SwiGLU's, or the
    MoE block's (router, experts and shared experts)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family != "moe":
        return {"mlp/w_down": (f, d), "mlp/w_gate": (d, f), "mlp/w_up": (d, f)}
    e = cfg.n_experts
    shapes = {"moe/router": (d, e), "moe/w_down": (e, f, d), "moe/w_gate": (e, d, f),
              "moe/w_up": (e, d, f)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
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


def _layer_shapes(cfg) -> Dict[str, tuple]:
    """One layer's leaves, without the leading layer axes: a Mamba2 layer
    in the hybrid family, an (m, m, s) block in the ssm family, else
    attention and the feed-forward."""
    d = cfg.d_model
    if cfg.family == "ssm":
        h, dh = cfg.n_heads, _head_dim(cfg)
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
        n, h = cfg.ssm_state, _ssm_heads(cfg)
        di = h * SSM_HEAD_DIM
        return {"ln": (d,), "m/a_log": (h,), "m/conv_w": (CONV_K, di), "m/d_skip": (h,),
                "m/dt_bias": (h,), "m/norm_w": (di,), "m/w_bc": (d, 2 * n), "m/w_dt": (d, h),
                "m/w_out": (di, d), "m/w_xz": (d, 2 * di)}
    layer = {f"attn/{k}": s for k, s in _attn_shapes(cfg).items()}
    layer.update({"ln1": (d,), "ln2": (d,), **_ffn_shapes(cfg)})
    return layer


def param_shapes(cfg) -> Dict[str, tuple]:
    """Leaf name -> shape; layer leaves carry the leading layer axes. The
    dict's order is the order in which :func:`init_lm_params` draws."""
    _check_ported(cfg)
    L, d = cfg.n_layers, cfg.d_model
    lead = _layer_axes(cfg)
    shapes = {"embed": (cfg.vocab, d)}
    shapes.update({f"layers/{k}": (*lead, *s) for k, s in _layer_shapes(cfg).items()})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab)
    shapes["ln_f"] = (d,)
    if cfg.family == "hybrid":  # the shared attention block, once
        shared = {f"attn/{k}": s for k, s in _attn_shapes(cfg).items()}
        shared.update({"ln": (2 * d,), "ln2": (d,), "w_in": (2 * d, d), **_ffn_shapes(cfg)})
        shapes.update({f"shared_attn/{k}": s for k, s in shared.items()})
    if cfg.qkv_bias:
        q, kv = cfg.n_heads * _head_dim(cfg), cfg.n_kv_heads * _head_dim(cfg)
        shapes.update({"layers/attn/bk": (L, kv), "layers/attn/bq": (L, q),
                       "layers/attn/bv": (L, kv)})
    if cfg.frontend == "vit":
        shapes["frontend_proj"] = (cfg.frontend_dim, d)
    return shapes


def init_lm_params(cfg, *, generator: torch.Generator, device,
                   dtype=torch.float32) -> Tree:
    """Random weights from ``generator`` (the JAX package's distributions:
    uniform ±1/√fan_in for matrices, fan_in their next-to-last axis; the
    ``CONSTANT_INIT`` leaves filled; zeros for the ``ZERO_INIT`` leaves;
    each mLSTM's ``if_bias`` -2 for the input gates and 3 for the forget
    gates of its heads), on
    ``device``, in ``dtype`` but the ``FLOAT32_LEAVES``. The
    JAX package draws an MoE layer's three expert matrices from one key,
    so its ``w_up`` equals its ``w_gate`` and its ``w_down`` holds the same
    uniforms at the bound 1/√d_ff: here too (``w_down`` is ``w_gate``'s
    values in its shape, times √(d_model/d_ff))."""
    shapes = param_shapes(cfg)
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
        for i in range(down.shape[0]):  # a layer at a time: float32 copies of one layer
            down[i] = (gate[i].to(torch.float32).reshape(down.shape[1:])
                       * math.sqrt(cfg.d_model / cfg.d_ff)).to(dtype)
        params["layers/moe/w_down"] = down
    return params


def _sub(lp, prefix: str):
    """The leaves of ``lp`` under ``prefix``, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in lp.items() if k.startswith(prefix)}


def _layer(lp, x, positions, cfg):
    """One decoder layer (the JAX package's ``_dense_layer`` or
    ``_moe_layer``): attention, then the SwiGLU or the MoE block."""
    attn, xn = _sub(lp, "attn/"), rmsnorm(x, lp["ln1"])
    if cfg.kv_lora:
        h = x + mla_train(attn, xn, positions, n_heads=cfg.n_heads, head_dim=_head_dim(cfg))
    else:
        h = x + attention_train(
            attn, xn, positions,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=_head_dim(cfg),
            rope_theta=cfg.rope_theta, window=cfg.window,
        )
    if cfg.family == "moe":
        return h + moe_tp(_sub(lp, "moe/"), rmsnorm(h, lp["ln2"]),
                          n_experts=cfg.n_experts, top_k=cfg.top_k)
    return h + swiglu_mlp(_sub(lp, "mlp/"), rmsnorm(h, lp["ln2"]))


def _mamba_layer(lp, x, cfg):
    """One Mamba2 layer of the hybrid family, behind its RMSNorm."""
    return x + mamba2_train(_sub(lp, "m/"), rmsnorm(x, lp["ln"]), n_heads=_ssm_heads(cfg),
                            head_dim=SSM_HEAD_DIM, d_state=cfg.ssm_state)


def _xlstm_block(bp, x, cfg):
    """One (mLSTM, mLSTM, sLSTM) block of the ssm family, each cell behind
    its RMSNorm and added to the residual."""
    kw = dict(n_heads=cfg.n_heads, head_dim=_head_dim(cfg))
    for name, cell in zip(XLSTM_CELLS, (mlstm_train, mlstm_train, slstm_train)):
        lp = _sub(bp, f"{name}/")
        x = x + cell(_sub(lp, "cell/"), rmsnorm(x, lp["ln"]), **kw)
    return x


def _shared_attn_block(p, h, emb, positions, cfg):
    """The hybrid family's shared block: RMSNorm of concat[h, emb] over
    2·d_model, ``w_in`` back to d_model, attention (no window) and the
    SwiGLU, each residual; added to h."""
    z = rmsnorm(torch.cat([h, emb], dim=-1), p["ln"])
    z = z @ p["w_in"].to(z.dtype)
    z = z + attention_train(
        _sub(p, "attn/"), z, positions, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=_head_dim(cfg), rope_theta=cfg.rope_theta,
    )
    z = z + swiglu_mlp(_sub(p, "mlp/"), rmsnorm(z, p["ln2"]))
    return h + z


def _embed_inputs(params: Tree, batch, cfg) -> torch.Tensor:
    """Token embeddings (B, T, d) in the params' type; with the vit
    frontend the projected patch embeddings come first (B, N + T, d),
    projected in the embedding's type as the JAX package does."""
    x = F.embedding(batch["tokens"], params["embed"])
    if cfg.frontend == "vit":
        pe = batch["patch_embeds"].to(x.dtype) @ params["frontend_proj"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def lm_forward(params: Tree, batch, cfg, dtype=torch.bfloat16) -> torch.Tensor:
    """Hidden states after the final norm: (B, T', d), T' counting the
    frontend's positions. In the hybrid family the shared attention block
    follows every ``attn_every`` Mamba2 layers, reading the embedded input
    in the activation type beside h; in the ssm family each step of the
    loop is an (m, m, s) block."""
    _check_ported(cfg)
    x = _embed_inputs(params, batch, cfg).to(dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device).expand(b, t)
    lead = _layer_axes(cfg)
    layers = {k: v.flatten(0, len(lead) - 1).unbind(0)
              for k, v in _sub(params, "layers/").items()}
    emb0, shared = x, _sub(params, "shared_attn/")
    for i in range(math.prod(lead)):
        lp = {k: v[i] for k, v in layers.items()}
        if cfg.family == "ssm":
            x = _xlstm_block(lp, x, cfg)
        elif cfg.family == "hybrid":
            x = _mamba_layer(lp, x, cfg)
            if (i + 1) % cfg.attn_every == 0:
                x = _shared_attn_block(shared, x, emb0, positions, cfg)
        else:
            x = _layer(lp, x, positions, cfg)
    return rmsnorm(x, params["ln_f"])


def lm_logits(params: Tree, h: torch.Tensor, cfg) -> torch.Tensor:
    """The JAX package's ``lm_logits_local`` at tp = 1: h @ head in h's
    type, then float32; the head is ``embed``'s transpose when tied."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ head.to(h.dtype)).to(torch.float32)


def lm_loss(params: Tree, batch, cfg, dtype=torch.bfloat16) -> torch.Tensor:
    """Mean next-token cross entropy over labelled positions (float32); with
    the vit frontend only the text positions carry labels. With tied
    embeddings the head is ``embed``'s transpose."""
    h = lm_forward(params, batch, cfg, dtype)
    if cfg.frontend == "vit":
        h = h[:, -batch["tokens"].shape[1]:]
    logits = lm_logits(params, h, cfg)
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
            out[name] = _tensor(v, device)
    return out


def _tensor(v, device) -> torch.Tensor:
    a = np.array(v)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: through float32, exact
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def opt_state_from_jax(state_of_numpy, device) -> Dict[str, object]:
    """JAX fused-route optimizer state (``{"mom": tree}`` for SGD,
    ``{"mu": tree, "nu": tree, "count": int32 scalar}`` for AdamW) -> the
    port's: a leaf dict per tree, a tensor per scalar."""
    return {
        name: params_from_jax(t, device) if isinstance(t, dict)
        else torch.from_numpy(np.array(t)).to(device)
        for name, t in state_of_numpy.items()
    }


def _rank_rows(tree: dict, rank) -> dict:
    """Every leaf's row ``rank`` (kept as a (1, ...) tensor), or the tree
    itself with ``rank`` None."""
    if rank is None:
        return tree
    return {k: v[rank:rank + 1].clone() for k, v in tree.items()}


def zero1_state_from_jax(opt_state_of_numpy, comp_state_of_numpy, device, rank=None):
    """JAX ZeRO-1 state as ``build_init_state(fused=False)`` and the train
    step hold it globally — ``{"master": tree, "base": state}``, every
    tensor leaf in its ``(n_dp, ceil(k/n_dp))`` row layout with the leading
    dp dim, AdamW's ``count`` a scalar — and the dp-stacked compressor
    state -> the port's ``(opt_state, comp_state)``: the same rows per leaf
    name (``optim.zero1``'s layout), the base state as the port's optimizer
    holds it (SGD: a leaf dict of momentum rows; AdamW: ``{"mu", "nu",
    "count"}``), the compressor state as :func:`comp_state_from_jax` gives
    it. With ``rank``: the state that rank of a process group holds — row
    ``rank`` of the masters, the optimizer state and IntDIANA's h_local."""
    base = opt_state_of_numpy["base"]
    if isinstance(base, dict) and "count" in base:
        base = opt_state_from_jax(base, device)
        base = dict(base, mu=_rank_rows(base["mu"], rank), nu=_rank_rows(base["nu"], rank))
    elif isinstance(base, dict):
        base = _rank_rows(params_from_jax(base, device), rank)
    else:  # SGD without momentum keeps no state
        base = ()
    master = _rank_rows(params_from_jax(opt_state_of_numpy["master"], device), rank)
    opt_state = {"master": master, "base": base}
    return opt_state, comp_state_from_jax(comp_state_of_numpy, device, rank)


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


def comp_state_from_jax(state_of_numpy, device, rank=None):
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
    Heuristic IntSGD's, QSGD's, NatSGD's) is empty."""
    if isinstance(state_of_numpy, tuple) and not state_of_numpy:
        return ()
    if not isinstance(state_of_numpy, dict):
        return _alpha_state_from_jax(state_of_numpy, device)
    if set(state_of_numpy) == {"alpha", "ef"}:
        return {"alpha": _alpha_state_from_jax(state_of_numpy["alpha"], device),
                "ef": _rank_rows(params_from_jax(state_of_numpy["ef"], device), rank)}
    if set(state_of_numpy) == {"q", "err"}:
        q = {k: v[0].clone()
             for k, v in params_from_jax(_drop_none(state_of_numpy["q"]), device).items()}
        err = state_of_numpy["err"]
        return {"q": q, "err": None if err is None
                else _rank_rows(params_from_jax(err, device), rank)}
    if "alpha" not in state_of_numpy:  # an error-feedback tree
        return _rank_rows(params_from_jax(state_of_numpy, device), rank)
    return {
        "alpha": _alpha_state_from_jax(state_of_numpy["alpha"], device),
        "h_local": _rank_rows(params_from_jax(state_of_numpy["h_local"], device), rank),
        "h_global": {
            k: v[0].clone()
            for k, v in params_from_jax(state_of_numpy["h_global"], device).items()
        },
    }
