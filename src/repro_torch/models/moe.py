"""Mixture-of-Experts block (port of ``repro/models/moe.py`` at tp = 1).

At tp = 1 the JAX package's ``pick_strategy`` always picks ``"tp"``, so
this is ``moe_tp``: top-k token-choice routing with the probabilities
renormalised over the chosen k, a capacity buffer per expert with tokens
past capacity dropped (Switch/Mixtral style), the experts' SwiGLU batched
over the experts, and the shared experts (DeepSeek-V2) added to every
token. ``moe_ep`` (the all_to_all over a model axis) waits for tensor
parallelism.

The block is cut into its stages — :func:`route`, :func:`dispatch_indices`,
:func:`dispatch`, :func:`expert_ffn`, :func:`combine` — which
:func:`moe_tp` runs in turn (a caller can time them one by one). Everything
stays on the device: the capacity comes from shapes, and no per-token value
is read on the host. The JAX package computes the expert products with
plain ``einsum``s outside any Pallas kernel; here they are batched
``torch.matmul``s.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import swiglu
from repro_torch.models.mlp import swiglu_mlp

CAPACITY_FACTOR = 1.25  # the JAX package's default, which its model keeps


def capacity(n_tokens: int, top_k: int, n_experts: int) -> int:
    """Slots per expert: the JAX package's Python float arithmetic."""
    return max(8, int(n_tokens * top_k * CAPACITY_FACTOR / n_experts))


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (N, d) -> (weights (N, k) float32, ids (N, k) int64): softmax of
    the float32 logits ``x @ router``, the k largest probabilities with
    ties to the lowest expert index (as ``lax.top_k``: a stable descending
    sort cut to k, not ``torch.topk``, whose tie order is unspecified),
    renormalised by max(their sum, 1e-9)."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    ids = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[:, :top_k]
    w = torch.gather(probs, -1, ids)
    return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9), ids


def dispatch_indices(ids: torch.Tensor, n_experts: int, cap: int):
    """Each (token, choice)'s slot in its expert's capacity buffer, in
    token-major, choice-minor arrival order (the exclusive prefix count of
    its expert). Returns ``(flat_e, slot, keep)``, each (N·k,): a (token,
    choice) past capacity is dropped (``keep`` False) and parked at slot
    ``cap - 1``, where it adds zeros."""
    flat_e = ids.reshape(-1)
    onehot = F.one_hot(flat_e, n_experts)
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = slot < cap
    return flat_e, torch.where(keep, slot, cap - 1), keep


def dispatch(xf: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor, top_k: int,
             n_slots: int) -> torch.Tensor:
    """Tokens (N, d) scatter-added into the (E·C, d) buffer at ``dest`` =
    expert·C + slot, one row per (token, choice), in the tokens' type; a
    dropped one adds exact zeros."""
    src = xf.repeat_interleave(top_k, dim=0)
    src = torch.where(keep[:, None], src, torch.zeros((), dtype=src.dtype, device=src.device))
    return src.new_zeros((n_slots, xf.shape[1])).index_add(0, dest, src)


def expert_ffn(p: Dict[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d), each expert's SwiGLU on its slots."""
    g = torch.matmul(buf, p["w_gate"].to(buf.dtype))
    u = torch.matmul(buf, p["w_up"].to(buf.dtype))
    return torch.matmul(swiglu(g, u), p["w_down"].to(buf.dtype))


def combine(out_buf: torch.Tensor, dest: torch.Tensor, w: torch.Tensor, keep: torch.Tensor,
            top_k: int) -> torch.Tensor:
    """The (E·C, d) expert outputs gathered back per (token, choice),
    weighted by w·keep in the activation type and summed over the k
    choices: (N, d)."""
    picked = out_buf.index_select(0, dest)
    wk = (w.reshape(-1) * keep).to(out_buf.dtype)
    return torch.sum((picked * wk[:, None]).reshape(-1, top_k, out_buf.shape[1]), dim=1)


def moe_tp(p: Dict[str, torch.Tensor], x: torch.Tensor, *, n_experts: int,
           top_k: int) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). p: {"router": (d, E), "w_gate", "w_up":
    (E, d, f), "w_down": (E, f, d)} and, with shared experts,
    {"shared/w_gate", "shared/w_up", "shared/w_down"}."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    w, ids = route(p["router"], xf, top_k)
    cap = capacity(b * t, top_k, n_experts)
    flat_e, slot, keep = dispatch_indices(ids, n_experts, cap)
    dest = flat_e * cap + slot
    buf = dispatch(xf, dest, keep, top_k, n_experts * cap)
    out_buf = expert_ffn(p, buf.reshape(n_experts, cap, d))
    out = combine(out_buf.reshape(n_experts * cap, d), dest, w, keep, top_k).reshape(b, t, d)
    shared = {k[len("shared/"):]: v for k, v in p.items() if k.startswith("shared/")}
    if shared:
        out = out + swiglu_mlp(shared, x)
    return out
