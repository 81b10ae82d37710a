"""Mixture-of-Experts block (port of ``repro/models/moe.py``), with the
JAX package's two strategies over the model axis (:func:`pick_strategy`):

- ``moe_tp`` (tp = 1, or an expert count tp does not divide): top-k
  token-choice routing with the probabilities renormalised over the chosen
  k, a capacity buffer per expert with tokens past capacity dropped
  (Switch/Mixtral style), the experts' SwiGLU batched over the experts
  (at tp > 1 each expert's d_ff sharded, the out buffer summed over the
  model group), and the shared experts (DeepSeek-V2) added to every token;
- ``moe_ep`` (tp > 1 dividing the expert count): each rank owns E/tp
  experts and routes its 1/tp slice of the tokens; the dispatch buffer,
  grouped by owner, goes out and comes back by all-to-all over the model
  group; the slices are reassembled by a psum of zeros and the rank's
  slice.

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

from repro_torch.models.common import SINGLE, Axes, swiglu
from repro_torch.models.mlp import swiglu_mlp
from repro_torch.parallel import collectives as coll

CAPACITY_FACTOR = 1.25  # the JAX package's default, which its model keeps


def pick_strategy(n_experts: int, tp: int) -> str:
    """"ep" when tp > 1 divides the expert count, else "tp"."""
    if tp == 1:
        return "tp"
    return "ep" if n_experts % tp == 0 else "tp"


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


def _shared(p: Dict[str, torch.Tensor], x: torch.Tensor, out: torch.Tensor,
            axes: Axes) -> torch.Tensor:
    """``out`` plus the shared experts' SwiGLU of x, if the block has any."""
    shared = {k[len("shared/"):]: v for k, v in p.items() if k.startswith("shared/")}
    return out + swiglu_mlp(shared, x, axes) if shared else out


def moe_tp(p: Dict[str, torch.Tensor], x: torch.Tensor, *, n_experts: int,
           top_k: int, axes: Axes = SINGLE) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d). p: {"router": (d, E), "w_gate", "w_up":
    (E, d, f), "w_down": (E, f, d)} and, with shared experts,
    {"shared/w_gate", "shared/w_up", "shared/w_down"}; f the rank's
    d_ff/tp columns, x replicated over the model group."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    w, ids = route(p["router"], xf, top_k)
    cap = capacity(b * t, top_k, n_experts)
    flat_e, slot, keep = dispatch_indices(ids, n_experts, cap)
    dest = flat_e * cap + slot
    buf = dispatch(xf, dest, keep, top_k, n_experts * cap)
    out_buf = axes.psum_tp(expert_ffn(p, buf.reshape(n_experts, cap, d)))
    out = combine(out_buf.reshape(n_experts * cap, d), dest, w, keep, top_k).reshape(b, t, d)
    return _shared(p, x, out, axes)


def moe_ep(p: Dict[str, torch.Tensor], x: torch.Tensor, *, n_experts: int,
           top_k: int, axes: Axes) -> torch.Tensor:
    """Expert parallelism: p's ``w_*`` are the rank's E/tp experts (whole
    d_ff), x (B, T, d) replicated over the model group. The rank routes
    tokens [i·N/tp, (i+1)·N/tp) of the B·T, with the capacity counted on
    that slice; its (tp, E/tp, C, d) dispatch buffer (owner-major, so
    flat index expert·C + slot, as in :func:`moe_tp`) is exchanged by
    all-to-all, each owned expert runs over the tp·C slots it received,
    and the outputs go back by the inverse all-to-all. The slice's
    combined output is placed in zeros of all B·T tokens and summed over
    the group."""
    tp = axes.tp_size
    b, t, d = x.shape
    n_all = b * t
    n = n_all // tp
    start = axes.tp_index * n
    xf = x.reshape(n_all, d)[start:start + n]
    w, ids = route(p["router"], xf, top_k)
    e_loc = n_experts // tp
    cap = capacity(n, top_k, n_experts)
    flat_e, slot, keep = dispatch_indices(ids, n_experts, cap)
    dest = flat_e * cap + slot
    buf = dispatch(xf, dest, keep, top_k, n_experts * cap).reshape(tp, e_loc, cap, d)
    recv = coll.all_to_all_tp(buf, axes.group)  # (sender, e_loc, C, d)
    recv = recv.transpose(0, 1).reshape(e_loc, tp * cap, d)
    out_buf = expert_ffn(p, recv).reshape(e_loc, tp, cap, d).transpose(0, 1)
    back = coll.all_to_all_tp(out_buf, axes.group)  # (owner, e_loc, C, d)
    out = combine(back.reshape(n_experts * cap, d), dest, w, keep, top_k)
    full = F.pad(out, (0, 0, start, n_all - start - n))  # zeros around the slice
    return _shared(p, x, axes.psum_tp(full).reshape(b, t, d), axes)


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor, *, n_experts: int,
              top_k: int, axes: Axes = SINGLE) -> torch.Tensor:
    """:func:`moe_ep` or :func:`moe_tp`, as :func:`pick_strategy` picks."""
    fn = moe_ep if pick_strategy(n_experts, axes.tp_size) == "ep" else moe_tp
    return fn(p, x, n_experts=n_experts, top_k=top_k, axes=axes)
