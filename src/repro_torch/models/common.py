"""Shared model pieces (port of ``repro/models/common.py``), with its
tensor-parallel (TP) primitives.

Sharding convention (the JAX package's, Megatron style): embeddings and
the LM head vocab-sharded over the model axis (the lookup masks the ids
outside the rank's slice and sums the rows; the cross entropy never
gathers the logits); attention QKV and MLP in column-parallel, their out
projections row-parallel (a psum); norms, the MoE router and the other
small leaves replicated. Head padding: Q heads pad to a multiple of tp,
and KV heads pad up to one per rank (or to a multiple of tp) as
independent heads, so every leaf is either sharded whole or replicated.

:class:`Axes` carries the model group (and, for a sequence-sharded
decode, the data group). At tp = 1 (``SINGLE``) every primitive is the
single-device computation, bit for bit: no collective and no padding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True)
class Axes:
    """The model axis as the model code sees it: the model group (None at
    tp = 1), its size and this rank's index in it; and, for the
    sequence-sharded decode (the JAX package's ``Axes.sp``), the data group
    whose ranks each hold one slice of the KV cache's sequence (``sp``,
    None otherwise), its size and this rank's index in it."""

    group: Any = None
    tp_size: int = 1
    tp_index: int = 0
    sp: Any = None
    sp_size: int = 1
    sp_index: int = 0

    def psum_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the model group (forward and backward; see
        ``collectives.psum_tp``); x itself at tp = 1."""
        return x if self.tp_size == 1 else coll.psum_tp(x, self.group)

    def pmax_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp_size == 1 else coll.pmax_tp(x, self.group)

    def psum_sp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the sequence shards (the data group); x itself without
        ``sp``."""
        return x if self.sp is None else coll.psum_sp(x, self.sp)

    def pmax_sp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.sp is None else coll.pmax_sp(x, self.sp)


SINGLE = Axes()


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """Resolved (padded) head counts for a TP degree."""

    n_q: int  # padded global Q heads
    n_kv: int  # padded global KV heads
    head_dim: int
    q_local: int
    kv_local: int

    @property
    def group(self) -> int:
        return self.n_q // self.n_kv


def plan_heads(n_q: int, n_kv: int, head_dim: int, tp: int) -> HeadLayout:
    """The JAX package's head plan: Q heads padded to a multiple of tp; KV
    heads padded up to tp when tp is a multiple of their count, else to a
    multiple of tp; Q padded again until the KV count divides it."""
    q_pad = pad_to_multiple(n_q, tp)
    kv_pad = n_kv
    if kv_pad % tp != 0 and tp % kv_pad == 0:
        kv_pad = tp  # one KV head per rank
    elif kv_pad % tp != 0:
        kv_pad = pad_to_multiple(n_kv, tp)
    if q_pad % kv_pad != 0:
        q_pad = pad_to_multiple(pad_to_multiple(q_pad, kv_pad), tp)
    return HeadLayout(q_pad, kv_pad, head_dim, q_pad // tp, kv_pad // tp)


@dataclasses.dataclass(frozen=True)
class TpShard:
    """One rank's slice of a global tree over the model axis: ``specs``
    names each leaf's sharded dimension (None: replicated), as
    ``launch.specs.infer_param_specs`` derives it; ``index`` is the rank's
    tp index of ``size``."""

    specs: Dict[str, Optional[int]]
    index: int
    size: int

    def take(self, name: str, v: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """The rank's slice of leaf ``name`` (a copy), its sharded dimension
        counted after ``lead`` leading axes (a per-worker axis)."""
        dim = self.specs[name]
        if dim is None or self.size == 1:
            return v
        n = v.shape[lead + dim] // self.size
        return v.narrow(lead + dim, self.index * n, n).clone()

    def tree(self, tree: Dict[str, torch.Tensor], lead: int = 0) -> Dict[str, torch.Tensor]:
        return {k: self.take(k, v, lead) for k, v in tree.items()}


def gather_shards(parts: List[Dict[str, torch.Tensor]], specs: Dict[str, Optional[int]],
                  lead: int = 0) -> Dict[str, torch.Tensor]:
    """The inverse of :meth:`TpShard.take`: the ranks' slices (in tp index
    order) concatenated along each leaf's sharded dimension; a replicated
    leaf is rank 0's."""
    out = {}
    for k, v in parts[0].items():
        dim = specs[k]
        out[k] = v if dim is None else torch.cat([p[k] for p in parts], dim=lead + dim)
    return out


def dense_init(shape, in_dim: int, *, generator: torch.Generator, device,
               dtype=torch.float32) -> torch.Tensor:
    """U(-1/√in_dim, 1/√in_dim), drawn from ``generator`` on ``device``."""
    scale = 1.0 / math.sqrt(max(in_dim, 1))
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.uniform_(-scale, scale, generator=generator)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """The mean and the population variance in float32, then (x − mu)·
    rsqrt(var + eps)·w + b in float32, cast to x's type."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: (..., T, H, dh); positions: (..., T) integer. The angle table is
    float32, computed in the JAX package's order."""
    dh = x.shape[-1]
    half = dh // 2
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32, device=x.device))
    freqs = torch.exp(
        -log_theta * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, axes: Axes = SINGLE) -> torch.Tensor:
    """Rows of the vocab-sharded ``table`` (V/tp, d) for global ``ids``:
    each rank looks up the ids in its slice, zeros the others, and the
    rows are summed over the model group. ``F.embedding`` at tp = 1."""
    if axes.tp_size == 1:
        return F.embedding(ids, table)
    v_local = table.shape[0]
    local = ids - axes.tp_index * v_local
    ok = (local >= 0) & (local < v_local)
    rows = F.embedding(local.clamp(0, v_local - 1), table)
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return axes.psum_tp(rows)


def tp_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     axes: Axes = SINGLE) -> torch.Tensor:
    """Megatron's parallel softmax cross entropy: ``logits`` (..., V/tp)
    this rank's vocab slice, ``labels`` (...) global ids. The max is taken
    over the group outside autograd (a stabilizer), and the exp-sum and the
    picked logit each go through ``psum_tp``, whose backward sums each
    one's cotangent over the group. :func:`cross_entropy` at tp = 1."""
    if axes.tp_size == 1:
        return cross_entropy(logits, labels)
    v_local = logits.shape[-1]
    logits = logits.to(torch.float32)
    gmax = axes.pmax_tp(torch.amax(logits.detach(), dim=-1))
    shifted = logits - gmax[..., None]
    sumexp = axes.psum_tp(torch.sum(torch.exp(shifted), dim=-1))
    local = labels - axes.tp_index * v_local
    ok = (local >= 0) & (local < v_local)
    picked = torch.gather(shifted, -1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    picked = axes.psum_tp(torch.where(ok, picked, torch.zeros_like(picked)))
    return torch.log(sumexp) - picked


def col_parallel(x: torch.Tensor, w: torch.Tensor, axes: Axes = SINGLE,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., d_in) replicated, w (d_in, d_out/tp) this rank's columns:
    the output is sharded, no collective."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(y.dtype)


def row_parallel(x: torch.Tensor, w: torch.Tensor, axes: Axes = SINGLE,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., d_in/tp) sharded, w (d_in/tp, d_out) this rank's rows: the
    partial products summed over the model group, then the bias."""
    y = axes.psum_tp(x @ w.to(x.dtype))
    return y if b is None else y + b.to(y.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token softmax cross entropy (the tp = 1 case of the JAX package's
    parallel CE). logits: (..., V) float32; labels: (...) ids, negative for
    positions without a label. Returns (...)."""
    v = logits.shape[-1]
    logits = logits.to(torch.float32)
    # stabilizer only, not a differentiable path
    shifted = logits - torch.amax(logits, dim=-1, keepdim=True).detach()
    sumexp = torch.sum(torch.exp(shifted), dim=-1)
    ok = (labels >= 0) & (labels < v)
    picked = torch.gather(shifted, -1, labels.clamp(0, v - 1)[..., None])[..., 0]
    picked = torch.where(ok, picked, torch.zeros_like(picked))
    return torch.log(sumexp) - picked


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(up.dtype) * up
