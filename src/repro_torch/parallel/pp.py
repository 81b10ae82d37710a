"""Pipeline parallelism (port of ``repro/parallel/pp.py``): a GPipe fill and
drain over microbatches, each rank of a stage group holding L/n_stages
layers and handing its activations to the next stage through
:func:`~repro_torch.parallel.collectives.ppermute_ring`.

Schedule: n_micro + n_stages - 1 ticks. At tick t stage s is active when
0 <= t - s < n_micro: stage 0 reads microbatch t, every other stage what
its neighbour sent at tick t - 1, and the last stage records microbatch
t - (n_stages - 1). An inactive tick sends zeros and computes nothing (the
JAX package computes it and discards the result). The steady-state bubble
fraction is (n_stages - 1)/(n_micro + n_stages - 1). As in the JAX package
no train step uses it: IntSGD would compose unchanged, the stage's
gradients staying stage-local and its data-parallel integer all-reduce
running per stage shard.

The backward is one autograd Function over the whole schedule. It runs the
ticks in reverse on every rank, with exactly one inverse ring send a tick,
and recomputes each active tick's stage from the input it saved (GPipe's
recompute; on one device the same float32 ops give the same bits). Only
the last stage's output cotangent is read. So every rank issues the same
ring sends whether or not its loss reaches its own: stage 0 never reads
what it receives, and a stage that is not last outputs zeros, yet both
take part in the backward. Every rank of the stage group must therefore
backpropagate through the output (its loss may weigh it by zero).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch.parallel import collectives as coll

StageParams = Union[torch.Tensor, Dict[str, torch.Tensor]]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """The share of a stage's ticks it sits idle in the fill and drain."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_forward(layer_fn: Callable, stage_params: StageParams, x_micro: torch.Tensor, *,
                     group, n_stages: int) -> torch.Tensor:
    """Run a layer stack split across the ``n_stages`` ranks of ``group``
    over microbatches; the stage is the rank in ``group``.

    ``layer_fn(params, x) -> x`` is applied to each of this stage's layers
    in order (``stage_params``: a tensor, or a dict of tensors, with a
    leading dim of L/n_stages; ``params`` is one layer's slice of it), and
    must keep ``x``'s shape and type (not checked). ``x_micro``: (n_micro,
    mb, ...) microbatches; only stage 0's is read. Returns (n_micro, mb, ...): the
    stack's output on the last stage, zeros on the others. Differentiable
    in ``stage_params`` and ``x_micro`` (see the module docstring)."""
    if group is None:
        raise ValueError("pipeline_forward needs the stage group of ranks (one stage a "
                         "rank); the local backend holds no pipeline stages")
    if coll.group_size(group) != n_stages:
        raise ValueError(f"{n_stages} stages on a group of {coll.group_size(group)} ranks: "
                         "one stage a rank")
    keys = None if isinstance(stage_params, torch.Tensor) else list(stage_params)
    leaves = [stage_params] if keys is None else [stage_params[k] for k in keys]
    depths = {int(v.shape[0]) for v in leaves}
    if len(depths) != 1:
        raise ValueError(f"stage_params' leaves have leading dims {sorted(depths)}: one "
                         "stacked layer axis of L/n_stages")
    return _Pipeline.apply(layer_fn, group, n_stages, keys, x_micro, *leaves)


def _stage_apply(layer_fn, keys: Optional[List[str]], leaves, x: torch.Tensor) -> torch.Tensor:
    """This stage's layers in order (the JAX package's ``lax.scan``)."""
    for i in range(leaves[0].shape[0]):
        lp = leaves[0][i] if keys is None else {k: v[i] for k, v in zip(keys, leaves)}
        x = layer_fn(lp, x)
    return x


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer_fn, group, n_stages, keys, x_micro, *leaves):
        stage, n_micro = coll.group_rank(group), x_micro.shape[0]
        outputs = torch.zeros_like(x_micro)
        inflight = torch.zeros_like(x_micro[0])
        inputs = []  # each active tick's stage input, in tick order
        for t in range(n_micro + n_stages - 1):
            if 0 <= t - stage < n_micro:
                x_in = x_micro[t] if stage == 0 else inflight
                out = _stage_apply(layer_fn, keys, leaves, x_in)
                inputs.append(x_in)
                if stage == n_stages - 1:
                    outputs[t - stage] = out
            else:
                out = torch.zeros_like(inflight)
            inflight = coll.ppermute_ring(out, group, shift=1)
        ctx.layer_fn, ctx.group, ctx.n_stages, ctx.keys = layer_fn, group, n_stages, keys
        ctx.n_leaves = len(leaves)
        ctx.save_for_backward(*leaves, *inputs)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        group, n_stages = ctx.group, ctx.n_stages
        saved = ctx.saved_tensors
        leaves, inputs = saved[:ctx.n_leaves], saved[ctx.n_leaves:]
        stage, n_micro = coll.group_rank(group), g_out.shape[0]
        need_x = ctx.needs_input_grad[4]
        need_leaf = ctx.needs_input_grad[5:]
        g_x = torch.zeros_like(g_out) if need_x else None
        g_leaves: List[Optional[torch.Tensor]] = [None] * len(leaves)
        # the cotangent of the input this rank took at the tick after the
        # current one: sent back to the stage before (zeros from stage 0,
        # whose input is x_micro, not the ring)
        g_held = torch.zeros_like(g_out[0])
        for t in reversed(range(n_micro + n_stages - 1)):
            g_sent = coll.ppermute_ring(g_held, group, shift=-1)
            m = t - stage
            if not 0 <= m < n_micro:
                g_held = torch.zeros_like(g_held)
                continue
            g = g_out[m] if stage == n_stages - 1 else g_sent
            want_x = stage != 0 or need_x
            with torch.enable_grad():
                x_in = inputs[m].detach().requires_grad_(want_x)
                lv = [v.detach().requires_grad_(need) for v, need in zip(leaves, need_leaf)]
                out = _stage_apply(ctx.layer_fn, ctx.keys, lv, x_in)
                wrt = ([x_in] if want_x else []) + [v for v in lv if v.requires_grad]
                grads = list(torch.autograd.grad(out, wrt, g, allow_unused=True)) if wrt else []
            g_in = grads.pop(0) if want_x else None
            if g_in is None and want_x:
                g_in = torch.zeros_like(x_in)
            for i, need in enumerate(need_leaf):
                if not need:
                    continue
                gi = grads.pop(0)
                if gi is None:
                    gi = torch.zeros_like(leaves[i])
                # the first copied: autograd may hand back a cotangent itself
                g_leaves[i] = gi.clone() if g_leaves[i] is None else g_leaves[i].add_(gi)
            if stage == 0:
                if need_x:
                    g_x[m] = g_in
                g_held = torch.zeros_like(g_held)
            else:
                g_held = g_in
        return (None, None, None, None, g_x, *g_leaves)
