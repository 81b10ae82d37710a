"""ZeRO-1 (port of ``repro/optim/zero1.py``): the f32 master weights and the
optimizer state sharded over the n data-parallel workers, the compute
params replicated in ``param_dtype``.

Storage layout per parameter leaf (the flattened leaf, zero-padded at the
end)::

    master, optimizer state: (n_dp, ceil(k / n_dp)) f32 — row w is worker w's

AdamW's ``count`` stays an int32 scalar on the card. On the local n-worker
backend one process holds all n rows of every leaf; on a process group
each rank holds and updates only its own row, a (1, ceil(k / n_dp)) tensor
(``rank=``).

Step protocol, as the JAX package runs it inside ``shard_map``:

  1. ĝ (the decoded aggregate, the same on every worker) is cut into the
     same rows, and worker w takes row w;
  2. the base optimizer's update runs on worker w's f32 master row (weight
     decay reads the master);
  3. the new master rows are cast to ``param_dtype`` and all-gathered back
     to the leaf's shape (``collectives.all_gather_rows``).

Every ported optimizer is elementwise, so on the local backend the n
workers' rows of a leaf are updated as one (n_dp, k / n_dp) tensor op, and
a rank's own row on a group comes out bit-equal to row w of it. The gather
goes through the collectives module (``dist.all_gather`` in rank order on a
group).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.optim.base import Optimizer
from repro_torch.parallel import collectives as coll

Tree = Dict[str, torch.Tensor]


def _pad_rows(flat: torch.Tensor, n_dp: int) -> torch.Tensor:
    k = flat.shape[0]
    per = -(-k // n_dp)
    if per * n_dp != k:
        flat = F.pad(flat, (0, per * n_dp - k))
    return flat.reshape(n_dp, per)


def shard_leaf(x: torch.Tensor, n_dp: int) -> torch.Tensor:
    """param leaf -> its (n_dp, k/n_dp) f32 master rows (a copy)."""
    return _pad_rows(x.reshape(-1).to(torch.float32, copy=True), n_dp)


def _own_rows(rows: torch.Tensor, rank) -> torch.Tensor:
    """All n rows locally (``rank`` None), or the rank's (1, per) row (a
    view)."""
    return rows if rank is None else rows[rank:rank + 1]


def zero1_init(base: Optimizer, params: Tree, n_dp: int, rank=None):
    """``{"master": {leaf: rows}, "base": base.init(masters)}``: the masters
    equal the params, the optimizer state has the masters' layout; all n
    rows, or with ``rank`` that rank's row alone."""
    masters = {k: _own_rows(shard_leaf(p, n_dp), rank) for k, p in params.items()}
    if rank is not None:  # keep the row, not the n rows it views
        masters = {k: m.clone() for k, m in masters.items()}
    return {"master": masters, "base": base.init(masters)}


def zero1_update(base: Optimizer, state, ghat: Tree, eta, *, n_dp: int,
                 param_dtype=torch.float32, params_like: Tree, group=None,
                 consume_grads: bool = False):
    """One ZeRO-1 step of this process's rows: every worker's locally, the
    rank's own on a process ``group``. Returns ``(new_params,
    new_state)``: the gathered params in ``param_dtype`` with
    ``params_like``'s shapes, and the new master rows and optimizer
    state. With ``consume_grads`` each leaf is removed from ``ghat`` as its
    rows are taken (on a group the rank's row is copied out), so that the
    full ĝ leaves a rank no longer needs are freed before the params are
    gathered."""
    masters = state["master"]
    rank = None if group is None else coll.group_rank(group)

    def grad_rows(k):
        rows = _own_rows(_pad_rows(ghat[k].reshape(-1).to(torch.float32), n_dp), rank)
        if not consume_grads:
            return rows
        del ghat[k]
        return rows if rank is None else rows.clone()

    g_rows = {k: grad_rows(k) for k in masters}
    updates, new_base = base.update(g_rows, state["base"], masters, eta)
    del g_rows
    new_master = {k: m + updates[k] for k, m in masters.items()}
    del updates

    def gather_param(rows, like):
        # with f32 params and no padding the leaf is a view of the new master
        # rows (nothing writes either in place)
        full = coll.all_gather_rows(rows.to(param_dtype), group)
        return full[: like.numel()].reshape(like.shape)

    new_params = {k: gather_param(new_master[k], params_like[k]) for k in masters}
    return new_params, {"master": new_master, "base": new_base}
