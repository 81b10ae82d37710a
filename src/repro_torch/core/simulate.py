"""n-worker distributed training simulated on one device (port of
``repro/core/simulate.py``).

The workers run in turn on the local backend (``CommCtx(n)``) through the
same compressor code the train step runs, so a convergence experiment
exercises the distributed algorithm itself: each worker's gradient, its
integer image Int(α g_i) (the encode kernel on the card), the integer sum,
the decode, the α rule. The first round is exact (paper §4.1); later rounds
call ``compressor.aggregate``, then the optimizer and
:func:`~repro_torch.optim.base.apply_updates`, and feed ||Δx||² × dx_scale²
back to the α rule.

Used by ``tests/test_torch_convergence.py``, ``tests/test_torch_simulate.py``
and ``chip_smoke.py``'s simulator phase.

Encode seeds: one int32 per (worker, leaf) and step, drawn from
``generator`` (:func:`~repro_torch.core.compressor.leaf_seeds`), or given by
``seeds_fn(step) -> (n_workers, n_leaves)`` — a test hands in the JAX
package's own, so the integer images match bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.comm import CommCtx
from repro_torch.core.compressor import Compressor, aggregate_exact, leaf_seeds
from repro_torch.core.stats import local_dx_stats, scale_dx_stats
from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import leaf_names

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class SimState:
    params: Tree  # replicated
    opt_state: Any  # replicated
    comp_state: Any  # the compressor's, for all n workers (IntDIANA's h_local stacked)
    step: int


def _worker_batch(batches, w: int):
    """Worker w's slice of batches that carry a leading worker axis: a
    tensor, or a dict of them."""
    if isinstance(batches, dict):
        return {k: v[w] for k, v in batches.items()}
    return batches[w]


class SimTrainer:
    """``loss_fn(params, batch) -> scalar loss`` with ``params`` a dict of
    tensors. Batches carry a leading worker axis: ``batch[i]`` (or
    ``batch[k][i]`` for a dict) is worker i's minibatch, so heterogeneous
    data is supported. Runs on ``device`` (the card unless the caller asks
    for the CPU, where the kernels' plain versions run)."""

    def __init__(self, loss_fn: Callable, n_workers: int, compressor: Compressor,
                 optimizer: Optimizer, lr_schedule: Callable, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 seeds_fn: Optional[Callable] = None):
        self.loss_fn = loss_fn
        self.n = n_workers
        self.comp = compressor
        self.opt = optimizer
        self.lr = lr_schedule
        self.device = resolve_device(device)
        self.ctx = CommCtx(n_workers=n_workers)
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.seeds_fn = seeds_fn

    def init(self, params: Tree) -> SimState:
        params = {k: v.to(self.device) for k, v in params.items()}
        return SimState(params=params, opt_state=self.opt.init(params),
                        comp_state=self.comp.init(params, self.n), step=0)

    def _grads(self, params: Tree, batches):
        """Each worker's gradient in turn (a generator: one alive at a
        time)."""
        for w in range(self.n):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = self.loss_fn(leaves, _worker_batch(batches, w))
            yield dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def _seeds(self, step: int, n_leaves: int) -> torch.Tensor:
        if self.seeds_fn is None:
            return leaf_seeds(self.generator, self.n, n_leaves, self.device)
        seeds = torch.as_tensor(self.seeds_fn(step), dtype=torch.int32)
        if tuple(seeds.shape) != (self.n, n_leaves):
            raise ValueError(f"seeds_fn({step}) gave {tuple(seeds.shape)}, expected "
                             f"({self.n}, {n_leaves})")
        return seeds.to(self.device)

    def step(self, state: SimState, batches):
        """One round: exact at step 0 (paper §4.1), compressed after.
        Returns ``(state', metrics)``; metrics is None on the exact round,
        else the compressor's :class:`~repro_torch.core.compressor.Metrics`."""
        params = state.params
        eta = self.lr(state.step, self.device)
        grads = self._grads(params, batches)
        if state.step == 0:
            ghat, cs, metrics = aggregate_exact(grads, self.ctx), state.comp_state, None
        else:
            seeds = self._seeds(state.step, len(leaf_names(params)))
            ghat, cs, metrics = self.comp.aggregate(
                state.comp_state, grads, seeds=seeds, eta=eta, ctx=self.ctx)
        updates, opt_state = self.opt.update(ghat, state.opt_state, params, eta)
        new_params = apply_updates(params, updates)
        # Δx = x^{k+1} - x^k feeds r_{k+1} (Alg. 1 line 6), rescaled to
        # gradient-equivalent units (§4.1: dx_scale = 1-μ)
        dx = scale_dx_stats(local_dx_stats(updates), self.opt.dx_scale)
        cs = self.comp.observe_update(cs, dx)
        return SimState(new_params, opt_state, cs, state.step + 1), metrics
