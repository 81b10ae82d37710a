"""Gradient compressors (port of ``repro/core/compressor.py``: the exact
mean and IntSGD with the global α rule on a psum wire).

Interface, on the local n-worker backend (:mod:`repro_torch.core.comm`)::

    init(params)                                   -> state (replicated)
    aggregate_wire(state, worker_grads, *, seeds, eta, ctx, dims)
        -> (WireAggregate, alphas, state, metrics)

``worker_grads`` yields each worker's local gradient dict in worker order;
the JAX package runs the same per-worker code under ``vmap``/``shard_map``
and sums inside the collective. IntSGD's α depends on r_k, which depends
on the model update of the previous step: the trainer calls
``observe_update(state, dx_stats)`` after applying the step. The first step
is exact (paper §4.1 "the first communication is exact"): train steps use
:func:`aggregate_exact` at k = 0.

Seeds: the encode's counter PRNG takes one int32 seed per (worker, leaf).
The JAX package derives them from its key (``fold_worker_key`` then one
split per leaf); the port takes them as an ``(n_workers, n_leaves)`` int32
tensor on the card — :func:`leaf_seeds` draws one from a
``torch.Generator``, and a test can hand in the JAX package's own.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, ClassVar, Dict, Iterable

import torch

from repro_torch.core.comm import CommCtx
from repro_torch.core.scaling import AlphaMovingAvg, AlphaRule
from repro_torch.core.stats import DxStats, TreeDims, local_tree_dims
from repro_torch.utils.tree import leaf_names, tree_abs_max
from repro_torch.wire import PackedInt, WireFormat, make_wire_format

Tree = Dict[str, torch.Tensor]


def aggregate_exact(worker_grads: Iterable[Tree], ctx: CommCtx) -> Tree:
    """Full-precision mean over workers (step-0 path)."""
    return ctx.pmean(worker_grads)


def leaf_seeds(generator: torch.Generator, n_workers: int, n_leaves: int,
               device) -> torch.Tensor:
    """Independent int32 encode seeds per (worker, leaf), drawn from
    ``generator`` on the host and placed on ``device``."""
    seeds = torch.randint(
        -(2**31), 2**31, (n_workers, n_leaves), generator=generator,
        dtype=torch.int64,
    ).to(torch.int32)
    return seeds.to(device)


@dataclasses.dataclass(frozen=True)
class WireAggregate:
    """What came back from the integer all-reduce: ``words`` is the summed
    transport payload as it crossed the wire (the fused update consumes
    it), ``ints`` the unpacked summed image Σ_i Int(α g_i)."""

    words: Tree
    ints: Tree


@dataclasses.dataclass(frozen=True)
class Metrics:
    max_int: torch.Tensor  # max |aggregated integer| on the wire
    bits_per_coord: torch.Tensor  # estimated wire bits per coordinate
    payload_bytes: float  # static bytes sent per worker per step


class Compressor:
    name: ClassVar[str] = "base"
    # the compressor half of the fused-route capability contract (the
    # optimizer half is Optimizer.fused_kernel)
    fused_capable: ClassVar[bool] = False

    def init(self, params) -> Any:
        return ()

    def observe_update(self, state, dx_stats: DxStats):
        return state


@dataclasses.dataclass(frozen=True)
class IntSGD(Compressor):
    """Algorithm 1 (global α, moving-average rule). The transport is the
    ``wire`` codec; without one the JAX package falls back to a dense int32
    lane, which the port does not have yet."""

    name: ClassVar[str] = "intsgd"
    alpha_rule: AlphaRule = AlphaMovingAvg()
    bits: int = 32
    stochastic: bool = True
    wire: WireFormat | None = None

    @property
    def fused_capable(self) -> bool:  # type: ignore[override]
        return bool(getattr(self.wire_format, "fused_capable", True))

    @property
    def wire_format(self) -> WireFormat:
        if self.wire is None:
            raise ValueError(
                "IntSGD without a wire codec rides the dense int32 lane, "
                "which is not ported yet; pass wire='packed8' (or packed4/16)"
            )
        return self.wire

    def init(self, params):
        return self.alpha_rule.init(params)

    def observe_update(self, state, dx_stats: DxStats):
        return self.alpha_rule.update(state, dx_stats)

    def _alphas(self, state, names, eta, n, dims: TreeDims):
        a = self.alpha_rule.alpha(state, eta, n, dims.d)
        return {k: a for k in names}

    def encode_ints(self, state, grads: Tree, *, seeds: torch.Tensor, eta,
                    ctx: CommCtx, dims: TreeDims | None = None,
                    n_accum: int = 1):
        """One worker's §5.1-clipped integer image Int(α∘g) and the α dict,
        no wire traffic. Leaf j (in :func:`leaf_names` order) of worker w
        encodes with ``seeds[w, j]``."""
        n = ctx.n
        wf = self.wire_format
        dims = dims if dims is not None else local_tree_dims(grads)
        names = leaf_names(grads)
        alphas = self._alphas(state, names, eta, n, dims)
        row = seeds[ctx.worker_index()]
        ints = {
            k: wf.encode(
                grads[k], alphas[k], row[j], n_workers=n * n_accum,
                stochastic=self.stochastic,
            )
            for j, k in enumerate(names)
        }
        return ints, alphas

    def aggregate_wire(self, state, worker_grads: Iterable[Tree], *,
                       seeds: torch.Tensor, eta, ctx: CommCtx,
                       dims: TreeDims | None = None):
        """Encode each worker's gradients as they arrive, sum the packed
        words across workers, unpack once; no decode (the fused kernel folds
        1/(nα) into the optimizer step). Returns
        ``(WireAggregate, alphas, state, metrics)``."""
        wf = self.wire_format
        alphas = {}

        def images():
            for w, grads in enumerate(worker_grads):
                ints, a = self.encode_ints(
                    state, grads, seeds=seeds, eta=eta, ctx=ctx.at_worker(w),
                    dims=dims,
                )
                alphas.update(a)
                del grads  # the caller's generator drops its reference too
                yield ints
                del ints  # before the next worker's backward runs

        words_sum, int_sum = ctx.psum_wire(images(), wf)
        max_int = tree_abs_max(int_sum)
        bits = 1.0 + torch.ceil(torch.log2(torch.clamp(max_int, min=1.0) + 1.0))
        payload = float(sum(wf.wire_bytes(v.numel()) for v in int_sum.values()))
        return (
            WireAggregate(words=words_sum, ints=int_sum),
            alphas,
            state,
            Metrics(max_int, bits, payload),
        )

    def aggregate(self, state, worker_grads: Iterable[Tree], *,
                  seeds: torch.Tensor, eta, ctx: CommCtx,
                  dims: TreeDims | None = None):
        """Decode-here wrapper: returns ``(ghat, state, metrics)``."""
        wa, alphas, state, metrics = self.aggregate_wire(
            state, worker_grads, seeds=seeds, eta=eta, ctx=ctx, dims=dims
        )
        wf = self.wire_format
        ghat = {
            k: wf.decode(s, alphas[k], n_workers=ctx.n) for k, s in wa.ints.items()
        }
        return ghat, state, metrics


def with_wire(comp: Compressor, wire) -> Compressor:
    """Rebind a compressor to a wire codec (name string or WireFormat)."""
    wire = make_wire_format(wire)
    fields = {f.name for f in dataclasses.fields(comp)}
    if "wire" not in fields:
        raise ValueError(f"compressor {comp.name!r} has no wire-codec seam")
    if comp.bits != wire.bits:
        raise ValueError(
            f"wire codec is {wire.bits}-bit but compressor {comp.name!r} "
            f"was built with bits={comp.bits}; construct them consistently "
            f"(e.g. make_compressor('{comp.name}', bits={wire.bits}, wire=...))"
        )
    return dataclasses.replace(comp, wire=wire)


_COMPRESSORS = {
    "intsgd": IntSGD,
    "intsgd8_packed": partial(IntSGD, bits=8, wire=PackedInt(bits=8)),
    "intsgd4_packed": partial(IntSGD, bits=4, wire=PackedInt(bits=4)),
}


def make_compressor(name: str, **kw) -> Compressor:
    if name not in _COMPRESSORS:
        raise ValueError(
            f"compressor {name!r} is not ported yet; the port has "
            f"{sorted(_COMPRESSORS)}"
        )
    if kw.get("wire") is not None:
        kw = dict(kw)
        wire = kw.pop("wire")
        return with_wire(_COMPRESSORS[name](**kw), wire)  # bits checked
    return _COMPRESSORS[name](**kw)
