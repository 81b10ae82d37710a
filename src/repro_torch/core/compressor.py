"""Gradient compressors (port of ``repro/core/compressor.py``: the exact
mean, IntSGD with a global or blockwise α rule, and IntDIANA, on a psum
wire).

Interface, on the local n-worker backend (:mod:`repro_torch.core.comm`)::

    init(params, n_workers)                        -> state
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
from repro_torch.core.scaling import AlphaBlockwise, AlphaDiana, AlphaMovingAvg, AlphaRule
from repro_torch.core.stats import DxStats, TreeDims, local_tree_dims
from repro_torch.utils.tree import leaf_names, tree_abs_max
from repro_torch.wire import DenseInt, PackedInt, WireFormat, make_wire_format

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


def _wire_metrics(wf: WireFormat, int_sum: Tree) -> Metrics:
    max_int = tree_abs_max(int_sum)
    bits = 1.0 + torch.ceil(torch.log2(torch.clamp(max_int, min=1.0) + 1.0))
    payload = float(sum(wf.wire_bytes(v.numel()) for v in int_sum.values()))
    return Metrics(max_int, bits, payload)


class Compressor:
    name: ClassVar[str] = "base"
    # the compressor half of the fused-route capability contract (the
    # optimizer half is Optimizer.fused_kernel)
    fused_capable: ClassVar[bool] = False
    # state that reads each worker's LOCAL integer image (IntDIANA's h_local)
    fused_local_state: ClassVar[bool] = False

    def init(self, params, n_workers: int = 1) -> Any:
        """Initial state for ``n_workers`` workers simulated on one device
        (only per-worker state, such as IntDIANA's h_local, depends on n)."""
        return ()

    def fused_shift(self, state):
        """The replicated global shift the fused decode adds (None: none)."""
        return None

    def fused_store_shift(self, state, new_shift):
        return state

    def observe_update(self, state, dx_stats: DxStats):
        return state


@dataclasses.dataclass(frozen=True)
class IntSGD(Compressor):
    """Algorithm 1 (global α) / Algorithm 2 (blockwise α: one α per leaf,
    ``alpha_rule=AlphaBlockwise()``). The transport is the ``wire`` codec;
    without one it is ``DenseInt(bits)``, one native lane per
    coordinate."""

    name: ClassVar[str] = "intsgd"
    alpha_rule: AlphaRule = AlphaMovingAvg()
    bits: int = 32
    stochastic: bool = True
    wire: WireFormat | None = None

    @property
    def fused_capable(self) -> bool:  # type: ignore[override]
        return bool(getattr(self.wire_format, "fused_capable", True))

    @property
    def blockwise(self) -> bool:
        return isinstance(self.alpha_rule, AlphaBlockwise)

    @property
    def wire_format(self) -> WireFormat:
        return self.wire if self.wire is not None else DenseInt(bits=self.bits)

    def init(self, params, n_workers: int = 1):
        return self.alpha_rule.init(params)

    def observe_update(self, state, dx_stats: DxStats):
        return self.alpha_rule.update(state, dx_stats)

    def _alphas(self, state, names, eta, n, dims: TreeDims):
        if self.blockwise:
            return self.alpha_rule.alpha_tree(
                state, eta, n, dims.leaf_dims, float(dims.d)
            )
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
        return (
            WireAggregate(words=words_sum, ints=int_sum),
            alphas,
            state,
            _wire_metrics(wf, int_sum),
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


@dataclasses.dataclass(frozen=True)
class IntDIANA(Compressor):
    """Algorithm 3: compress gradient differences against local shifts.

    State ``{"alpha": AlphaState, "h_local": {leaf: (n, *shape)},
    "h_global": {leaf: shape}}``. The local shift h_i is per worker: on one
    device it is one tensor per leaf with a leading worker axis, row w
    read and advanced by worker w. The global shift h is replicated.

    Wire-level split (fused_capable): ``aggregate_wire`` encodes the
    difference image Int(α(g_i − h_i)), advances h_i off that LOCAL image
    and reduces, without decoding or touching h. The decode
    ĝ = h + Σints/(nα) happens in ``aggregate`` or inside the fused kernel,
    which takes h as its ``shift`` and emits the new h (= ĝ) in the same
    pass (``fused_shift`` / ``fused_store_shift``).

    Memory: h_local costs n copies of the params, so ``aggregate_wire``
    advances it in place (the JAX package returns a new tree), and each
    leaf's g − h_i difference is freed as soon as it is encoded.
    """

    name: ClassVar[str] = "intdiana"
    fused_local_state: ClassVar[bool] = True  # h_local reads the local image
    alpha_rule: AlphaRule = AlphaDiana()
    bits: int = 32
    stochastic: bool = True
    wire: WireFormat | None = None

    @property
    def fused_capable(self) -> bool:  # type: ignore[override]
        return bool(getattr(self.wire_format, "fused_capable", True))

    @property
    def wire_format(self) -> WireFormat:
        return self.wire if self.wire is not None else DenseInt(bits=self.bits)

    def init(self, params, n_workers: int = 1):
        return {
            "alpha": self.alpha_rule.init(params),
            "h_local": {
                k: torch.zeros((n_workers, *p.shape), dtype=torch.float32, device=p.device)
                for k, p in params.items()
            },
            "h_global": {
                k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()
            },
        }

    def observe_update(self, state, dx_stats: DxStats):
        return dict(state, alpha=self.alpha_rule.update(state["alpha"], dx_stats))

    def _alphas(self, state, names, eta, n, dims: TreeDims):
        a = self.alpha_rule.alpha(state["alpha"], eta, n, dims.d)
        return {k: a for k in names}

    def encode_ints(self, state, grads: Tree, *, seeds: torch.Tensor, eta,
                    ctx: CommCtx, dims: TreeDims | None = None,
                    n_accum: int = 1):
        """One worker's difference image Int(α(g − h_i)) and the α dict.
        h_i is not advanced here (``aggregate_wire`` does it, off the same
        image)."""
        n = ctx.n
        w = ctx.worker_index()
        wf = self.wire_format
        dims = dims if dims is not None else local_tree_dims(grads)
        names = leaf_names(grads)
        alphas = self._alphas(state, names, eta, n, dims)
        row = seeds[w]
        h_local = state["h_local"]
        ints = {
            k: wf.encode(
                grads[k].to(torch.float32) - h_local[k][w], alphas[k], row[j],
                n_workers=n * n_accum, stochastic=self.stochastic,
            )
            for j, k in enumerate(names)
        }
        return ints, alphas

    def aggregate_wire(self, state, worker_grads: Iterable[Tree], *,
                       seeds: torch.Tensor, eta, ctx: CommCtx,
                       dims: TreeDims | None = None):
        """Encode each worker's difference image as its gradients arrive,
        advance that worker's h_i += Int(α(g_i − h_i))/α in place, sum the
        words, unpack once; no decode. Returns
        ``(WireAggregate, alphas, state, metrics)``."""
        wf = self.wire_format
        h_local = state["h_local"]
        alphas = {}

        def images():
            for w, grads in enumerate(worker_grads):
                ints, a = self.encode_ints(
                    state, grads, seeds=seeds, eta=eta, ctx=ctx.at_worker(w),
                    dims=dims,
                )
                alphas.update(a)
                del grads
                for k, s in ints.items():
                    h_local[k][w].add_(s.to(torch.float32) / a[k])
                yield ints
                del ints

        words_sum, int_sum = ctx.psum_wire(images(), wf)
        return (
            WireAggregate(words=words_sum, ints=int_sum),
            alphas,
            dict(state, h_local=h_local),
            _wire_metrics(wf, int_sum),
        )

    def aggregate(self, state, worker_grads: Iterable[Tree], *,
                  seeds: torch.Tensor, eta, ctx: CommCtx,
                  dims: TreeDims | None = None):
        """Decode-here wrapper: ĝ = h + Σints/(nα), which is also the new
        global shift. Returns ``(ghat, state, metrics)``."""
        wa, alphas, state, metrics = self.aggregate_wire(
            state, worker_grads, seeds=seeds, eta=eta, ctx=ctx, dims=dims
        )
        wf = self.wire_format
        h_global = {
            k: h + wf.decode(wa.ints[k], alphas[k], n_workers=ctx.n)
            for k, h in state["h_global"].items()
        }
        return h_global, dict(state, h_global=h_global), metrics

    def fused_shift(self, state):
        return state["h_global"]

    def fused_store_shift(self, state, new_shift):
        return dict(state, h_global=new_shift)


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
    "intsgd_determ": partial(IntSGD, stochastic=False),
    "intsgd_block": partial(IntSGD, alpha_rule=AlphaBlockwise()),
    "intsgd4": partial(IntSGD, bits=4),
    "intsgd8": partial(IntSGD, bits=8),
    "intsgd8_packed": partial(IntSGD, bits=8, wire=PackedInt(bits=8)),
    "intsgd4_packed": partial(IntSGD, bits=4, wire=PackedInt(bits=4)),
    "intdiana": IntDIANA,
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
