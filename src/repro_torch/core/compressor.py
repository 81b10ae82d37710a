"""Gradient compressors (port of ``repro/core/compressor.py``): the exact
mean, the uncompressed baseline, IntSGD with a global or blockwise α rule
(on a psum wire, or on a sparse gather wire with an EF21 residual),
IntDIANA, and the paper's baselines — Heuristic IntSGD, QSGD, NatSGD,
PowerSGD, SignSGD and TopK.

Interface, on the local n-worker backend or a process group
(:mod:`repro_torch.core.comm`)::

    init(params, n_local)                          -> state
    aggregate_wire(state, worker_grads, *, seeds, eta, ctx, dims)
        -> (WireAggregate, alphas, state, metrics)

``worker_grads`` yields the gradient dict of each of the context's local
workers (``ctx.local_workers()``: all n locally, the rank alone on a
group) in worker order; the JAX package runs the same per-worker code
under ``vmap``/``shard_map`` and sums inside the collective.

IntSGD's α depends on r_k, which depends on the model update of the
previous step: the trainer calls
``observe_update(state, dx_stats)`` after applying the step. The first step
is exact (paper §4.1 "the first communication is exact"): train steps use
:func:`aggregate_exact` at k = 0.

Microbatch pipelining (M > 1) encodes each microbatch's image with
``encode_ints(n_accum=M)``, sums the M summed images in int32 and decodes
them in ``finish_pipelined``. ``NoCompression`` (the uncompressed SGD
baseline) and the paper's baselines only have ``aggregate`` (none is
fused-capable, so they ride the ZeRO-1 route and accumulate microbatches in
f32); their per-worker error-feedback state is one tree per local worker,
``{leaf: (n_local, *shape)}`` float32, as IntDIANA's h_local.

Seeds: the encode's counter PRNG takes one int32 seed per (worker, leaf).
The JAX package derives them from its key (``fold_worker_key`` then one
split per leaf); the port takes them as an ``(n_workers, n_leaves)`` int32
tensor on the card, ``(M, n_workers, n_leaves)`` with M microbatches —
:func:`leaf_seeds` draws one from a ``torch.Generator``, and a test can
hand in the JAX package's own. QSGD's and NatSGD's uniforms, which the JAX
package draws from ``jax.random``, come from the same counter PRNG and
seeds (:func:`counter_uniform`), so they are the same on the CPU, on the
card and on a process group; their ``quantize(g, norm, u)`` and
``natural(g, u)`` take the uniforms as an argument, so a test can hand in
JAX's own.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from functools import partial
from typing import Any, ClassVar, Dict, Iterable

import torch

from repro_torch.core.comm import CommCtx
from repro_torch.core.scaling import (
    AlphaBlockwise, AlphaDiana, AlphaHeuristic, AlphaMovingAvg, AlphaRule,
)
from repro_torch.core.stats import DxStats, TreeDims, local_tree_dims
from repro_torch.kernels.prng import uniform_from_counter
from repro_torch.utils.tree import leaf_names, tree_abs_max
from repro_torch.wire import DenseInt, PackedInt, WireFormat, make_wire_format
from repro_torch.wire.topk import select_topk

Tree = Dict[str, torch.Tensor]


def aggregate_exact(worker_grads: Iterable[Tree], ctx: CommCtx) -> Tree:
    """Full-precision mean over workers (step-0 path), summed in worker
    order on a process group too: the step-0 update then matches the local
    backend bit for bit, and so does every later integer image."""
    return ctx.pmean(worker_grads, ordered=True)


def leaf_seeds(generator: torch.Generator, n_workers: int, n_leaves: int,
               device, microbatches: int = 1) -> torch.Tensor:
    """Independent int32 encode seeds per (worker, leaf), and per microbatch
    when there are several (a leading axis of ``microbatches``), drawn from
    ``generator`` on the host and placed on ``device``."""
    shape = (n_workers, n_leaves) if microbatches == 1 else (
        microbatches, n_workers, n_leaves)
    seeds = torch.randint(
        -(2**31), 2**31, shape, generator=generator, dtype=torch.int64,
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
    # max over the workers of the LOCAL payload |Int(α g_i)|∞: the per-worker
    # wire width, which blows up for IntGD on heterogeneous data and which
    # IntDIANA bounds (Appendix A.2 / Fig. 6); 0 for a float compressor
    max_local_int: torch.Tensor
    # the step's α per leaf (empty for a float compressor), so that a
    # decode-here caller can report it
    alphas: Tree = dataclasses.field(default_factory=dict)


def wire_bits(max_int: torch.Tensor) -> torch.Tensor:
    """Estimated wire bits per coordinate for a largest |integer|."""
    return 1.0 + torch.ceil(torch.log2(torch.clamp(max_int, min=1.0) + 1.0))


def new_peak(like: torch.Tensor) -> torch.Tensor:
    """A float32 0 on ``like``'s device for ``encode_ints(amax=...)`` to
    raise to one worker's |image|∞."""
    return torch.zeros((), dtype=torch.float32, device=like.device)


def max_over_workers(local_peaks, ctx: CommCtx) -> torch.Tensor:
    """The largest of this process's workers' values, and on a process
    group the largest over the ranks (``lax.pmax`` in the JAX package)."""
    peak = torch.stack(list(local_peaks)).max()
    return ctx.pmax([{"v": peak}])["v"]


# elements of one chunk of counter-PRNG uniforms: the plain fmix32's int64
# temporaries stay at 128 MiB each on a 117M-element leaf
UNIFORM_CHUNK = 1 << 24


def counter_uniform(shape, seed: torch.Tensor, device) -> torch.Tensor:
    """U[0, 1) float32 of ``shape``: the encode kernel's counter PRNG at the
    flat index under the int32 ``seed``, built in chunks."""
    numel = math.prod(shape)
    out = torch.empty(numel, dtype=torch.float32, device=device)
    for off in range(0, numel, UNIFORM_CHUNK):
        end = min(off + UNIFORM_CHUNK, numel)
        counter = torch.arange(off, end, dtype=torch.int64, device=device)
        out[off:end] = uniform_from_counter(counter, seed)
    return out.reshape(shape)


def _ef_zeros(params, n_workers: int) -> Tree:
    """One float32 error-feedback tree per local worker, stacked."""
    return {k: torch.zeros((n_workers, *p.shape), dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _float_metrics(device, bits: float, payload: float) -> Metrics:
    """A float compressor's metrics: no integer on the wire."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return Metrics(zero, torch.full((), float(bits), dtype=torch.float32, device=device),
                   float(payload), zero)


def _wire_metrics(wf: WireFormat, int_sum: Tree, alphas: Tree, max_local) -> Metrics:
    max_int = tree_abs_max(int_sum)
    payload = float(sum(wf.wire_bytes(v.numel()) for v in int_sum.values()))
    return Metrics(max_int, wire_bits(max_int), payload, max_local, alphas)


class Compressor:
    name: ClassVar[str] = "base"
    # whether the payload can be summed on the wire (False: all-gathered)
    supports_allreduce: ClassVar[bool] = True
    # the compressor half of the fused-route capability contract (the
    # optimizer half is Optimizer.fused_kernel)
    fused_capable: ClassVar[bool] = False
    # state that reads each worker's LOCAL integer image (IntDIANA's h_local)
    fused_local_state: ClassVar[bool] = False

    def init(self, params, n_workers: int = 1) -> Any:
        """Initial state for the ``n_workers`` workers this process runs
        (``CommCtx.n_local``: all n locally, 1 per rank on a group; only
        per-worker state, such as IntDIANA's h_local, depends on it)."""
        return ()

    def fused_shift(self, state):
        """The replicated global shift the fused decode adds (None: none)."""
        return None

    def fused_store_shift(self, state, new_shift):
        return state

    def observe_update(self, state, dx_stats: DxStats):
        return state


@dataclasses.dataclass(frozen=True)
class NoCompression(Compressor):
    """Full precision: the uncompressed SGD baseline. ``use_allgather``
    reproduces the paper's SGD (All-gather) row: the same mean, reached by
    gathering every worker's gradients."""

    name: ClassVar[str] = "none"
    use_allgather: bool = False

    def aggregate(self, state, worker_grads: Iterable[Tree], *, seeds=None,
                  eta=None, ctx: CommCtx, dims: TreeDims | None = None):
        """The float mean over workers. Returns ``(ghat, state, metrics)``."""
        if self.use_allgather:
            gathered = ctx.all_gather(worker_grads)
            ghat = {k: torch.mean(g.to(torch.float32), dim=0) for k, g in gathered.items()}
            del gathered
        else:
            ghat = ctx.pmean(worker_grads)
        d = sum(g.numel() for g in ghat.values())
        payload = 4.0 * d * (ctx.n if self.use_allgather else 1)
        device = next(iter(ghat.values())).device
        zero = torch.zeros((), dtype=torch.float32, device=device)
        m = Metrics(zero, torch.full((), 32.0, dtype=torch.float32, device=device),
                    payload, zero)
        return ghat, state, m


@dataclasses.dataclass(frozen=True)
class IntSGD(Compressor):
    """Algorithm 1 (global α) / Algorithm 2 (blockwise α: one α per leaf,
    ``alpha_rule=AlphaBlockwise()``). The transport is the ``wire`` codec;
    without one it is ``DenseInt(bits)``, one native lane per
    coordinate.

    A sparse (gather-transport) codec drops coordinates, so IntSGD then
    carries an EF21 error-feedback residual per worker: the state is
    ``{"alpha": AlphaState, "ef": {leaf: (n_local, *shape) f32}}``, each
    step encodes ``work = g + r`` and keeps ``r' = work − local_image/α``,
    what the wire dropped or rounded away. Psum codecs keep the bare
    AlphaState."""

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

    @property
    def _carries_residual(self) -> bool:
        return getattr(self.wire_format, "transport", "psum") == "gather"

    @staticmethod
    def _split_state(state):
        """State -> (alpha state, residual tree or None)."""
        if isinstance(state, dict) and set(state) == {"alpha", "ef"}:
            return state["alpha"], state["ef"]
        return state, None

    def init(self, params, n_workers: int = 1):
        alpha = self.alpha_rule.init(params)
        if self._carries_residual:
            return {"alpha": alpha, "ef": _ef_zeros(params, n_workers)}
        return alpha

    def observe_update(self, state, dx_stats: DxStats):
        alpha, ef = self._split_state(state)
        alpha = self.alpha_rule.update(alpha, dx_stats)
        return alpha if ef is None else {"alpha": alpha, "ef": ef}

    def _alphas(self, state, names, eta, n, dims: TreeDims):
        if self.blockwise:
            return self.alpha_rule.alpha_tree(
                state, eta, n, dims.leaf_dims, float(dims.d)
            )
        a = self.alpha_rule.alpha(state, eta, n, dims.d)
        return {k: a for k in names}

    def _encode(self, alpha_state, work: Tree, *, seeds, eta, ctx: CommCtx, dims,
                n_accum: int, amax):
        n = ctx.n
        wf = self.wire_format
        dims = dims if dims is not None else local_tree_dims(work)
        names = leaf_names(work)
        alphas = self._alphas(alpha_state, names, eta, n, dims)
        row = seeds[ctx.worker_index()]
        ints = {
            k: wf.encode(
                work[k], alphas[k], row[j], n_workers=n * n_accum,
                stochastic=self.stochastic, amax=amax,
            )
            for j, k in enumerate(names)
        }
        return ints, alphas

    def encode_ints(self, state, grads: Tree, *, seeds: torch.Tensor, eta,
                    ctx: CommCtx, dims: TreeDims | None = None,
                    n_accum: int = 1, amax: torch.Tensor | None = None):
        """One worker's §5.1-clipped integer image Int(α∘g) and the α dict,
        no wire traffic. Leaf j (in :func:`leaf_names` order) of worker w
        encodes with ``seeds[w, j]``. ``amax`` (:func:`new_peak`), if given,
        is raised to the image's |·|∞ by the encode itself. With a residual
        the encoded tensor is ``g + r`` (the residual's advance lives in
        ``aggregate_wire``)."""
        alpha_state, ef = self._split_state(state)
        work = grads
        if ef is not None:
            slot = ctx.local_slot(ctx.worker_index())
            work = {k: g.to(torch.float32) + ef[k][slot] for k, g in grads.items()}
        return self._encode(alpha_state, work, seeds=seeds, eta=eta, ctx=ctx, dims=dims,
                            n_accum=n_accum, amax=amax)

    def aggregate_wire(self, state, worker_grads: Iterable[Tree], *,
                       seeds: torch.Tensor, eta, ctx: CommCtx,
                       dims: TreeDims | None = None):
        """Encode each worker's gradients as they arrive, sum the packed
        words across workers (or gather a sparse codec's planes), unpack
        once; no decode (the fused kernel folds 1/(nα) into the optimizer
        step). With a residual, worker w's ``r_w`` becomes ``g + r_w`` in
        place, is encoded, and then loses ``local_image/α``. Returns
        ``(WireAggregate, alphas, state, metrics)``."""
        wf = self.wire_format
        alpha_state, ef = self._split_state(state)
        alphas, peaks = {}, []

        def images():
            for w, grads in zip(ctx.local_workers(), worker_grads):
                peaks.append(new_peak(seeds))
                wctx = ctx.at_worker(w)
                if ef is None:
                    ints, a = self.encode_ints(
                        state, grads, seeds=seeds, eta=eta, ctx=wctx, dims=dims,
                        amax=peaks[-1],
                    )
                else:
                    slot = ctx.local_slot(w)
                    for k, g in grads.items():
                        ef[k][slot].add_(g.to(torch.float32))  # r_w <- g + r_w
                    ints, a = self._encode(
                        alpha_state, {k: ef[k][slot] for k in grads}, seeds=seeds, eta=eta,
                        ctx=wctx, dims=dims, n_accum=1, amax=peaks[-1],
                    )
                    for k, v in ints.items():
                        ef[k][slot].sub_(
                            wf.local_image(v, n_workers=ctx.n).to(torch.float32) / a[k])
                alphas.update(a)
                del grads  # the caller's generator drops its reference too
                yield ints
                del ints  # before the next worker's backward runs

        words_sum, int_sum = ctx.psum_wire(images(), wf)
        return (
            WireAggregate(words=words_sum, ints=int_sum),
            alphas,
            state if ef is None else {"alpha": alpha_state, "ef": ef},
            _wire_metrics(wf, int_sum, alphas, max_over_workers(peaks, ctx)),
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

    def finish_pipelined(self, state, int_sum_acc: Tree, local_int_acc, alphas,
                         *, ctx: CommCtx, n_accum: int):
        """Decode the ``n_accum`` accumulated summed images of the
        microbatch-pipelined step: ĝ = Σ_m Σ_i Int(α g_i^m) / (n·M·α). The
        per-image clip (``encode_ints(n_accum=M)``) kept the int32 sum from
        wrapping. IntSGD keeps no wire-level state: ``local_int_acc`` is
        unused and the state passes through. Returns ``(ghat, state)``."""
        del local_int_acc
        wf = self.wire_format
        ghat = {
            k: wf.decode(s, alphas[k], n_workers=ctx.n * n_accum)
            for k, s in int_sum_acc.items()
        }
        return ghat, state


@dataclasses.dataclass(frozen=True)
class IntDIANA(Compressor):
    """Algorithm 3: compress gradient differences against local shifts.

    State ``{"alpha": AlphaState, "h_local": {leaf: (n_local, *shape)},
    "h_global": {leaf: shape}}``. The local shift h_i is per worker: one
    tensor per leaf with a leading axis over the workers this process runs,
    row ``ctx.local_slot(w)`` read and advanced by worker w (all n rows on
    the local backend, the rank's own row on a process group). The global
    shift h is replicated.

    Wire-level split (fused_capable): ``aggregate_wire`` encodes the
    difference image Int(α(g_i − h_i)), advances h_i off that LOCAL image
    and reduces, without decoding or touching h. The decode
    ĝ = h + Σints/(nα) happens in ``aggregate`` or inside the fused kernel,
    which takes h as its ``shift`` and emits the new h (= ĝ) in the same
    pass (``fused_shift`` / ``fused_store_shift``).

    Memory: h_local costs n_local copies of the params, so ``aggregate_wire``
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
                    n_accum: int = 1, amax: torch.Tensor | None = None):
        """One worker's difference image Int(α(g − h_i)) and the α dict.
        h_i is not advanced here (``aggregate_wire`` does it, off the same
        image). ``amax`` as for IntSGD."""
        n = ctx.n
        w = ctx.worker_index()
        slot = ctx.local_slot(w)
        wf = self.wire_format
        dims = dims if dims is not None else local_tree_dims(grads)
        names = leaf_names(grads)
        alphas = self._alphas(state, names, eta, n, dims)
        row = seeds[w]
        h_local = state["h_local"]
        ints = {
            k: wf.encode(
                grads[k].to(torch.float32) - h_local[k][slot], alphas[k], row[j],
                n_workers=n * n_accum, stochastic=self.stochastic, amax=amax,
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
        alphas, peaks = {}, []

        def images():
            for w, grads in zip(ctx.local_workers(), worker_grads):
                peaks.append(new_peak(seeds))
                ints, a = self.encode_ints(
                    state, grads, seeds=seeds, eta=eta, ctx=ctx.at_worker(w),
                    dims=dims, amax=peaks[-1],
                )
                alphas.update(a)
                del grads
                slot = ctx.local_slot(w)
                for k, s in ints.items():
                    h_local[k][slot].add_(s.to(torch.float32) / a[k])
                yield ints
                del ints

        words_sum, int_sum = ctx.psum_wire(images(), wf)
        return (
            WireAggregate(words=words_sum, ints=int_sum),
            alphas,
            dict(state, h_local=h_local),
            _wire_metrics(wf, int_sum, alphas, max_over_workers(peaks, ctx)),
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

    def finish_pipelined(self, state, int_sum_acc: Tree, local_int_acc: Tree,
                         alphas, *, ctx: CommCtx, n_accum: int):
        """Decode of the accumulated images and the shift advance:
        h_i += (Σ_m ints_i^m)/(M·α), off each local worker's integer sum
        ``local_int_acc`` ({leaf: (n_local, *shape)} integers, advanced in place as
        ``aggregate_wire`` does); mean_q = Σ_m Σ_i ints/(n·M·α);
        ĝ = h + mean_q, which is also the new global shift. Returns
        ``(ghat, state)``."""
        wf = self.wire_format
        h_local = state["h_local"]
        for k, s in local_int_acc.items():
            h_local[k].add_(s.to(torch.float32) / (n_accum * alphas[k]))
        h_global = {
            k: h + wf.decode(int_sum_acc[k], alphas[k], n_workers=ctx.n * n_accum)
            for k, h in state["h_global"].items()
        }
        return h_global, dict(state, h_local=h_local, h_global=h_global)

    def fused_shift(self, state):
        return state["h_global"]

    def fused_store_shift(self, state, new_shift):
        return dict(state, h_global=new_shift)


def _ordered_mean(ctx: CommCtx, values) -> torch.Tensor:
    """The float mean over the workers of one tensor each (this process's
    workers in order), summed in worker order on a process group too, so
    every rank gets the local backend's bits."""
    return ctx.pmean(({"v": v} for v in values), ordered=True)["v"]


@dataclasses.dataclass(frozen=True)
class HeuristicIntSGD(Compressor):
    """Heuristic IntSGD (Sapio et al. 2021; SwitchML's rule): a profiling
    max-reduce of every worker's |g|∞ before each round, then a fixed
    α = (2^(b-1)-1) / (n·2^⌈log2 max⌉) (``AlphaHeuristic``); the encode
    clips for the n-worker sum on every codec (rounding can nudge a value one
    past the α bound). Its local backend holds every local worker's
    gradients until the max is known."""

    name: ClassVar[str] = "heuristic_intsgd"
    bits: int = 8
    stochastic: bool = False
    wire: WireFormat | None = None

    @property
    def wire_format(self) -> WireFormat:
        return self.wire if self.wire is not None else DenseInt(bits=self.bits)

    def aggregate(self, state, worker_grads: Iterable[Tree], *, seeds: torch.Tensor, eta=None,
                  ctx: CommCtx, dims: TreeDims | None = None):
        """Returns ``(ghat, state, metrics)``; ``max_local_int`` is 0, as the
        JAX package reports it for this compressor."""
        n = ctx.n
        wf = self.wire_format
        held = list(worker_grads)
        # the profiling step: a float max-reduce before every round, the
        # overhead the paper's adaptive rule removes
        local_absmax = torch.stack([tree_abs_max(g) for g in held]).max()
        global_absmax = ctx.pmax_global([{"v": local_absmax}])["v"]
        alpha = AlphaHeuristic(bits=self.bits).alpha_from_absmax(global_absmax, n)
        names = leaf_names(held[0])

        def images():
            for i, w in enumerate(ctx.local_workers()):
                grads, held[i] = held[i], None  # freed as its image goes out
                row = seeds[w]
                ints = {k: wf.encode(grads[k], alpha, row[j], n_workers=n,
                                     stochastic=self.stochastic)
                        for j, k in enumerate(names)}
                del grads
                yield ints
                del ints

        _, int_sum = ctx.psum_wire(images(), wf)
        ghat = {k: wf.decode(v, alpha, n_workers=n) for k, v in int_sum.items()}
        zero = torch.zeros((), dtype=torch.float32, device=alpha.device)
        return ghat, state, _wire_metrics(wf, int_sum, {k: alpha for k in names}, zero)


def qsgd_norm(g: torch.Tensor) -> torch.Tensor:
    """‖g‖₂ + 1e-30 in float32, as √(Σ g²) (``jnp.linalg.norm``):
    ``torch.sum`` adds pairwise on the CPU too, where
    ``torch.linalg.vector_norm`` accumulates in sequence and comes out
    1.2 % low at 117M elements."""
    return torch.sqrt(torch.sum(torch.square(g.to(torch.float32)))) + 1e-30


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """QSGD (Alistarh et al. 2017), all-gather only. Each leaf's levels
    q = ⌊|g|/‖g‖·s⌋ + [u < frac] travel with the signs and the norm. With
    ``wire=None`` as the paper has it, one int8 level lane and one int8 sign
    lane per coordinate; with a psum-shaped codec the signed level
    v = sign·q rides the codec's words, packed with ``n_workers=1`` (a
    gather: no sum crosses the wire)."""

    name: ClassVar[str] = "qsgd"
    supports_allreduce: ClassVar[bool] = False
    levels: int = 64  # 6-bit, the paper's setup
    wire: WireFormat | None = None

    def quantize(self, g: torch.Tensor, norm: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """The float32 levels of ``g`` given its norm and the uniforms."""
        scaled = torch.abs(g.to(torch.float32)) / norm * self.levels
        lo = torch.floor(scaled)
        return lo + (u < scaled - lo).to(torch.float32)

    @property
    def bits_per_coord(self) -> float:
        """Wire bits per coordinate: level field + sign."""
        return 1.0 + math.ceil(math.log2(self.levels + 1))

    def _check_wire(self) -> None:
        wf = self.wire
        if getattr(wf, "transport", "psum") == "gather":
            raise ValueError(
                "QSGD's gathered level payload needs a psum-shaped (dense/packed) "
                f"codec; a gather-transport codec like {wf.name!r} cannot carry it"
            )
        if wf.clip_limit(1) < self.levels:
            raise ValueError(f"wire bits={wf.bits} too narrow for {self.levels} levels")

    def aggregate(self, state, worker_grads: Iterable[Tree], *, seeds: torch.Tensor, eta=None,
                  ctx: CommCtx, dims: TreeDims | None = None):
        wf = self.wire
        if wf is not None:
            self._check_wire()
        encs, shapes = [], {}
        for w, grads in zip(ctx.local_workers(), worker_grads):
            row = seeds[w]
            enc = {}
            for j, k in enumerate(leaf_names(grads)):
                g = grads[k].to(torch.float32)
                shapes[k] = tuple(g.shape)
                norm = qsgd_norm(g)
                q = self.quantize(g, norm, counter_uniform(g.shape, row[j], g.device))
                if wf is None:
                    enc[k] = {"q": q.to(torch.int8), "s": torch.sign(g).to(torch.int8)}
                else:
                    v = (q * torch.sign(g)).to(torch.int32)
                    enc[k] = {"words": wf.pack(v, n_workers=1)}
                enc[k]["norm"] = norm.reshape(1)
                del g, q
            encs.append(enc)
            del grads
        ghat = {}
        for k, shape in shapes.items():
            gathered = ctx.all_gather(enc.pop(k) for enc in encs)  # (n, ...) per plane

            def decoded(gathered=gathered, shape=shape):
                for i in range(ctx.n):
                    if wf is None:
                        vals = (gathered["q"][i].to(torch.float32)
                                * gathered["s"][i].to(torch.float32))
                    else:
                        vals = wf.unpack(gathered["words"][i], shape,
                                         n_summed=1).to(torch.float32)
                    yield vals * (gathered["norm"][i].reshape(()) / self.levels)

            ghat[k] = _sum_in_order(decoded()) / ctx.n
            del gathered
        d = sum(math.prod(s) for s in shapes.values())
        if wf is None:  # entropy-coded estimate: level bits + sign bit + norms
            payload = d * (self.bits_per_coord + 2.0) / 8.0
        else:
            payload = sum(wf.wire_bytes(math.prod(s)) for s in shapes.values()) + 4.0 * len(shapes)
        return ghat, state, _float_metrics(_device_of(ghat), self.bits_per_coord, payload)


def _sum_in_order(parts) -> torch.Tensor:
    """Σ parts, added left to right (worker order), one part alive at a
    time beside the sum."""
    parts = iter(parts)
    acc = next(parts).clone()
    for p in parts:
        acc.add_(p)
    return acc


def _device_of(tree: Tree) -> torch.device:
    return next(iter(tree.values())).device


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """2^e in float32, exactly, for integer e in [-126, 127]: built from
    the exponent bits (no libm exp2, whose rounding differs between
    libraries)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class NatSGD(Compressor):
    """Natural compression (Horváth et al. 2019), all-gather only: each
    coordinate rounds its magnitude to one of the two neighbouring powers of
    two, unbiased; int8 exponent and sign lanes travel, decoded as
    2^e·sign."""

    name: ClassVar[str] = "natsgd"
    supports_allreduce: ClassVar[bool] = False

    def natural(self, g: torch.Tensor, u: torch.Tensor):
        """(int8 exponents, int8 signs) of ``g`` given the uniforms. The JAX
        package takes ⌊log2 max(|g|, 1e-38)⌋ and |g|/2^e − 1; here both come
        exactly from ``frexp`` (|g| = m·2^x, m in [0.5, 1): ⌊log2 |g|⌋ = x − 1
        and |g|/2^(x−1) − 1 = 2m − 1), which no libm log2 can round across a
        power of two. Below 2^-126 (subnormal magnitudes and 0) every path
        ends at the clip, −126."""
        g = g.to(torch.float32)
        mag = torch.abs(g)
        m, x = torch.frexp(mag)
        e_lo = (x - 1).to(torch.float32)
        p_up = 2.0 * m - 1.0  # prob of rounding the exponent up
        e = e_lo + (u < p_up).to(torch.float32)
        e = torch.where(mag == 0, torch.full_like(e, -127.0), e)
        return torch.clamp(e, -126.0, 126.0).to(torch.int8), torch.sign(g).to(torch.int8)

    @staticmethod
    def decode_natural(e: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """2^e·sign (e is clipped to [-126, 126]: never the JAX decode's
        zero branch, e <= -127)."""
        return exp2_int(e) * s.to(torch.float32)

    def aggregate(self, state, worker_grads: Iterable[Tree], *, seeds: torch.Tensor, eta=None,
                  ctx: CommCtx, dims: TreeDims | None = None):
        encs, names = [], None
        for w, grads in zip(ctx.local_workers(), worker_grads):
            row = seeds[w]
            names = leaf_names(grads)
            enc = {}
            for j, k in enumerate(names):
                g = grads[k]
                e, sg = self.natural(g, counter_uniform(g.shape, row[j], g.device))
                enc[k] = {"e": e, "s": sg}
            encs.append(enc)
            del grads
        ghat = {}
        for k in names:
            gathered = ctx.all_gather(enc.pop(k) for enc in encs)
            ghat[k] = _sum_in_order(self.decode_natural(gathered["e"][i], gathered["s"][i])
                                    for i in range(ctx.n)) / ctx.n
            del gathered
        d = sum(v.numel() for v in ghat.values())
        return ghat, state, _float_metrics(_device_of(ghat), 9.0, d * 1.125)


def initial_q(shape2d, rank: int) -> torch.Tensor:
    """PowerSGD's initial Q for a matrix of ``shape2d`` (rows, cols):
    (cols, rank) standard normals on the host, from a generator seeded by a
    stable hash of the shape, so every process draws the same Q. (The JAX
    package seeds it from Python's per-process salted ``hash``.)"""
    seed = zlib.crc32(str(tuple(int(s) for s in shape2d)).encode()) % (2**31)
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((int(shape2d[1]), rank), generator=gen, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class PowerSGD(Compressor):
    """PowerSGD (Vogels et al. 2019) with error feedback, all-reduce
    compatible. A leaf of ndim >= 2 and at least ``min_compress_size``
    elements is viewed as M = x.reshape(x.shape[0], -1), as in the JAX
    package (a stacked (L, rows, cols) layer leaf is an L-row matrix, which
    rank >= L sends exactly); one power step: P = mean_i M_i·Q,
    P̂ = QR(P).Q, Qn = mean_i M_iᵀ·P̂, approximation P̂·Qnᵀ, Qn the next Q.
    Smaller leaves are sent as a float mean. The means are summed in worker
    order on every backend. State ``{"q": {leaf: (cols, rank)}
    (replicated over the workers), "err": {leaf: (n_local, *shape)} f32 or
    None}``; at tp > 1 each rank's Q is its shard's (:meth:`q_model_dim`). The
    local backend holds each local worker's g + e (in the error-feedback
    tree itself) for the second pass."""

    name: ClassVar[str] = "powersgd"
    rank: int = 2
    ef: bool = True
    min_compress_size: int = 4096  # small tensors stay uncompressed

    def compresses(self, shape) -> bool:
        """Whether a leaf of ``shape`` is sent as a rank-``rank`` product."""
        return len(shape) >= 2 and math.prod(shape) >= self.min_compress_size

    def _is_matrix(self, x: torch.Tensor) -> bool:
        return self.compresses(x.shape)

    @staticmethod
    def q_model_dim(param_spec):
        """The dimension of Q (cols, rank) that the model axis shards, for
        a param sharded on ``param_spec`` (None: replicated): 0 when the
        param is sharded past its rows, so each shard has its own cols;
        else None (the JAX package's ``_comp_state_shapes`` compares the
        global and the local Q). A param sharded on its rows has a Q of the
        same shape on every shard, which the JAX package's spec calls
        replicated, yet each shard's next Q is its own M_localᵀ·P̂_local."""
        return 0 if param_spec is not None and param_spec >= 1 else None

    def init(self, params, n_workers: int = 1):
        q = {k: initial_q((p.shape[0], p.numel() // p.shape[0]), self.rank).to(p.device)
             for k, p in params.items() if self._is_matrix(p)}
        return {"q": q, "err": _ef_zeros(params, n_workers) if self.ef else None}

    def aggregate(self, state, worker_grads: Iterable[Tree], *, seeds=None, eta=None,
                  ctx: CommCtx, dims: TreeDims | None = None):
        err = state["err"]
        works = []
        for w, grads in zip(ctx.local_workers(), worker_grads):
            if self.ef:
                slot = ctx.local_slot(w)
                for k, g in grads.items():
                    err[k][slot].add_(g.to(torch.float32))  # e_w <- g + e_w
                works.append({k: err[k][slot] for k in grads})
            else:
                works.append({k: g.to(torch.float32) for k, g in grads.items()})
            del grads
        ghat, new_q = {}, dict(state["q"])
        for k in leaf_names(works[0]):
            ms = [wk[k] for wk in works]
            if k in state["q"]:
                m2s = [m.reshape(m.shape[0], -1) for m in ms]
                p = _ordered_mean(ctx, (m2 @ state["q"][k] for m2 in m2s))
                p_hat = torch.linalg.qr(p, mode="reduced").Q
                qn = _ordered_mean(ctx, (m2.T @ p_hat for m2 in m2s))
                ghat[k] = (p_hat @ qn.T).reshape(ms[0].shape)
                new_q[k] = qn
            else:
                ghat[k] = _ordered_mean(ctx, ms)
            if self.ef:
                for m in ms:  # e_w' = w - ĝ (0 where sent uncompressed)
                    if k in state["q"]:
                        m.sub_(ghat[k])
                    else:
                        m.zero_()
        d = sum(v.numel() for v in ghat.values())
        return (ghat, {"q": new_q, "err": err},
                _float_metrics(_device_of(ghat), 32.0, 4.0 * d * 0.05))


@dataclasses.dataclass(frozen=True)
class SignSGD(Compressor):
    """Scaled SignSGD with error feedback (Karimireddy et al. 2019): worker
    i sends C(w_i) = ‖w_i‖₁/d · sign(w_i), w_i = g_i + e_i; ĝ is the mean
    of the C(w_i), summed in worker order; e_i' = w_i − C(w_i). State: the
    error-feedback tree ``{leaf: (n_local, *shape)}`` f32, or () without
    ``ef``."""

    name: ClassVar[str] = "signsgd"
    ef: bool = True

    def init(self, params, n_workers: int = 1):
        return _ef_zeros(params, n_workers) if self.ef else ()

    def aggregate(self, state, worker_grads: Iterable[Tree], *, seeds=None, eta=None,
                  ctx: CommCtx, dims: TreeDims | None = None):
        def sent():
            for w, grads in zip(ctx.local_workers(), worker_grads):
                slot = ctx.local_slot(w)
                out = {}
                for k, g in grads.items():
                    w32 = g.to(torch.float32)
                    if self.ef:
                        w32 = w32 + state[k][slot]
                    scale = torch.mean(torch.abs(w32))  # ||w||_1 / d
                    out[k] = scale * torch.sign(w32).to(torch.int8).to(torch.float32)
                    if self.ef:
                        torch.sub(w32, out[k], out=state[k][slot])
                    del w32
                del grads
                yield out
                del out

        ghat = ctx.pmean(sent(), ordered=True)
        d = sum(v.numel() for v in ghat.values())
        return ghat, state, _float_metrics(_device_of(ghat), 1.0, d / 8.0)


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Top-k sparsification with error feedback, all-gather of values and
    indices. Per leaf k = max(1, int(k_frac·d_l)) coordinates of the
    largest |w_i| (w_i = g_i + e_i), ties to the lower index
    (:func:`~repro_torch.wire.topk.select_topk`); the decode adds every
    worker's values at its indices, one worker after another (float
    addition in worker order, whatever the device), then divides by n;
    e_i' = w_i with the sent coordinates zeroed. State as SignSGD's."""

    name: ClassVar[str] = "topk"
    supports_allreduce: ClassVar[bool] = False
    k_frac: float = 0.01
    ef: bool = True

    def init(self, params, n_workers: int = 1):
        return _ef_zeros(params, n_workers) if self.ef else ()

    def select(self, w: torch.Tensor):
        """(int64 indices, float32 values) of one worker's leaf."""
        flat = w.reshape(-1)
        idx = select_topk(torch.abs(flat), max(1, int(self.k_frac * flat.numel())))
        return idx, flat[idx]

    def aggregate(self, state, worker_grads: Iterable[Tree], *, seeds=None, eta=None,
                  ctx: CommCtx, dims: TreeDims | None = None):
        sent, shapes = [], {}
        for w, grads in zip(ctx.local_workers(), worker_grads):
            slot = ctx.local_slot(w)
            out = {}
            for k, g in grads.items():
                shapes[k] = tuple(g.shape)
                w32 = g.to(torch.float32)
                if self.ef:
                    w32 = state[k][slot].add_(w32)  # e_w <- g + e_w
                idx, vals = self.select(w32)
                out[k] = {"idx": idx.to(torch.int32), "vals": vals}
                if self.ef:  # e_w' = w - C(w): the sent coordinates zeroed
                    w32.view(-1)[idx] = 0.0
            sent.append(out)
            del grads
        ghat = {}
        for k in leaf_names(shapes):
            gathered = ctx.all_gather(out.pop(k) for out in sent)  # (n, k_l) planes
            acc = torch.zeros(math.prod(shapes[k]), dtype=torch.float32,
                              device=gathered["vals"].device)
            for i in range(ctx.n):
                acc.index_add_(0, gathered["idx"][i].to(torch.int64), gathered["vals"][i])
            ghat[k] = (acc / ctx.n).reshape(shapes[k])
            del gathered, acc
        d = sum(math.prod(s) for s in shapes.values())
        return ghat, state, _float_metrics(_device_of(ghat), 32.0 * self.k_frac * 2,
                                           8.0 * d * self.k_frac)


def with_wire(comp: Compressor, wire) -> Compressor:
    """Rebind a compressor to a wire codec (name string or WireFormat)."""
    wire = make_wire_format(wire)
    fields = {f.name for f in dataclasses.fields(comp)}
    if "wire" not in fields:
        raise ValueError(
            f"compressor {comp.name!r} has no wire-codec seam (only the "
            "integer-wire families are codec-configurable)"
        )
    if "bits" in fields and comp.bits != wire.bits:
        # the codec's width wins in encode(); a silent mismatch would train
        # another recipe than the compressor's name says
        raise ValueError(
            f"wire codec is {wire.bits}-bit but compressor {comp.name!r} "
            f"was built with bits={comp.bits}; construct them consistently "
            f"(e.g. make_compressor('{comp.name}', bits={wire.bits}, wire=...))"
        )
    return dataclasses.replace(comp, wire=wire)


_COMPRESSORS = {
    "none": NoCompression,
    "allgather_sgd": partial(NoCompression, use_allgather=True),
    "intsgd": IntSGD,
    "intsgd_determ": partial(IntSGD, stochastic=False),
    "intsgd_block": partial(IntSGD, alpha_rule=AlphaBlockwise()),
    "intsgd4": partial(IntSGD, bits=4),
    "intsgd8": partial(IntSGD, bits=8),
    "intsgd8_packed": partial(IntSGD, bits=8, wire=PackedInt(bits=8)),
    "intsgd4_packed": partial(IntSGD, bits=4, wire=PackedInt(bits=4)),
    "heuristic_intsgd": HeuristicIntSGD,
    "qsgd": QSGD,
    "natsgd": NatSGD,
    "powersgd": PowerSGD,
    "signsgd": SignSGD,
    "topk": TopK,
    "intdiana": IntDIANA,
}


def compressor_names() -> list:
    return sorted(_COMPRESSORS)


def make_compressor(name: str, **kw) -> Compressor:
    if name not in _COMPRESSORS:
        raise ValueError(f"unknown compressor {name!r}; options {sorted(_COMPRESSORS)}")
    if kw.get("wire") is not None:
        kw = dict(kw)
        wire = kw.pop("wire")
        return with_wire(_COMPRESSORS[name](**kw), wire)  # bits checked
    return _COMPRESSORS[name](**kw)
