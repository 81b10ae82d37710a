"""Train and serve step construction (port of ``repro/launch/step.py``;
the serve step, :func:`build_serve_step`, at the end): the fused
route and the ZeRO-1 route, with microbatch wire pipelining on the latter,
on the local n-worker backend (one process runs the n workers in turn) or
on a ``torch.distributed`` process group (one process per worker; every
rank runs the same step for its one worker, and everything after the sums
is identical on every rank).

One step, as the JAX package's ``_make_train_body`` runs it:

  1. for each of this process's workers in turn: forward and backward on
     that worker's slice of the global batch (bf16 activations; bf16 params
     by default, or f32 with ``param_dtype``); on the compressed steps its
     gradients (IntDIANA: minus its local shift) are encoded Int(α∘g) and
     packed into transport words at once and freed, the words folding into
     the word sum with the wire type's wrap-around
     (``Compressor.aggregate_wire``); step 0 is exact (paper §4.1) and sums
     float gradients instead. With M > 1
     microbatches on the ZeRO-1 route each microbatch m runs the workers
     in turn, encodes each image clipped for the n·M sum, reduces it (the
     reduce waited on after the next microbatch's backward) and adds the
     summed image to an int32 accumulator
     (``_pipelined_grad_stage``); a compressor without wire-level
     aggregation (``none``) and the exact step average the M microbatch
     gradients in f32 first (``_accum_grad_stage``);
  2. the global-norm clip factor: on the fused route off the summed integer
     image (plus the global shift for IntDIANA), so ĝ is never
     materialized; on the ZeRO-1 route off the decoded ĝ. Each leaf's sum
     of squares is the block-norms kernel's (but IntDIANA's shift form);
  3. the update: on the fused route the fused decode + optimizer kernel per
     leaf — SGD or AdamW, packed words or dense lanes, with IntDIANA's shift
     in and out — straight off the summed payload (``_fused_update_stage``;
     step 0 runs the same arithmetic unfused); on the ZeRO-1 route the
     decoded ĝ goes through the optimizer on the f32 master rows and the
     new rows are gathered back to the params (``optim.zero1``);
  4. ||Δx_l||² (the block-norms kernel, per leaf) × dx_scale² fed back to
     the α rule (``_observe_dx``): the global rules read the sum, blockwise
     α (Alg. 2) each leaf's.

α, η, the clip factor and the kernels' scalar vectors stay on the card: the
step makes no host sync. ``overlap="ring"`` sends the integer wire in
buckets (:mod:`repro_torch.wire.bucketing`).

Tensor parallelism (``grid=``, a data × model grid of ranks from
``launch/mesh.py``; every family): each rank holds its shard of
the params over the model axis (``launch/specs.py``) and runs the step on
it; the data group carries the integer wire, the ZeRO-1 rows and the
loss's mean, exactly as on a plain group of n_dp ranks. The gradient
follows the JAX package's convention: the model's ``psum_tp`` sums its
cotangents in the backward pass as well, and the replicated leaves'
partial gradients are summed over the model group
(``_fix_replicated_grads``), so every gradient is tp times the tp = 1 one
(ROADMAP's reference behaviours). ||·||² of a sharded leaf (the clip
factor, ||Δx_l||² for α) is summed over the model group, a replicated
leaf's counted once (``_global_reduce_leaf_sq``); α's d and each d_l are
the global padded counts (``specs.global_tree_dims``); max_int and the
bit width are maxed over the model group. Every compressor runs at
tp > 1, as in the JAX package's TP step, on the rank's shards with the
data group as its workers: QSGD's norm and SignSGD's scale are the
shard's own, TopK keeps k of each shard, IntSGD on a gather wire selects
K within each shard, and PowerSGD's Q is the shard's own (cols, rank).
PowerSGD refuses to build where the JAX package's step fails
(``_check_tp_compressor``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.comm import CommCtx
from repro_torch.core.compressor import (
    Compressor, PowerSGD, aggregate_exact, max_over_workers, new_peak, wire_bits, with_wire,
)
from repro_torch.core.stats import DxStats, TreeDims, local_dx_stats, scale_dx_stats
from repro_torch.kernels import ops
from repro_torch.launch import specs as specs_mod
from repro_torch.models import encdec
from repro_torch.models.common import SINGLE, Axes
from repro_torch.models.decode import init_lm_cache, lm_decode_step, tp_greedy
from repro_torch.models.transformer import lm_forward, lm_logits, lm_loss
from repro_torch.optim import base as optb
from repro_torch.optim.base import Optimizer
from repro_torch.optim.zero1 import zero1_init, zero1_update
from repro_torch.parallel import collectives as coll
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import leaf_names, tree_abs_max
from repro_torch.wire import WireTransportError, bucketing

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Layout:
    """What every stage of the step shares: config, the workers' context,
    the model's dimensionality (α's d and each leaf's d_l) and leaf order,
    the device."""

    cfg: ModelConfig
    ctx: CommCtx
    dims: TreeDims
    names: tuple  # leaf names in jax.tree.flatten order
    device: torch.device
    # the model axis: its size, the model code's handle on it, and the
    # leaves every rank of a model group holds whole (the JAX package's
    # rep_mask), as a bool vector in ``names`` order on the device
    tp: int = 1
    axes: Axes = SINGLE
    rep: frozenset = frozenset()
    rep_mask: Optional[torch.Tensor] = None
    # each local leaf's element count, in ``names`` order (the integer image
    # the codec packs: the static audit's transport declaration)
    leaf_sizes: tuple = ()


@dataclasses.dataclass(frozen=True)
class StepArtifacts:
    steps: Dict[str, Callable]  # "exact" (step 0) and "compressed"
    layout: Layout
    # the wire contract the static auditor proves a recorded step against
    # (``analysis.wire_audit.WireSpec``; None for the float-wire baselines)
    audit_spec: Any = None
    # which -> (the step built on the meta device, its meta arguments): what
    # ``verify="static"`` records
    meta_step: Optional[Callable] = None
    # the passing ``analysis.schedule.FullReport`` of ``verify="static"``
    static_report: Any = None


def _loss_fn_for(cfg: ModelConfig):
    return encdec.encdec_loss if cfg.family == "encdec" else lm_loss


def _forward_backward(layout: Layout, params: Tree, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    kw = {} if layout.tp == 1 else {"axes": layout.axes}
    loss = _loss_fn_for(layout.cfg)(leaves, batch, layout.cfg, dtype=torch.bfloat16, **kw)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    if layout.tp > 1:
        grads.update(_fix_replicated_grads(layout, grads))
    return loss.detach(), grads


def _fix_replicated_grads(layout: Layout, grads: Tree) -> Tree:
    """The replicated leaves' gradients, each rank's partial one summed over
    the model group (the JAX package's ``_fix_replicated_grads``)."""
    return coll.psum_tp_tree({k: grads[k] for k in layout.names if k in layout.rep},
                             layout.axes.group)


def _global_reduce_leaf_sq(layout: Layout, leaf_sq: Dict[str, torch.Tensor]) -> DxStats:
    """Per-leaf ||·||² of the local shards -> the global values and their
    sum: at tp > 1 one all-reduce over the model group of the stacked
    sharded leaves' values, the replicated ones added once (the JAX
    package's ``_global_reduce_leaf_sq``); at tp = 1 the sum of the
    values as they come."""
    if layout.tp == 1:
        return DxStats(sq=torch.sum(torch.stack(list(leaf_sq.values()))), leaf_sq=leaf_sq)
    vec = torch.stack([leaf_sq[k] for k in layout.names])
    zero = torch.zeros((), dtype=vec.dtype, device=vec.device)
    sharded = coll.psum_tp_tree({"v": torch.where(layout.rep_mask, zero, vec)},
                                layout.axes.group)["v"]
    vec = sharded + torch.where(layout.rep_mask, vec, zero)
    return DxStats(sq=torch.sum(vec), leaf_sq=dict(zip(layout.names, vec.unbind(0))))


def _microbatch(batch, m: int, n_micro: int):
    """Slice m of n_micro along the batch dim of every leaf: worker w's
    contiguous slice of the global batch (the JAX package shards the batch
    dimension over the data-parallel axis), or microbatch m of a worker's."""
    def one(v):
        b = v.shape[0] // n_micro
        return v[m * b:(m + 1) * b]

    return {k: one(v) for k, v in batch.items()}


def _accum_grad_stage(layout: Layout, params: Tree, batch, n_micro: int):
    """Plain gradient accumulation of one worker (the exact step, and
    compressors without wire-level aggregation): the mean of the microbatch
    gradients in f32, aggregated once afterwards."""
    loss_acc = g_acc = None
    for m in range(n_micro):
        loss_m, grads_m = _forward_backward(layout, params, _microbatch(batch, m, n_micro))
        if g_acc is None:
            loss_acc = loss_m
            g_acc = {k: g.to(torch.float32) for k, g in grads_m.items()}
        else:
            loss_acc = loss_acc + loss_m
            for k, g in grads_m.items():
                g_acc[k].add_(g.to(torch.float32))
        del grads_m
    return loss_acc / n_micro, {k: g / n_micro for k, g in g_acc.items()}


_INT_OF_WIDTH = {8: torch.int8, 16: torch.int16, 32: torch.int32}


def _pipelined_grad_stage(layout: Layout, compressor: Compressor, cs, params: Tree,
                          batch, seeds: torch.Tensor, eta, n_micro: int):
    """Microbatch wire pipelining: for each microbatch m, the local workers
    in turn, each image Int(α g_i^m) clipped for the full n·M accumulated
    sum (``encode_ints(n_accum=M)``, so the int32 accumulator cannot wrap)
    and packed as soon as its backward ends; microbatch m's reduce is
    issued then and waited on only after microbatch m+1's backward passes
    (on a process group the transfer runs behind them), then its summed
    image is unpacked and added to the accumulator, in microbatch order.
    The M summed images add exactly, so

        ĝ = Σ_m Σ_i Int(α g_i^m) / (n·M·α)

    (``compressor.finish_pipelined``, which also advances the compressor's
    state; IntDIANA's h_i reads each local worker's integer sum, kept here
    in the wire width's integer type when ``fused_local_state`` is set).
    ``seeds`` is (M, n, n_leaves). Returns ``(ghat, state, loss, max_int,
    max_local_int, alphas)``; max_int is the largest |summed image| of one
    microbatch, what one reduce carried, and max_local_int the largest
    |image| one worker sent."""
    ctx = layout.ctx
    n = ctx.n
    wf = compressor.wire_format
    track_local = compressor.fused_local_state
    # a worker's local sum over the M images is within ±(2^(bits-1)-1)//n
    # (each image is clipped for the n·M sum), so the narrowest signed type
    # of the wire's width holds it exactly
    acc_dtype = _INT_OF_WIDTH[min(b for b in _INT_OF_WIDTH if b >= wf.bits)]
    worker_loss = {}
    local_acc, alphas, peaks = {}, {}, []
    acc = {"ints": None, "max_int": None}

    def images(m):
        for w in ctx.local_workers():
            loss_m, grads = _forward_backward(
                layout, params, _microbatch(_microbatch(batch, w, n), m, n_micro)
            )
            worker_loss[w] = loss_m if m == 0 else worker_loss[w] + loss_m
            peaks.append(new_peak(seeds))
            ints, a = compressor.encode_ints(
                cs, grads, seeds=seeds[m], eta=eta, ctx=ctx.at_worker(w),
                dims=layout.dims, n_accum=n_micro, amax=peaks[-1],
            )
            alphas.update(a)
            del grads
            if track_local:
                slot = ctx.local_slot(w)
                for k, v in ints.items():
                    if k not in local_acc:
                        local_acc[k] = torch.zeros((ctx.n_local, *v.shape), dtype=acc_dtype,
                                                   device=v.device)
                    local_acc[k][slot].add_(v.to(acc_dtype))
            yield ints
            del ints

    def fold(reduced):
        _, int_sum = reduced
        peak = tree_abs_max(int_sum)
        acc["max_int"] = peak if acc["max_int"] is None else torch.maximum(acc["max_int"], peak)
        if acc["ints"] is None:
            acc["ints"] = int_sum
        else:
            for k, v in int_sum.items():
                acc["ints"][k].add_(v)

    pending = None
    for m in range(n_micro):
        issued = ctx.psum_wire_start(images(m), wf)  # microbatch m's backward runs here
        if pending is not None:
            fold(pending.wait())
        pending = issued
    fold(pending.wait())
    ghat, cs = compressor.finish_pipelined(
        cs, acc["ints"], local_acc if track_local else None, alphas, ctx=ctx,
        n_accum=n_micro,
    )
    loss = ctx.mean_scalars(worker_loss[w] / n_micro for w in ctx.local_workers())
    return ghat, cs, loss, acc["max_int"], max_over_workers(peaks, ctx), alphas


def _fused_plan(base_opt: Optimizer, compressor: Compressor) -> str:
    """Validate the (compressor × optimizer) pair against the fused-route
    capability contract and return the kernel name."""
    if not getattr(compressor, "fused_capable", False):
        wf = getattr(compressor, "wire_format", None)
        if wf is not None and not getattr(wf, "fused_capable", True):
            raise ValueError(
                "fused update routing consumes the summed transport words "
                f"directly, but wire codec {wf.name!r} has no fused "
                "decode+update kernel (WireFormat.fused_capable): its "
                f"gather-transport payload (planes "
                f"{getattr(wf, 'plane_names', ())!r}) needs a scatter-shaped "
                "decode — use a psum-transport codec (dense/packed) or "
                "fused=False"
            )
        raise ValueError(
            "fused update routing consumes the summed transport words "
            "directly, which needs wire-level aggregation "
            f"(Compressor.fused_capable); compressor {compressor.name!r} "
            "does not advertise it — use an integer-wire compressor or "
            "fused=False"
        )
    if base_opt.fused_kernel is None or base_opt.hyper is None:
        raise ValueError(
            "fused update routing needs an optimizer exposing a fused "
            "decode+update kernel (Optimizer.fused_kernel); "
            f"kind={base_opt.kind!r} advertises none — use optim.sgd "
            "(heavy-ball) or optim.adamw"
        )
    return base_opt.fused_kernel


def _clip_factor(layout: Layout, clip_norm: float, *, ghat=None, int_sum=None,
                 alphas=None, shift=None) -> torch.Tensor:
    """Global-norm clip factor min(1, c/||ĝ||). On the fused route ||ĝ||² is
    computed off the summed image (||ĝ_l||² = ||Σints_l||²/(nα_l)², or
    Σ (h + Σints_l/(nα_l))² with IntDIANA's global shift h — a division,
    as in the JAX package, where the kernel multiplies by 1/(nα)), so ĝ is
    never materialized. ||Σints_l||² and the exact step's ||ĝ_l||² are the
    block-norms kernel's (int32 and float32 read in place); the shift form
    is another function and stays plain PyTorch. Sums run in another order
    than XLA's: the factor agrees with the JAX package to about 1e-6
    relative."""
    n = layout.ctx.n
    if int_sum is not None and shift is None:
        leaf_sq = {
            k: ops.sq_norm(s) / torch.square(n * alphas[k]) for k, s in int_sum.items()
        }
    elif int_sum is not None:
        leaf_sq = {
            k: torch.sum(torch.square(shift[k] + s.to(torch.float32) / (n * alphas[k])))
            for k, s in int_sum.items()
        }
    else:
        leaf_sq = {k: ops.sq_norm(g) for k, g in ghat.items()}
    norm = torch.sqrt(_global_reduce_leaf_sq(layout, leaf_sq).sq) + 1e-12
    return torch.clamp(torch.full_like(norm, clip_norm) / norm, max=1.0)


def _observe_dx(layout: Layout, compressor, base_opt: Optimizer, cs, new_params: Tree,
                params: Tree):
    """||Δx||² -> α rule, rescaled to gradient-equivalent units
    (base_opt.dx_scale — §4.1 momentum correction). Each leaf's Δx is made
    and reduced in turn, so one is alive at a time; at tp > 1 the local
    shards' values are reduced to the global ones."""
    delta = (
        (k, new_params[k].to(torch.float32) - p.to(torch.float32))
        for k, p in params.items()
    )
    stats = local_dx_stats(delta)
    if layout.tp > 1:
        stats = _global_reduce_leaf_sq(layout, stats.leaf_sq)
    return compressor.observe_update(cs, scale_dx_stats(stats, base_opt.dx_scale))


def _fused_update_stage(layout: Layout, params: Tree, opt_state, eta,
                        base_opt: Optimizer, *, ghat, words, alphas, wf,
                        clip_scale, shift=None):
    """The fused decode + optimizer route, one kernel per leaf straight off
    the summed transport payload (packed words or dense lanes). With a
    shift (IntDIANA's global h) the kernel also emits the new shift in the
    same pass. The exact step has no integer payload and runs the same
    arithmetic unfused. Returns ``(new_params, new_opt_state,
    new_shift | None)``."""
    if words is None:
        new_params, new_opt = optb.fused_reference_update(
            base_opt, ghat, params, opt_state, eta
        )
        return new_params, new_opt, None
    kern = base_opt.fused_kernel
    tail, new_scalars = optb.fused_step_scalars(base_opt, opt_state, eta)
    tensor_names = optb.FUSED_STATE_TENSORS[kern]
    n = layout.ctx.n
    new_p, new_h = {}, {}
    new_state = {nm: {} for nm in tensor_names}
    for k in layout.names:
        scalars = torch.stack([1.0 / (n * alphas[k]), clip_scale, *tail])
        po, oo, ho = wf.fused_update(
            words[k], params[k], tuple(opt_state[nm][k] for nm in tensor_names),
            scalars, kernel=kern, n_summed=n,
            shift=None if shift is None else shift[k],
        )
        new_p[k] = po
        new_h[k] = ho
        for nm, o in zip(tensor_names, oo):
            new_state[nm][k] = o
    return new_p, {**new_state, **new_scalars}, (None if shift is None else new_h)


def _make_train_step(layout: Layout, *, compressor, base_opt, lr_schedule,
                     exact: bool, clip_norm: Optional[float], fused: bool,
                     microbatches: int, param_dtype):
    # the microbatch wire pipelining rides the same capability as the fused
    # route: compressors with wire-level aggregation pipeline their integer
    # images; the others accumulate f32 gradients and aggregate once
    pipelined = microbatches > 1 and compressor.fused_capable

    def step(params, opt_state, comp_state, step_idx: int, batch, seeds=None):
        """-> (params', opt_state', comp_state', loss, (max_int, bits,
        alphas, max_local_int)); ``alphas`` is the step's {leaf: 0-d α}
        (empty on the exact step and for a float compressor), max_int the
        largest |summed integer| on the wire and max_local_int the largest
        |integer| one worker sent (both 0 on the exact step). ``seeds``: int32 (n_workers,
        n_leaves) encode seeds on the card, (M, n_workers, n_leaves) with M
        pipelined microbatches (unused by the exact step)."""
        ctx = layout.ctx
        if not exact and seeds is None:
            raise ValueError("the compressed step needs (n_workers, n_leaves) encode seeds")
        if not exact and pipelined and (seeds.dim() != 3 or seeds.shape[0] != microbatches):
            raise ValueError(
                f"{microbatches} pipelined microbatches need (M, n_workers, n_leaves) "
                f"encode seeds, got {tuple(seeds.shape)}"
            )
        eta = lr_schedule(step_idx, layout.device)
        wa = alphas = None
        cs = comp_state
        if not exact and pipelined:
            ghat, cs, loss, max_int, max_local, alphas = _pipelined_grad_stage(
                layout, compressor, cs, params, batch, seeds, eta, microbatches,
            )
            metrics = (max_int, wire_bits(max_int), alphas, max_local)
        else:
            losses = []

            def worker_grads():
                for w in ctx.local_workers():
                    local = _microbatch(batch, w, ctx.n)
                    if microbatches > 1:
                        loss_w, grads = _accum_grad_stage(layout, params, local, microbatches)
                    else:
                        loss_w, grads = _forward_backward(layout, params, local)
                    losses.append(loss_w)
                    yield grads
                    del grads

            if exact:
                ghat = aggregate_exact(worker_grads(), ctx)
                zero = torch.zeros((), dtype=torch.float32, device=layout.device)
                metrics = (zero, zero, {}, zero)
            elif fused:
                wa, alphas, cs, m = compressor.aggregate_wire(
                    comp_state, worker_grads(), seeds=seeds, eta=eta, ctx=ctx,
                    dims=layout.dims,
                )
                ghat = None
                metrics = (m.max_int, m.bits_per_coord, alphas, m.max_local_int)
            else:
                ghat, cs, m = compressor.aggregate(
                    comp_state, worker_grads(), seeds=seeds, eta=eta, ctx=ctx,
                    dims=layout.dims,
                )
                metrics = (m.max_int, m.bits_per_coord, m.alphas, m.max_local_int)
            loss = ctx.mean_scalars(losses)

        # the replicated global shift the fused decode adds (IntDIANA's
        # h_global; None for shift-free compressors, the exact step and the
        # ZeRO-1 route, which decodes ĝ itself)
        shift = None if wa is None else compressor.fused_shift(cs)
        clip_scale = torch.ones((), dtype=torch.float32, device=layout.device)
        if clip_norm is not None:
            scale = _clip_factor(
                layout, clip_norm, ghat=ghat,
                int_sum=None if wa is None else wa.ints, alphas=alphas, shift=shift,
            )
            if ghat is not None:
                ghat = {k: g * scale for k, g in ghat.items()}
            else:  # fused: the clip rides the kernels' scalar vector
                clip_scale = scale
        words = None if wa is None else wa.words
        del wa  # the summed image is not needed past the clip factor

        if fused:
            new_params, new_opt, new_shift = _fused_update_stage(
                layout, params, opt_state, eta, base_opt, ghat=ghat, words=words,
                alphas=alphas, wf=None if words is None else compressor.wire_format,
                clip_scale=clip_scale, shift=shift,
            )
            if new_shift is not None:
                cs = compressor.fused_store_shift(cs, new_shift)
        else:
            # a dict of the step's own (the compressor's state may hold the
            # one it returned), emptied as each leaf's rows are taken
            ghat = dict(ghat)
            new_params, new_opt = zero1_update(
                base_opt, opt_state, ghat, eta, n_dp=ctx.n, param_dtype=param_dtype,
                params_like=params, group=ctx.group, consume_grads=True,
            )
        del ghat, words
        cs = _observe_dx(layout, compressor, base_opt, cs, new_params, params)
        if layout.tp > 1:  # the whole model's widths (the JAX package's pmax over dp + model)
            peaks = coll.pmax_tp(torch.stack([metrics[0], metrics[1], metrics[3]]),
                                 layout.axes.group)
            metrics = (peaks[0], peaks[1], metrics[2], peaks[2])
        return new_params, new_opt, cs, loss, metrics

    return step


def build_train_step(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    n_workers: int,
    compressor: Compressor,
    base_opt: Optimizer,
    lr_schedule: Callable,
    param_dtype=torch.bfloat16,
    fused: bool = False,
    clip_norm: Optional[float] = None,
    wire=None,
    microbatches: int = 1,
    device=None,
    group=None,
    overlap: str = "off",
    bucket_words: int = bucketing.DEFAULT_BUCKET_WORDS,
    grid=None,
    verify: Optional[str] = "off",
) -> StepArtifacts:
    """The exact (step-0) and compressed train steps of ``cfg`` with
    ``n_workers`` data-parallel workers: simulated in turn on one device, or
    with a ``torch.distributed`` ``group`` one per rank (``n_workers`` must
    then be its world size). The device is the card by default;
    ``device="cpu"`` runs the kernels' plain versions. The update runs on
    the ZeRO-1 route, or with ``fused=True`` through the fused decode +
    update kernels; ``param_dtype`` is the params' type, bf16 by default as
    in the JAX package (the ZeRO-1 route gathers its f32 master rows into
    it; the fused kernels read and write a bf16 param themselves and keep
    their state in f32). ``overlap="ring"`` sends
    the integer wire in buckets of ``bucket_words`` words. With ``grid`` (a
    ``launch.mesh.Grid``, in place of ``group``) the step runs on this
    rank's shard of a data × model grid: ``n_workers`` is the number of dp
    replicas, the params the rank's shard (``specs.tp_shard``).

    ``verify="static"`` records the compressed step once on the meta device
    (the local backend's ``n_workers`` workers, arguments built as the dry
    run builds them: no card is touched) and runs the full W/P/T static
    audit (``analysis.schedule.full_audit``) against the step's
    ``audit_spec``, raising ``WireAuditError`` on any violation (the
    passing report is ``static_report``); a route whose step cannot run on
    meta raises naming the op. The default ``"off"`` (or None) records
    nothing."""
    if verify not in (None, "off", "static"):
        raise ValueError(f"verify must be 'off' or 'static', got {verify!r}")
    device = resolve_device(device)
    # float32 matmuls in full float32 on the card (no TF32), as in the JAX
    # package: the bf16 forward is the train path's only reduced precision
    torch.backends.cuda.matmul.allow_tf32 = False
    if wire is not None:
        compressor = with_wire(compressor, wire)
    if microbatches > 1 and fused:
        raise ValueError(
            "microbatch pipelining accumulates summed integer images, which "
            "the fused packed-word kernel cannot consume; use the zero1 "
            "route (fused=False) with microbatches > 1"
        )
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    tp = 1 if grid is None else grid.tp
    if grid is not None:
        if group is not None:
            raise ValueError("pass the grid or a group, not both: the grid's data group "
                             "carries the workers")
        group = grid.data_group
        _check_tp_compressor(compressor, cfg, tp)
    if group is None:
        ctx = CommCtx(n_workers=n_workers, overlap=overlap, bucket_words=bucket_words)
    else:
        ctx = CommCtx.on_group(group, overlap=overlap, bucket_words=bucket_words,
                               model_group=grid.model_group if tp > 1 else None)
        if ctx.n != n_workers:
            raise ValueError(
                f"{n_workers} workers on a process group of {ctx.n} ranks: one "
                "rank per worker"
            )
        _check_group_wire(compressor)
    if fused:
        _fused_plan(base_opt, compressor)
    if shape.global_batch % n_workers:
        raise ValueError(
            f"global batch {shape.global_batch} does not split over "
            f"{n_workers} workers"
        )
    if microbatches > 1:
        local_batch = shape.global_batch // n_workers
        if local_batch % microbatches:
            raise ValueError(
                f"local batch {local_batch} (global {shape.global_batch} over "
                f"{n_workers} workers) is not divisible into "
                f"{microbatches} microbatches"
            )
    _, shapes, specs = specs_mod.infer_param_specs(cfg, tp)
    names = tuple(leaf_names(shapes))
    rep = frozenset(k for k, d in specs.items() if d is None)
    axes = SINGLE if tp == 1 else Axes(group=grid.model_group, tp_size=tp,
                                       tp_index=grid.tp_index)
    layout = Layout(
        cfg=cfg, ctx=ctx, dims=specs_mod.global_tree_dims(cfg, tp), names=names,
        device=device, tp=tp, axes=axes, rep=rep,
        rep_mask=None if tp == 1 else torch.tensor([k in rep for k in names], device=device),
        leaf_sizes=tuple(math.prod(shapes[k]) for k in names),
    )

    def make(exact):
        return _make_train_step(
            layout, compressor=compressor, base_opt=base_opt,
            lr_schedule=lr_schedule, exact=exact, clip_norm=clip_norm,
            fused=fused, microbatches=microbatches,
            param_dtype=param_dtype,
        )

    # the wire contract the static auditor proves a recorded step against
    # (float-wire baselines have no codec and no spec). n_accum is the
    # number of IMAGES that ride the wire per step: M when the compressor
    # pipelines its integer images, else 1 (an f32 accumulation, one image)
    wf = getattr(compressor, "wire_format", None)
    audit_spec = None
    if wf is not None:
        from repro_torch.analysis.wire_audit import spec_for_step

        n_images = microbatches if compressor.fused_capable else 1
        audit_spec = spec_for_step(layout, wf, n_accum=n_images, fused=fused)

    def meta_step(which: str = "compressed"):
        if grid is not None and tp > 1:
            raise NotImplementedError(
                f"the static audit records a step on the meta device with the local "
                f"backend, which holds no model shards: a step at tp = {tp} is audited on "
                "its ranks (record it with repro_torch.analysis.trace.record)")
        twin = build_train_step(
            cfg, shape, n_workers=n_workers, compressor=compressor, base_opt=base_opt,
            lr_schedule=lr_schedule, param_dtype=param_dtype, fused=fused,
            clip_norm=clip_norm, microbatches=microbatches, device="meta",
            overlap=overlap, bucket_words=bucket_words)
        return twin.steps[which], _meta_args(twin.layout, shape, compressor, base_opt,
                                             fused=fused, microbatches=microbatches,
                                             param_dtype=param_dtype, exact=which == "exact")

    artifacts = StepArtifacts(steps={"compressed": make(False), "exact": make(True)},
                              layout=layout, audit_spec=audit_spec, meta_step=meta_step)
    if verify == "static":
        if audit_spec is None:
            raise ValueError(
                "verify='static' needs an integer wire to prove; compressor "
                f"{type(compressor).__name__} has no wire_format")
        from repro_torch.analysis.schedule import verify_step

        report = verify_step(artifacts)
        report.raise_if_failed()
        artifacts = dataclasses.replace(artifacts, static_report=report)
    return artifacts


def _meta_args(layout: Layout, shape: ShapeConfig, compressor: Compressor,
               base_opt: Optimizer, *, fused: bool, microbatches: int, param_dtype,
               exact: bool):
    """A step's arguments on the meta device, built as ``launch/dryrun.py``
    builds them: the params (``param_dtype``, the model's float32 leaves
    float32), the state from ``build_init_state``, step 1, the global batch
    of ``inputs.input_specs`` and the encode seeds; no memory, no card."""
    from repro_torch.launch.inputs import input_specs
    from repro_torch.models.transformer import FLOAT32_LEAVES

    meta = torch.device("meta")
    _, shapes, _ = specs_mod.infer_param_specs(layout.cfg, layout.tp)
    params = {k: torch.empty(shapes[k], device=meta,
                             dtype=torch.float32 if k in FLOAT32_LEAVES else param_dtype)
              for k in layout.names}
    n = layout.ctx.n
    opt_state, comp_state = build_init_state(params, n_workers=n, compressor=compressor,
                                             base_opt=base_opt, fused=fused)
    batch = {k: torch.zeros(s, dtype=d, device=meta)
             for k, (s, d) in input_specs(layout.cfg, shape, "train").items()}
    pipelined = microbatches > 1 and compressor.fused_capable
    seeds = torch.zeros(((microbatches,) if pipelined else ()) + (n, len(params)),
                        dtype=torch.int32, device=meta)
    return params, opt_state, comp_state, 0 if exact else 1, batch, seeds


def _check_tp_compressor(compressor: Compressor, cfg: ModelConfig, tp: int) -> None:
    """Every compressor runs at tp > 1 on the rank's shards, as in the JAX
    package's TP step, but PowerSGD where that step fails at build: a leaf
    that is a matrix of at least ``min_compress_size`` elements globally
    but not on its shard (JAX's ``_comp_state_shapes`` then maps its
    global Q against the shard's None)."""
    if tp == 1 or not isinstance(compressor, PowerSGD):
        return
    g_shapes, l_shapes, _ = specs_mod.infer_param_specs(cfg, tp)
    for k, g in g_shapes.items():
        if compressor.compresses(g) and not compressor.compresses(l_shapes[k]):
            raise NotImplementedError(
                f"PowerSGD at tp = {tp}: leaf {k!r} is a matrix of {math.prod(g)} elements "
                f"globally but of {math.prod(l_shapes[k])} on its shard, below "
                f"min_compress_size = {compressor.min_compress_size}; the JAX package's TP "
                "step fails to build here (its global Q has no local counterpart): lower "
                "min_compress_size below the shard's size or raise it above the global one")


def _check_group_wire(compressor: Compressor) -> None:
    """A process group sums int8 and int32 lanes only: refuse a 16-bit
    dense wire before the first step."""
    wf = getattr(compressor, "wire_format", None)
    lane = getattr(wf, "lane_dtype", None)
    if lane is not None and lane not in coll.GROUP_WIRE_DTYPES:
        raise WireTransportError(
            f"the dense{wf.bits} wire sends {lane} lanes, which no process group "
            "sums (gloo refuses int16, NCCL has no 16-bit integer type); use "
            f"packed{wf.bits}, which costs the same {wf.bits // 8} bytes per coordinate"
        )


def build_init_state(params: Tree, *, n_workers: int, compressor: Compressor,
                     base_opt: Optimizer, fused: bool = False, group=None, grid=None):
    """``(opt_state, comp_state)`` for ``params``: ZeRO-1 masters (equal to
    the params) with the optimizer state in their row layout by default, the
    fused route's f32 state tree with ``fused=True``; the compressor's state
    for the workers this process runs. With a process ``group`` (of
    ``n_workers`` ranks) the ZeRO-1 rows and IntDIANA's local shift are
    the rank's alone; with a ``grid`` its data group is that group and
    ``params`` the rank's shard."""
    if grid is not None:
        group = grid.data_group
    rank = None
    if group is not None:
        if coll.group_size(group) != n_workers:
            raise ValueError(f"{n_workers} workers on a process group of "
                             f"{coll.group_size(group)} ranks")
        rank = coll.group_rank(group)
    if fused:
        _fused_plan(base_opt, compressor)
        opt_state = optb.fused_state_init(base_opt, params)
    else:
        opt_state = zero1_init(base_opt, params, n_workers, rank=rank)
    return opt_state, compressor.init(params, n_workers if rank is None else 1)


# ---------------------------------------------------------------------------
# serve steps (prefill / decode)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeArtifacts:
    """A serve step of one rank of a data × model grid (the JAX package's
    ``build_serve_step`` artifacts, per rank): ``steps`` holds "prefill" or
    "decode"; ``rows`` is the rank's slice of the global batch (all of it
    when ``seq_sharded``); ``cache_shapes`` and ``cache_specs`` are the
    rank's local decode cache of ``s_local`` slots and its leaves'
    :class:`~repro_torch.launch.specs.CacheSpec` (where each sits in the
    global cache)."""

    steps: Dict[str, Callable]
    axes: Axes
    rows: slice
    s_local: int
    seq_sharded: bool
    cache_shapes: Dict[str, tuple]
    cache_specs: Dict[str, specs_mod.CacheSpec]
    init_cache: Optional[Callable[[], Tree]] = None


def build_serve_step(cfg: ModelConfig, grid, shape: ShapeConfig, *,
                     dtype=torch.bfloat16, device=None) -> ServeArtifacts:
    """The prefill (``shape.kind == "prefill"``) or decode step of ``cfg``
    on this rank of ``grid`` (a ``launch.mesh.Grid``; None: one process,
    a 1 × 1 grid), on the rank's shard of the params (``specs.tp_shard``),
    the activations in ``dtype``.

    - prefill ``(params, batch) -> logits``: ``batch["tokens"]`` the global
      (B, T) prompts (the vlm family's ``patch_embeds`` too; the
      encoder-decoder's ``frames``); the rank's rows run the forward and the
      last position's vocab-local logits (b_local, V/tp) come out float32;
    - decode ``(params, cache, tokens, pos) -> (next_tok, cache)``:
      ``tokens`` and ``pos`` the global (B,) step, the rank's rows decoded
      against its local cache (``init_cache()``: ``cache_shapes(cfg, tp,
      tp, b_local, s_local)``, written in place) and its rows' greedy
      tokens picked by ``tp_greedy`` over the vocab shards.

    A decode whose global batch is smaller than the data replicas is
    sequence-sharded, as in the JAX package: every rank takes the whole
    batch, its cache holds ``seq_len // n_dp`` of the slots, and attention
    combines its softmax over the data group (``Axes.sp``); MLA refuses it
    (``mla.refuse_sequence_shards``). There the recurrent states of the
    hybrid and ssm families are whole on every rank (they have no
    sequence), and the encoder-decoder's cross cache is the rank's own copy
    of every encoder position: ``encdec.encdec_prefill(..., axes=)`` fills
    it on every rank before the first decode step, as the JAX package's
    cross attention reads it (no ``axes.sp`` branch)."""
    device = resolve_device(device)
    n_dp, tp = (1, 1) if grid is None else (grid.n_dp, grid.tp)
    dp_index = 0 if grid is None else grid.dp_index
    seq_sharded = shape.kind == "decode" and shape.global_batch < n_dp
    model = {} if tp == 1 else dict(group=grid.model_group, tp_size=tp,
                                    tp_index=grid.tp_index)
    if seq_sharded:
        if cfg.kv_lora:
            from repro_torch.models.mla import refuse_sequence_shards

            refuse_sequence_shards(Axes(sp=grid.data_group))
        if shape.seq_len % n_dp:
            raise ValueError(f"seq_len {shape.seq_len} does not split over {n_dp} sequence "
                             "shards")
        axes = Axes(**model, sp=grid.data_group, sp_size=n_dp, sp_index=dp_index)
        b_local, s_local = shape.global_batch, shape.seq_len // n_dp
        rows = slice(0, shape.global_batch)
    else:
        if shape.global_batch % n_dp:
            raise ValueError(f"global batch {shape.global_batch} does not split over {n_dp} "
                             "data replicas")
        axes = Axes(**model)
        b_local, s_local = max(1, shape.global_batch // n_dp), shape.seq_len
        rows = slice(dp_index * b_local, (dp_index + 1) * b_local)
    s_src = min(shape.seq_len, 32768)
    c_shapes = specs_mod.cache_shapes(cfg, tp, tp, b_local, s_local, s_src=s_src)
    c_specs = specs_mod.cache_pspecs(c_shapes, seq_sharded=seq_sharded)
    art = dict(axes=axes, rows=rows, s_local=s_local, seq_sharded=seq_sharded,
               cache_shapes=c_shapes, cache_specs=c_specs)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            local = {k: v[rows] for k, v in batch.items()}
            if cfg.family == "encdec":
                h = encdec.encode(params, local["frames"], cfg, dtype, axes)[:, -1:]
                logits = (h @ params["lm_head"].to(h.dtype)).to(torch.float32)
            else:
                h = lm_forward(params, local, cfg, dtype, axes)
                logits = lm_logits(params, h[:, -1:], cfg)
            return logits[:, 0]

        return ServeArtifacts(steps={"prefill": prefill}, **art)

    def init_cache():
        if cfg.family == "encdec":
            return encdec.init_encdec_cache(cfg, b_local, s_local, s_src, device=device, tp=tp,
                                            n_shards=tp)
        return init_lm_cache(cfg, b_local, s_local, device=device, tp=tp, n_shards=tp)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        tokens, pos = tokens[rows], pos[rows]
        if cfg.family == "encdec":
            logits, cache = encdec.encdec_decode_step(params, cache, tokens, pos, cfg, dtype,
                                                      axes)
        else:
            logits, cache = lm_decode_step(params, cache, tokens, pos, cfg, dtype, axes)
        return tp_greedy(logits, axes), cache

    return ServeArtifacts(steps={"decode": decode}, init_cache=init_cache, **art)
