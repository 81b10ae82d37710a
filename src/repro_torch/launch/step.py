"""Train step construction (port of the fused-route path of
``repro/launch/step.py`` on the local n-worker backend).

One step, as the JAX package's ``_make_train_body`` runs it on the fused
packed route:

  1. for each of the n workers in turn: forward and backward on that
     worker's slice of the global batch (bf16 activations, f32 params);
     on the compressed steps its gradients (IntDIANA: minus its local
     shift) are encoded Int(α∘g) and packed into transport words at once
     and freed, the words folding into the word sum with the wire type's
     wrap-around (``Compressor.aggregate_wire``); step 0 is exact (paper
     §4.1) and sums float gradients instead;
  2. the global-norm clip factor, computed off the summed integer image
     (plus the global shift for IntDIANA) (``_clip_factor``), so ĝ is
     never materialized;
  3. the fused decode + optimizer kernel per leaf — SGD or AdamW, packed
     words or dense lanes, with IntDIANA's shift in and out — straight off
     the summed payload (``_fused_update_stage``); step 0 runs the same
     arithmetic unfused (``optim.base.fused_reference_update``);
  4. ||Δx||² × dx_scale² fed back to the α rule (``_observe_dx``).

α, η, the clip factor and the kernels' scalar vectors stay on the card: the
step makes no host sync. The unfused ZeRO-1 route, microbatch pipelining,
the overlapped ring transport and tensor parallelism are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.comm import CommCtx
from repro_torch.core.compressor import Compressor, aggregate_exact, with_wire
from repro_torch.core.stats import DxStats, TreeDims, scale_dx_stats
from repro_torch.models.transformer import lm_loss, param_shapes
from repro_torch.optim import base as optb
from repro_torch.optim.base import Optimizer
from repro_torch.utils.tree import leaf_names

Tree = Dict[str, torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU
    (where every kernel wrapper runs its plain version)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run it on the CPU through the kernels' plain versions"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class Layout:
    """What every stage of the step shares: config, the n-worker context,
    the model's dimensionality (α's d) and leaf order, the device."""

    cfg: ModelConfig
    ctx: CommCtx
    dims: TreeDims
    names: tuple  # leaf names in jax.tree.flatten order
    device: torch.device


@dataclasses.dataclass(frozen=True)
class StepArtifacts:
    steps: Dict[str, Callable]  # "exact" (step 0) and "compressed"
    layout: Layout


def _forward_backward(layout: Layout, params: Tree, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = lm_loss(leaves, batch, layout.cfg, dtype=torch.bfloat16)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _worker_batch(batch, w: int, n: int):
    """Worker w's contiguous slice of the global batch (the JAX package
    shards the batch dimension over the data-parallel axis)."""
    def one(v):
        b = v.shape[0] // n
        return v[w * b:(w + 1) * b]

    return {k: one(v) for k, v in batch.items()}


def _fused_plan(base_opt: Optimizer, compressor: Compressor) -> str:
    """Validate the (compressor × optimizer) pair against the fused-route
    capability contract and return the kernel name."""
    if not getattr(compressor, "fused_capable", False):
        raise ValueError(
            "fused update routing consumes the summed transport words "
            "directly, which needs wire-level aggregation "
            f"(Compressor.fused_capable); compressor {compressor.name!r} "
            "does not advertise it"
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
    never materialized. Float32 sums in PyTorch's reduction order, not
    XLA's: the factor agrees with the JAX package to about 1e-6 relative."""
    n = layout.ctx.n
    if int_sum is not None and shift is None:
        leaf_sq = [
            torch.sum(torch.square(s.to(torch.float32))) / torch.square(n * alphas[k])
            for k, s in int_sum.items()
        ]
    elif int_sum is not None:
        leaf_sq = [
            torch.sum(torch.square(shift[k] + s.to(torch.float32) / (n * alphas[k])))
            for k, s in int_sum.items()
        ]
    else:
        leaf_sq = [torch.sum(torch.square(g.to(torch.float32))) for g in ghat.values()]
    norm = torch.sqrt(torch.sum(torch.stack(leaf_sq))) + 1e-12
    return torch.clamp(torch.full_like(norm, clip_norm) / norm, max=1.0)


def _observe_dx(compressor, base_opt: Optimizer, cs, new_params: Tree, params: Tree):
    """||Δx||² -> α rule, rescaled to gradient-equivalent units
    (base_opt.dx_scale — §4.1 momentum correction)."""
    leaf_sq = {
        k: torch.sum(torch.square(new_params[k].to(torch.float32) - p.to(torch.float32)))
        for k, p in params.items()
    }
    stats = DxStats(sq=torch.sum(torch.stack(list(leaf_sq.values()))), leaf_sq=leaf_sq)
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
                     exact: bool, clip_norm: Optional[float]):
    def step(params, opt_state, comp_state, step_idx: int, batch, seeds=None):
        """-> (params', opt_state', comp_state', loss, (max_int, bits)).
        ``seeds``: int32 (n_workers, n_leaves) encode seeds on the card
        (unused by the exact step)."""
        ctx = layout.ctx
        if not exact and seeds is None:
            raise ValueError("the compressed step needs (n_workers, n_leaves) encode seeds")
        eta = lr_schedule(step_idx, layout.device)
        losses = []

        def worker_grads():
            for w in range(ctx.n):
                loss, grads = _forward_backward(
                    layout, params, _worker_batch(batch, w, ctx.n)
                )
                losses.append(loss)
                yield grads
                del grads

        words = alphas = None
        cs = comp_state
        if exact:
            ghat = aggregate_exact(worker_grads(), ctx)
            zero = torch.zeros((), dtype=torch.float32, device=layout.device)
            metrics = (zero, zero)
        else:
            wa, alphas, cs, m = compressor.aggregate_wire(
                comp_state, worker_grads(), seeds=seeds, eta=eta, ctx=ctx,
                dims=layout.dims,
            )
            ghat = None
            metrics = (m.max_int, m.bits_per_coord)

        # the replicated global shift the fused decode adds (IntDIANA's
        # h_global; None for shift-free compressors and on the exact step)
        shift = None if exact else compressor.fused_shift(cs)
        clip_scale = torch.ones((), dtype=torch.float32, device=layout.device)
        if clip_norm is not None:
            scale = _clip_factor(
                layout, clip_norm, ghat=ghat,
                int_sum=None if exact else wa.ints, alphas=alphas, shift=shift,
            )
            if ghat is not None:
                ghat = {k: g * scale for k, g in ghat.items()}
            else:  # fused: the clip rides the kernels' scalar vector
                clip_scale = scale
        if not exact:
            words = wa.words
            del wa  # the summed image is not needed past the clip factor

        new_params, new_opt, new_shift = _fused_update_stage(
            layout, params, opt_state, eta, base_opt, ghat=ghat, words=words,
            alphas=alphas, wf=None if exact else compressor.wire_format,
            clip_scale=clip_scale, shift=shift,
        )
        if new_shift is not None:
            cs = compressor.fused_store_shift(cs, new_shift)
        cs = _observe_dx(compressor, base_opt, cs, new_params, params)
        loss = torch.sum(torch.stack(losses)) / ctx.n
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
    fused: bool = True,
    clip_norm: Optional[float] = None,
    wire=None,
    device=None,
) -> StepArtifacts:
    """The exact (step-0) and compressed train steps of ``cfg`` with
    ``n_workers`` data-parallel workers simulated on one device (the card
    by default; ``device="cpu"`` runs the kernels' plain versions)."""
    device = resolve_device(device)
    # float32 matmuls in full float32 on the card (no TF32), as in the JAX
    # package: the bf16 forward is the train path's only reduced precision
    torch.backends.cuda.matmul.allow_tf32 = False
    if wire is not None:
        compressor = with_wire(compressor, wire)
    if not fused:
        raise NotImplementedError(
            "the unfused ZeRO-1 update route is not ported yet; use fused=True"
        )
    _fused_plan(base_opt, compressor)
    if shape.global_batch % n_workers:
        raise ValueError(
            f"global batch {shape.global_batch} does not split over "
            f"{n_workers} workers"
        )
    shapes = param_shapes(cfg)
    dims = TreeDims(d=sum(math.prod(s) for s in shapes.values()))
    layout = Layout(
        cfg=cfg, ctx=CommCtx(n_workers=n_workers), dims=dims,
        names=tuple(leaf_names(shapes)), device=device,
    )

    def make(exact):
        return _make_train_step(
            layout, compressor=compressor, base_opt=base_opt,
            lr_schedule=lr_schedule, exact=exact, clip_norm=clip_norm,
        )

    return StepArtifacts(steps={"compressed": make(False), "exact": make(True)},
                         layout=layout)
