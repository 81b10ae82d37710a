"""Training loop and CLI (port of ``repro/launch/train.py``): the compressed
data-parallel IntSGD loop, with n workers simulated on one card or one
process per worker under ``torchrun``.

CLI (runs on the card; ``--device cpu`` runs the kernels' plain versions)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --smoke --steps 8 --workers 4 --batch 8 --seq 32 \\
      --compressor intsgd8_packed --wire packed8 --opt sgd [--microbatches 2]

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch granite-8b --smoke --workers 4 \\
      --batch 8 --seq 32 --device cpu [--overlap ring --bucket-words 4096]

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --smoke --steps 8 --batch 4 --seq 32 --lr 0.3 --compressor intsgd \\
      --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
      --smoke --steps 8 --workers 4 --batch 4 --seq 32 --device cpu \\
      --ckpt-dir /path/to/ckpt [--resume]

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite-8b --smoke --data 2 --model 2 --steps 6 --batch 4 \\
      --seq 32 --device cpu

Under ``torchrun`` (its ``RANK``/``WORLD_SIZE`` environment) each process
is one worker: the process group is NCCL on the card (one card per rank)
and gloo on the CPU; ``--dist-backend gloo`` lets ranks share one card.
``--workers`` (or ``--data``) must equal the world size, and only rank 0
prints the step lines.

The update runs on the ZeRO-1 route (f32 master rows, the JAX package's
default) unless ``--fused`` asks for the fused decode + update kernels;
``--microbatches M`` pipelines M microbatches' integer images per step on
the ZeRO-1 route. ``--opt sgd|adamw``; ``--compressor`` none or
allgather_sgd (uncompressed SGD, the paper's baseline; ZeRO-1 only),
intsgd, intsgd_block (blockwise α, Alg. 2), intsgd_determ (round half to
even), intsgd4, intsgd8, intsgd8_packed, intsgd4_packed or intdiana, or
one of the paper's baselines (ZeRO-1 only): heuristic_intsgd (8-bit,
with the wire's consistency check), qsgd, natsgd, powersgd, signsgd,
topk; ``--wire`` dense4/8/16/32, packed4/8/16, topk8:<k> or topk16:<k>
(sparse, gathered; IntSGD then carries an error-feedback residual), or
logged:<name> (the same, its bytes metered). A compressor whose name
carries no width — intsgd, intsgd_block, intsgd_determ, intdiana — takes
the wire's. ``--layers N`` cuts the depth (full width kept). ``--overlap
ring`` sends the integer wire in buckets of ``--bucket-words`` words.
``--arch`` takes the dense decoders granite-8b, minitron-4b, qwen2.5-32b
and h2o-danube-3-4b, the moe family, mixtral-8x22b and
deepseek-v2-lite-16b, the hybrid zamba2-2.7b and the xLSTM xlstm-125m
(``--smoke`` on the CPU, ``--layers N`` on the card; zamba2's N a
multiple of its attn_every, 9, xlstm's of its (m, m, s) block, 3);
internvl2-2b (vlm) needs patch embeddings, which the
synthetic token data does not carry: drive it with
``launch.step.build_train_step`` and ``launch.inputs.materialize_batch``.
``--ckpt-dir DIR`` saves the params, optimizer and compressor state every
20 steps (``checkpoint.CheckpointStore``, the JAX package's layout);
``--resume`` starts from its latest step.

``--model M`` (tensor parallelism; every family the synthetic token data
drives, so zamba2 and xlstm too, not seamless; every compressor, but
PowerSGD where a leaf is a matrix of ``min_compress_size`` elements
globally and not on its shard, which raises as the JAX package fails
there) runs under
``torchrun`` on a ``--data`` × ``--model`` grid of ranks
(``launch.mesh.make_debug_mesh``): the world size is data · model, each
rank holds its shard of the model axis, and ``--data`` (or ``--workers``)
defaults to world // model. Without ``torchrun`` it raises. On the grid
``--ckpt-dir`` and ``--resume`` write and read the JAX package's global
layout (``CheckpointStore(grid=..., specs=...)``); ``--resume`` on a grid
of fewer data replicas (``--data``) is the elastic resume
(``runtime.elastic``), from a state whose leaves are all replicated over
dp::

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch granite-8b --smoke --data 2 --model 2 --steps 40 --batch 4 \
      --seq 32 --device cpu --fused --compressor intsgd8_packed --wire packed8 \
      --ckpt-dir /path/to/ckpt [--resume]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.base import ShapeConfig, get_arch, ported_archs, smoke_config
from repro_torch.core.compressor import (
    Compressor, compressor_names, leaf_seeds, make_compressor, with_wire,
)
from repro_torch.data.synthetic import SyntheticLMData
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.step import build_init_state, build_train_step
from repro_torch.models.transformer import init_lm_params
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedules import constant, warmup_wrap
from repro_torch.optim.sgd import sgd
from repro_torch.parallel import collectives as coll
from repro_torch.utils.device import resolve_device
from repro_torch.wire import bucketing, make_wire_format, wire_format_names

OPTIMIZERS = {
    "sgd": lambda: sgd(momentum=0.9, weight_decay=1e-4),
    "adamw": lambda: adamw(weight_decay=1e-4),
}
# registry names that carry no width: with a wire, they take the wire's
WIDTH_FROM_WIRE = ("intsgd", "intsgd_block", "intsgd_determ", "intdiana")


def train_loop(
    cfg,
    shape: ShapeConfig,
    *,
    n_workers: int = 1,
    compressor="intsgd8_packed",
    steps: int,
    lr: float = 0.3,
    log_every: int = 5,
    seed: int = 0,
    fused: bool = False,
    clip_norm: float | None = 1.0,
    wire: str | None = None,
    microbatches: int = 1,
    opt: str = "sgd",
    param_dtype=torch.float32,
    device=None,
    group=None,
    overlap: str = "off",
    bucket_words: int = bucketing.DEFAULT_BUCKET_WORDS,
    on_step=None,
    ckpt: CheckpointStore | None = None,
    ckpt_every: int = 20,
    resume: bool = False,
    grid=None,
):
    """Train ``cfg`` for ``steps`` steps (step 0 exact, the rest compressed)
    with ``compressor`` (a registry name, or a ``Compressor`` with options of
    its own, such as PowerSGD's ``min_compress_size``) on synthetic data,
    on the ZeRO-1 route or, with ``fused=True``, the fused one; the n
    workers simulated in turn, or one per rank of a
    ``torch.distributed`` ``group`` (every rank draws the same weights,
    batches and encode seeds and uses its own share; only rank 0 prints).
    Weights come from a ``torch.Generator`` seeded with ``seed`` on the
    device (in ``param_dtype``), encode seeds from a host generator with the
    same seed. Returns ``(params, history)``: one record per step with
    loss, max_int, bits, max_local_int, each leaf's α (``alpha``, empty on
    the exact step and for a float compressor) and the step's wall time in
    ms (the step ends in a sync). ``on_step(i, params)``, if given, is called after each
    step with its new params.

    With ``ckpt`` the state ``{"params", "opt", "comp"}`` is saved after
    every ``ckpt_every``-th step (as the JAX loop saves it); with
    ``resume`` the loop starts from ``ckpt``'s latest step. A resumed run is the
    uninterrupted one: the data is indexed by step, and the encode seeds
    of the steps before it are drawn and dropped, so step s takes the seeds
    an uninterrupted run takes (the JAX package folds the step into its key
    instead).

    Elastic resume (``runtime.elastic``'s step 3): ``resume`` with another
    ``n_workers`` than the checkpoint's restores a state whose leaves are
    all replicated — the fused route with IntSGD (params, momentum or
    AdamW moments, α's state) — and goes on at n': the step's clip limit
    and α's n take n', and the seeds are drawn for n' workers, for the
    skipped steps too. A leaf held one row per worker (the ZeRO-1 rows,
    IntDIANA's h_local, an error-feedback residual) is refused by
    ``CheckpointStore.restore``, naming it and both counts.

    With ``grid`` (``launch.mesh.Grid``, in place of ``group``) the loop
    runs this rank's part of a data × model grid: ``n_workers`` is the
    number of dp replicas, every rank draws the global weights padded for
    the grid's tp and keeps its shard, and the TP members of a replica take
    the replica's share of each batch. ``ckpt`` must then be a store made
    on the same grid (``CheckpointStore(grid=grid, specs=...)``): it
    writes the global layout, and ``resume`` on a grid of another data
    count is the elastic resume above, with tp kept."""
    if cfg.frontend is not None:  # the JAX CLI's init_lm_params refuses encdec too
        raise ValueError(
            f"{cfg.name}: the {cfg.frontend!r} frontend takes "
            f"{'frame' if cfg.frontend == 'audio' else 'patch'} embeddings, which "
            "the synthetic token data does not carry; drive it with "
            "launch.step.build_train_step and launch.inputs.materialize_batch")
    device = resolve_device(device)
    tp = 1 if grid is None else grid.tp
    if ckpt is not None and grid is not None and ckpt.grid is not grid:
        raise ValueError("a checkpoint on a grid: make the store with the same grid, "
                         "CheckpointStore(directory, grid=grid, specs=...)")
    if grid is not None:
        if group is not None:
            raise ValueError("pass the grid or a group, not both")
        if n_workers != grid.n_dp:
            raise ValueError(f"{n_workers} workers on a grid of {grid.n_dp} dp replicas")
    if opt not in OPTIMIZERS:
        raise ValueError(f"optimizer {opt!r}; options {sorted(OPTIMIZERS)}")
    comp = compressor if isinstance(compressor, Compressor) else make_compressor(compressor)
    if wire is not None:
        wf = make_wire_format(wire)
        if compressor in WIDTH_FROM_WIRE:
            comp = dataclasses.replace(comp, bits=wf.bits)
        comp = with_wire(comp, wf)
    base_opt = OPTIMIZERS[opt]()
    sched = warmup_wrap(constant(lr), 5)
    art = build_train_step(
        cfg, shape, n_workers=n_workers, compressor=comp, base_opt=base_opt,
        lr_schedule=sched, param_dtype=param_dtype, fused=fused,
        clip_norm=clip_norm, microbatches=microbatches, device=device, group=group,
        overlap=overlap, bucket_words=bucket_words, grid=grid,
    )
    params = init_lm_params(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        device=device, dtype=param_dtype, tp=tp,
    )
    if tp > 1:  # the rank's slice of the global draw
        params = specs.tp_shard(cfg, tp, grid.tp_index).tree(params)
    opt_state, comp_state = build_init_state(
        params, n_workers=n_workers, compressor=comp, base_opt=base_opt, fused=fused,
        group=group, grid=grid,
    )
    first_rank = art.layout.ctx.worker_index() == 0 and (grid is None or grid.tp_index == 0)
    seed_gen = torch.Generator().manual_seed(seed)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=seed)
    n_leaves = len(art.layout.names)
    start = 0
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        state, _, start = ckpt.restore({"params": params, "opt": opt_state, "comp": comp_state})
        params, opt_state, comp_state = state["params"], state["opt"], state["comp"]
        del state
        for _ in range(start):  # the seeds of the steps already taken
            leaf_seeds(seed_gen, n_workers, n_leaves, "cpu", microbatches)
        if first_rank:
            print(f"[train] resumed from step {start}", flush=True)

    history = []
    for i in range(start, steps):
        batch = data.batch(i, 0, device=device)  # global batch, split by worker
        seeds = leaf_seeds(seed_gen, n_workers, n_leaves, device, microbatches)
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        t0 = time.perf_counter()
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, batch, seeds
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the step's one host sync
        ms = (time.perf_counter() - t0) * 1e3
        if on_step is not None:
            on_step(i, params)
        alphas = metrics[2]
        alpha_vals = torch.stack(list(alphas.values())).tolist() if alphas else []
        rec = dict(step=i, loss=float(loss), max_int=float(metrics[0]),
                   bits=float(metrics[1]), max_local_int=float(metrics[3]),
                   alpha=dict(zip(alphas, alpha_vals)), ms=ms)
        history.append(rec)
        if first_rank and (i % log_every == 0 or i == steps - 1):
            print(
                f"[train] step {i:5d} loss {rec['loss']:.4f} "
                f"max_int {rec['max_int']:.0f} bits {rec['bits']:.0f} "
                f"dt {ms:.1f}ms", flush=True,
            )
        if ckpt is not None and (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt_state, "comp": comp_state})
    if ckpt is not None:
        ckpt.wait()
    return params, history


def _torchrun_rank():
    """``(rank, world_size, local_rank)`` from torchrun's environment, or
    None outside it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"the config: {', '.join(ported_archs())}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (width kept)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--workers", type=int, default=None,
                    help="data-parallel workers: simulated on the device, or "
                         "under torchrun the world size (default: 1, or the "
                         "world size)")
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--compressor", default="intsgd",
                    help="gradient compressor: " + ", ".join(compressor_names()))
    ap.add_argument("--opt", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--wire", default=None,
                    help="wire codec: " + ", ".join(wire_format_names()))
    ap.add_argument("--fused", action="store_true",
                    help="route the update through the fused decode+update "
                         "kernels (default: the ZeRO-1 route)")
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend under torchrun (default: nccl "
                         "on cuda, gloo on cpu; gloo lets ranks share a card)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the train state here every 20 steps")
    ap.add_argument("--resume", action="store_true",
                    help="start from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--data", type=int, default=None,
                    help="data-parallel degree (the JAX CLI's mesh axis): as --workers")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel degree: under torchrun, a --data x --model grid")
    ap.add_argument("--overlap", default="off", choices=["off", "ring"])
    ap.add_argument("--bucket-words", type=int, default=bucketing.DEFAULT_BUCKET_WORDS,
                    help="words per bucket of the --overlap ring wire")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="pipelined microbatches per step (ZeRO-1 route)")
    args = ap.parse_args(argv)

    if args.workers is not None and args.data is not None and args.workers != args.data:
        raise ValueError(f"--workers {args.workers} and --data {args.data} disagree")
    workers = args.workers if args.workers is not None else args.data
    run = _torchrun_rank()
    if args.model < 1:
        raise ValueError(f"--model must be >= 1, got {args.model}")
    if args.model > 1 and run is None:
        raise ValueError(
            f"--model {args.model} (tensor parallelism) runs one process per rank of a "
            f"--data x --model grid: launch it with torchrun --nproc-per-node "
            f"{(workers or 1) * args.model} (data x model processes)")
    if run is not None and run[1] % args.model:
        raise ValueError(f"--model {args.model} does not divide the {run[1]} processes "
                         "of the --data x --model grid")
    if run is not None and workers is not None and workers * args.model != run[1]:
        raise ValueError(
            f"--workers {workers} under torchrun with {run[1]} processes: one "
            f"process per worker" + (f" and model shard (--data x --model = "
                                     f"{workers * args.model})" if args.model > 1 else "")
        )
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    kw = dict(
        compressor=args.compressor, steps=args.steps, lr=args.lr, fused=args.fused,
        clip_norm=args.clip_norm, wire=args.wire, microbatches=args.microbatches,
        opt=args.opt, overlap=args.overlap, bucket_words=args.bucket_words,
    )
    if run is None:
        ckpt = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
        train_loop(cfg, shape, n_workers=workers or 1, device=args.device, ckpt=ckpt,
                   resume=args.resume, **kw)
        return
    rank, world, local_rank = run
    device = resolve_device(args.device)
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":  # NCCL: one card per rank; gloo ranks may share
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    group = coll.init_process_group(backend, device=device)
    try:
        if args.model > 1:
            grid = make_debug_mesh(world // args.model, args.model)
            ckpt = CheckpointStore(
                args.ckpt_dir, grid=grid, specs=specs.infer_param_specs(cfg, args.model)[2],
            ) if args.ckpt_dir else None
            train_loop(cfg, shape, n_workers=grid.n_dp, device=device, grid=grid, ckpt=ckpt,
                       resume=args.resume, **kw)
            return
        ckpt = CheckpointStore(args.ckpt_dir, group=group) if args.ckpt_dir else None
        train_loop(cfg, shape, n_workers=world, device=device, group=group, ckpt=ckpt,
                   resume=args.resume, **kw)
    finally:
        coll.destroy_process_group()


if __name__ == "__main__":
    main()
