"""Training loop and CLI (port of ``repro/launch/train.py``): the compressed
data-parallel IntSGD loop with n workers simulated on one card.

CLI (runs on the card; ``--device cpu`` runs the kernels' plain versions)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --smoke --steps 8 --workers 4 --batch 8 --seq 32 \\
      --compressor intsgd8_packed --wire packed8 --opt sgd [--microbatches 2]

The update runs on the ZeRO-1 route (f32 master rows, the JAX package's
default) unless ``--fused`` asks for the fused decode + update kernels;
``--microbatches M`` pipelines M microbatches' integer images per step on
the ZeRO-1 route. ``--opt sgd|adamw``; ``--compressor`` none or
allgather_sgd (uncompressed SGD, the paper's baseline; ZeRO-1 only),
intsgd, intsgd_block (blockwise α, Alg. 2), intsgd_determ (round half to
even), intsgd4, intsgd8, intsgd8_packed, intsgd4_packed or intdiana;
``--wire`` dense4/8/16/32 or packed4/8/16 (a compressor whose name carries
no width — intsgd, intsgd_block, intsgd_determ, intdiana — takes the
wire's). ``--layers N`` cuts the depth (full width kept). Not ported yet,
and raising so: ``--ckpt-dir``, ``--overlap ring`` and ``--data``/``--model``
meshes.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
from repro_torch.core.compressor import (
    compressor_names, leaf_seeds, make_compressor, with_wire,
)
from repro_torch.data.synthetic import SyntheticLMData
from repro_torch.launch.step import build_init_state, build_train_step, resolve_device
from repro_torch.models.transformer import init_lm_params
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedules import constant, warmup_wrap
from repro_torch.optim.sgd import sgd
from repro_torch.wire import make_wire_format, wire_format_names

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
    compressor: str = "intsgd8_packed",
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
):
    """Train ``cfg`` for ``steps`` steps (step 0 exact, the rest compressed)
    on synthetic data, on the ZeRO-1 route or, with ``fused=True``, the
    fused one. Weights come from a ``torch.Generator`` seeded with ``seed``
    on the device (in ``param_dtype``), encode seeds from a host generator
    with the same seed. Returns ``(params, history)``: one record per step
    with loss, max_int, bits, each leaf's α (``alpha``, empty on the exact
    step and for a float compressor) and the step's wall time in ms (the
    step ends in a sync)."""
    device = resolve_device(device)
    if opt not in OPTIMIZERS:
        raise ValueError(f"optimizer {opt!r}; options {sorted(OPTIMIZERS)}")
    comp = make_compressor(compressor)
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
        clip_norm=clip_norm, microbatches=microbatches, device=device,
    )
    params = init_lm_params(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        device=device, dtype=param_dtype,
    )
    opt_state, comp_state = build_init_state(
        params, n_workers=n_workers, compressor=comp, base_opt=base_opt, fused=fused,
    )
    seed_gen = torch.Generator().manual_seed(seed)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=seed)
    n_leaves = len(art.layout.names)

    history = []
    for i in range(steps):
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
        alphas = metrics[2]
        alpha_vals = torch.stack(list(alphas.values())).tolist() if alphas else []
        rec = dict(step=i, loss=float(loss), max_int=float(metrics[0]),
                   bits=float(metrics[1]), alpha=dict(zip(alphas, alpha_vals)), ms=ms)
        history.append(rec)
        if i % log_every == 0 or i == steps - 1:
            print(
                f"[train] step {i:5d} loss {rec['loss']:.4f} "
                f"max_int {rec['max_int']:.0f} bits {rec['bits']:.0f} "
                f"dt {ms:.1f}ms", flush=True,
            )
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (width kept)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--workers", type=int, default=1,
                    help="data-parallel workers simulated on the device")
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--overlap", default="off", choices=["off", "ring"])
    ap.add_argument("--microbatches", type=int, default=1,
                    help="pipelined microbatches per step (ZeRO-1 route)")
    args = ap.parse_args(argv)

    not_ported = [
        flag for flag, on in (
            ("--ckpt-dir", args.ckpt_dir is not None),
            ("--overlap ring", args.overlap != "off"),
            ("--data/--model meshes", args.data > 1 or args.model > 1),
        ) if on
    ]
    if not_ported:
        raise NotImplementedError(", ".join(not_ported) + ": not ported yet")
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    train_loop(
        cfg, shape, n_workers=args.workers, compressor=args.compressor,
        steps=args.steps, lr=args.lr, fused=args.fused,
        clip_norm=args.clip_norm, wire=args.wire, microbatches=args.microbatches,
        opt=args.opt, device=args.device,
    )


if __name__ == "__main__":
    main()
