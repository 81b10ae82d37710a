"""Serving CLI: batched greedy decode on a smoke-scale model (port of
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --device cpu

Runs on the card unless ``--device cpu`` is given. The weights come from a
``torch.Generator`` seeded with 0 and the prompts (4 to 7 tokens) from one
seeded with 1, so they differ from the JAX CLI's, which draws both with
``jax.random``. ``--arch`` takes every decoder-only family: dense, vlm,
moe, hybrid (zamba2-2.7b) and ssm (xlstm-125m). The encoder-decoder
(seamless-m4t-medium) is refused, as the JAX package's engine cannot serve
it either (its ``init_lm_cache`` raises for the family); its decode is
``models/encdec.py``'s, driven by a greedy loop.

``--mesh`` runs the JAX package's replicated route under ``torchrun``
(one process per rank; gloo on the CPU, NCCL on the card, or
``--dist-backend gloo`` for ranks that share a card): every rank serves the
same requests with the whole params, the tokens are checked to agree
across the ranks at every step, and rank 0 prints::

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch granite-8b --device cpu --mesh
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models.transformer import init_lm_params
from repro_torch.parallel import collectives as coll
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.utils.device import resolve_device


def prompts(n: int, vocab: int) -> list:
    """Request r's prompt: 4 + r % 4 ids in [0, vocab), from one host
    generator seeded with 1."""
    gen = torch.Generator().manual_seed(1)
    return [torch.randint(0, vocab, (4 + r % 4,), generator=gen).tolist() for r in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh", action="store_true",
                    help="the replicated route: every torchrun rank steps the same batch")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend with --mesh (default: nccl on cuda, gloo "
                         "on cpu)")
    args = ap.parse_args(argv)

    cfg = smoke_config(get_arch(args.arch))
    if cfg.family == "encdec":
        raise ValueError(
            f"{args.arch}: the serving engine runs the decoder-only families; the JAX "
            "package's engine does not serve the encoder-decoder either (its init_lm_cache "
            "raises for it). Its decode is models/encdec.py's init_encdec_cache, "
            "encdec_prefill and encdec_decode_step, driven by a greedy loop")
    device = resolve_device(args.device)
    if not args.mesh:
        return serve(cfg, args, device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise ValueError("--mesh runs one process per rank: launch it with torchrun")
    if device.type == "cuda":  # NCCL: one card per rank; gloo ranks may share
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        device = torch.device("cuda", local % torch.cuda.device_count())
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    group = coll.init_process_group(backend, device=device)
    try:
        serve(cfg, args, device, mesh=group)
    finally:
        coll.destroy_process_group()


def serve(cfg, args, device, mesh=None):
    """Serve ``args.requests`` prompts through the engine (on ``mesh``, a
    process group, every rank the same); rank 0 prints."""
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=128, device=device, mesh=mesh)
    for r, prompt in enumerate(prompts(args.requests, cfg.vocab)):
        eng.submit(Request(rid=r, prompt=prompt, max_new=args.max_new))
    t0 = time.time()
    iters = eng.run()
    dt = time.time() - t0
    toks = args.requests * args.max_new
    if mesh is not None and coll.group_rank(mesh) != 0:
        return
    on = "" if mesh is None else f", {coll.group_size(mesh)} ranks agreeing"
    print(f"[serve] {args.requests} requests, {iters} engine iterations, "
          f"{toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s, "
          f"continuous batching over {args.slots} slots on {device}{on})")


if __name__ == "__main__":
    main()
