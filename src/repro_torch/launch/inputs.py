"""Every model input of a train step: names, shapes and types, and a random
batch of them (port of ``repro/launch/inputs.py``).

For the ``vlm`` family and the ``encdec`` family's audio the modality
frontend is a stub, as in the JAX package: the batch carries precomputed
patch or frame embeddings of the frontend's width, bf16. A vlm's text is
``n_frontend_tokens`` shorter than the shape's sequence; an encdec's
target is as long as its source (the JAX package's documented choice).

A batch is global: the train step gives each data-parallel worker its
contiguous share by the worker's dp index (``CommCtx.worker_index()``),
so on a data × model grid every TP member of one dp replica takes that
replica's share, not its rank's (the JAX package shards the batch over
the data axes only).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

# token ids and labels: int64, what ``F.embedding`` and the loss's gather take
TOKEN_DTYPE = torch.int64


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                kind: str = "train") -> Dict[str, Tuple[tuple, torch.dtype]]:
    """name -> (shape, dtype) of the batch a step of ``cfg`` takes at
    ``shape`` (global batch)."""
    b, t = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        specs = {"frames": ((b, t, cfg.frontend_dim), torch.bfloat16)}
        if kind == "train":  # teacher forced, target length = source length
            specs["tokens"] = ((b, t), TOKEN_DTYPE)
            specs["labels"] = ((b, t), TOKEN_DTYPE)
        return specs
    t_text = t - cfg.n_frontend_tokens if cfg.frontend == "vit" else t
    specs = {"tokens": ((b, t_text), TOKEN_DTYPE)}
    if cfg.frontend == "vit":
        specs["patch_embeds"] = ((b, cfg.n_frontend_tokens, cfg.frontend_dim),
                                 torch.bfloat16)
    if kind == "train":
        specs["labels"] = ((b, t_text), TOKEN_DTYPE)
    return specs


def materialize_batch(cfg: ModelConfig, shape: ShapeConfig, generator: torch.Generator,
                      device, kind: str = "train") -> Dict[str, torch.Tensor]:
    """A random batch with :func:`input_specs`' structure, on ``device``
    (``generator`` on the same device): token ids uniform in [0, vocab),
    patch or frame embeddings standard normal cast to bf16. The labels are the
    tokens themselves, as in the JAX package, which draws both from one
    key."""
    out = {}
    for name, (dims, dtype) in input_specs(cfg, shape, kind).items():
        if name == "labels":
            continue
        if dtype == TOKEN_DTYPE:
            out[name] = torch.randint(0, cfg.vocab, dims, generator=generator,
                                      device=device, dtype=dtype)
        else:
            out[name] = torch.randn(dims, generator=generator, device=device).to(dtype)
    if kind == "train":
        out["labels"] = out["tokens"].clone()
    return out
