"""The dry run as a per-rank shape check (port of ``repro/launch/dryrun.py``).

The JAX package lowers and compiles every (arch × shape) cell on 512
placeholder TPU devices and reads XLA's memory and cost analyses against
TPU v5e peaks; none of that means anything on an H100. What carries over is
the arithmetic: for each cell on the production layout (data 16 × model
16, or pod 2 × data 16 × model 16), the leaves one rank holds as a step's
arguments, their bytes, whether they fit one card, and the model FLOPs a
chip. The leaves are built as tensors on the meta device from
``launch/specs.py`` and the state initialisers the step uses: no process
group, no allocation, no kernel, and no card is touched. A cell is held to
the published memory of the card the port targets (``CARD``).

The argument groups, one rank's:

- train (the ZeRO-1 route of ``launch/step.py``, as the JAX dry run builds
  it): ``params`` (bf16, the rank's model shard), ``opt`` (the ZeRO-1 f32
  master row and the optimizer state's rows), ``comp`` (the compressor's
  state), ``step`` (a host int in the port: no device bytes), ``seeds``
  (the (n_dp, n_leaves) int32 encode seeds the step takes in place of the
  JAX step's PRNG key) and ``batch`` (the rank's data replica's rows);
- prefill: ``params`` and ``batch``;
- decode: ``params``, ``cache`` (the rank's local cache), ``tokens`` and
  ``pos`` (the rows the rank decodes).

Token ids and positions are int64 (what the port's embedding and decode
take), where the JAX package's are int32. Activations are not counted.

    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k [--multi-pod] [--tp N]
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]

Each cell prints one JSON line; a cell that fails records its error and
the run goes on (exit code 0: read the lines).
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, get_arch, get_shape, runnable_cells
from repro_torch.core.compressor import make_compressor
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.inputs import TOKEN_DTYPE, input_specs
from repro_torch.launch.train import OPTIMIZERS
from repro_torch.models import encdec
from repro_torch.models.decode import init_lm_cache
from repro_torch.optim.zero1 import zero1_init

META = torch.device("meta")
# the production layouts (the JAX package's make_production_mesh)
DATA, MODEL = 16, 16
# the published memory of the card the port targets
CARD = ("NVIDIA H100 80GB HBM3", 80 * 10**9)
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")

Leaves = Dict[str, Tuple[tuple, torch.dtype]]


def model_flops_per_chip(cfg: ModelConfig, shape: ShapeConfig, n_chips: int) -> float:
    """6·N·D (train), 2·N·D (prefill), 2·N·B (decode, a token a sequence)
    over the active params (a MoE counts top_k + shared of its experts), a
    chip's share; N from the global shapes padded for tp = 16, as the JAX
    package counts."""
    g = specs_mod.param_shapes(cfg, 16, 1)
    n_total = int(sum(math.prod(s) for s in g.values()))
    n_active = n_total
    if cfg.n_experts:  # subtract the inactive experts' params
        expert_params = sum(
            int(math.prod(s)) for k, s in g.items()
            if any(part in EXPERT_LEAVES for part in k.split("/")) and len(s) == 4)
        n_active = n_total - expert_params + expert_params * (
            (cfg.top_k + cfg.n_shared_experts) / max(cfg.n_experts, 1))
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch / n_chips
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch / n_chips
    return 2.0 * n_active * shape.global_batch / n_chips


def _leaves(tree: Dict[str, torch.Tensor]) -> Leaves:
    return {k: (tuple(v.shape), v.dtype) for k, v in tree.items()}


def _nbytes(leaves: Leaves) -> int:
    return sum(math.prod(s) * d.itemsize for s, d in leaves.values())


def _meta(shapes: Dict[str, tuple], dtype) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, dtype=dtype, device=META) for k, s in shapes.items()}


def _flat(prefix: str, tree) -> Dict[str, torch.Tensor]:
    """A nested dict (or tuple, or dataclass) of tensors flattened to names."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if hasattr(tree, "__dataclass_fields__"):
        tree = {f: getattr(tree, f) for f in tree.__dataclass_fields__}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if v is not None:
            out.update(_flat(f"{prefix}/{k}" if prefix else str(k), v))
    return out


def arg_shapes(cfg: ModelConfig, shape: ShapeConfig, *, pods: int = 1, data: int = DATA,
               model: int = MODEL, compressor: str = "intsgd", opt: str = "sgd"
               ) -> Dict[str, Dict]:
    """Each argument group's leaves on one rank of a ``pods`` × ``data`` ×
    ``model`` grid (name -> (shape, dtype)) and their bytes: ``{group:
    {"leaves": ..., "bytes": ...}}``, in the step's argument order."""
    tp, n_dp = model, pods * data
    params = _meta(specs_mod.param_shapes(cfg, tp, tp), torch.bfloat16)
    groups: Dict[str, Leaves] = {"params": _leaves(params)}
    if shape.kind == "train":
        if shape.global_batch % n_dp:
            raise ValueError(f"global batch {shape.global_batch} does not split over {n_dp} "
                             "data replicas")
        comp = make_compressor(compressor)
        groups["opt"] = _leaves(_flat("", zero1_init(OPTIMIZERS[opt](), params, n_dp, rank=0)))
        groups["comp"] = _leaves(_flat("", comp.init(params, 1)))
        groups["step"] = {}
        groups["seeds"] = {"seeds": ((n_dp, len(params)), torch.int32)}
        rows = shape.global_batch // n_dp
        groups["batch"] = {k: ((rows, *s[1:]), d)
                           for k, (s, d) in input_specs(cfg, shape, "train").items()}
    elif shape.kind == "prefill":
        rows = max(1, shape.global_batch // n_dp)
        groups["batch"] = {k: ((rows, *s[1:]), d)
                           for k, (s, d) in input_specs(cfg, shape, "prefill").items()}
    else:
        seq_sharded = shape.global_batch < n_dp
        if seq_sharded:
            rows, s_local = shape.global_batch, shape.seq_len // n_dp
        else:
            rows, s_local = max(1, shape.global_batch // n_dp), shape.seq_len
        groups["cache"] = _cache_leaves(cfg, tp, rows, s_local, min(shape.seq_len, 32768))
        groups["tokens"] = {"tokens": ((rows,), TOKEN_DTYPE)}
        groups["pos"] = {"pos": ((rows,), TOKEN_DTYPE)}
    return {g: {"leaves": leaves, "bytes": _nbytes(leaves)} for g, leaves in groups.items()}


def _cache_leaves(cfg: ModelConfig, tp: int, b: int, s: int, s_src: int) -> Leaves:
    """The rank's local decode cache, built on the meta device."""
    if cfg.family == "encdec":
        cache = encdec.init_encdec_cache(cfg, b, s, s_src, device=META, tp=tp, n_shards=tp)
    else:
        cache = init_lm_cache(cfg, b, s, device=META, tp=tp, n_shards=tp)
    return _leaves(cache)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, tp: int = MODEL) -> Dict:
    cfg, shape = get_arch(arch), get_shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod}
    if shape_name == "long_500k" and not cfg.subquadratic:
        return {**rec, "skipped": "full-attention arch (long_500k needs a subquadratic one)"}
    pods = 2 if multi_pod else 1
    groups = arg_shapes(cfg, shape, pods=pods, data=DATA, model=tp)
    total = sum(g["bytes"] for g in groups.values())
    n_chips = pods * DATA * tp
    return {
        **rec, "grid": {"pods": pods, "data": DATA, "model": tp, "ranks": n_chips},
        "compressor": "intsgd" if shape.kind == "train" else None,
        "gib_per_rank": {g: v["bytes"] / 2**30 for g, v in groups.items()},
        "args_gib_per_rank": total / 2**30,
        "card": CARD[0], "card_gib": CARD[1] / 2**30,
        "args_fit_card": total <= CARD[1],
        "activations": "not counted",
        "model_flops_per_chip": model_flops_per_chip(cfg, shape, n_chips),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tp", type=int, default=MODEL,
                    help="ranks on the model axis (the production layout's 16)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a, s, runnable in runnable_cells() if runnable]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, args.multi_pod, args.tp)
        except Exception as e:  # recorded, and the sweep goes on
            rec = {"arch": arch, "shape": shape, "multi_pod": args.multi_pod,
                   "error": f"{type(e).__name__}: {e}"}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
