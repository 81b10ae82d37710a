"""Model-update statistics feeding the adaptive α rules (port of
``repro/core/stats.py``, tp = 1: every worker holds the whole model, so the
local values are the global ones)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.utils.tree import tree_size


@dataclasses.dataclass(frozen=True)
class DxStats:
    """||Δx||² statistics."""

    sq: torch.Tensor  # scalar ||Δx||²
    leaf_sq: Dict[str, torch.Tensor]  # per-leaf ||Δx_l||²


@dataclasses.dataclass(frozen=True)
class TreeDims:
    """Dimensionality of the model (static)."""

    d: int  # total parameter count (α's d; per-leaf sizes join with blockwise α)


def local_tree_dims(tree) -> TreeDims:
    return TreeDims(d=tree_size(tree))


def scale_dx_stats(stats: DxStats, scale: float) -> DxStats:
    """Rescale ||Δx||² stats by scale² — the applied (momentum-amplified)
    update converted to the gradient-equivalent displacement the α rules
    expect (scale = Optimizer.dx_scale, e.g. 1-μ for heavy-ball SGD)."""
    if scale == 1.0:
        return stats
    s2 = scale * scale
    return DxStats(
        sq=stats.sq * s2, leaf_sq={k: v * s2 for k, v in stats.leaf_sq.items()}
    )
