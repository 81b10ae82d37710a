"""Model-update statistics feeding the adaptive α rules (port of
``repro/core/stats.py``). These are a process's local values; with tensor
parallelism the train step reduces them over the model group
(``launch/step.py::_global_reduce_leaf_sq``)."""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Dict, Iterable, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.utils.tree import tree_size


@dataclasses.dataclass(frozen=True)
class DxStats:
    """||Δx||² statistics."""

    sq: torch.Tensor  # scalar ||Δx||²
    leaf_sq: Dict[str, torch.Tensor]  # per-leaf ||Δx_l||² (for blockwise α)


@dataclasses.dataclass(frozen=True)
class TreeDims:
    """Dimensionality of the model (static): α's d, and each leaf's d_l for
    blockwise α."""

    d: int  # total parameter count
    leaf_dims: Dict[str, float]  # leaf name -> its size, as a float


def local_dx_stats(
    delta: Union[Mapping, Iterable[Tuple[str, torch.Tensor]]]
) -> DxStats:
    """Each leaf's ||Δx_l||² through the block-norms kernel, and their sum.
    ``delta`` is a dict of leaves, or (name, tensor) pairs, which a caller
    can produce one at a time so that only one Δx_l is alive at once."""
    items = delta.items() if isinstance(delta, Mapping) else delta
    leaf_sq = {k: ops.sq_norm(x) for k, x in items}
    sq = (torch.sum(torch.stack(list(leaf_sq.values()))) if leaf_sq
          else torch.zeros((), dtype=torch.float32))
    return DxStats(sq=sq, leaf_sq=leaf_sq)


def local_tree_dims(tree) -> TreeDims:
    return TreeDims(
        d=tree_size(tree), leaf_dims={k: float(v.numel()) for k, v in tree.items()}
    )


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
