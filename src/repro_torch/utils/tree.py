"""Helpers over the port's parameter trees: flat ``{leaf name: tensor}``
dicts (port of the helpers of ``repro/utils/tree.py`` the train path uses).

Leaf names join the JAX pytree's dict keys with "/" (``layers/attn/wq``);
sorting them gives ``jax.tree.flatten``'s leaf order, which fixes each
leaf's encode seed."""
from __future__ import annotations

from typing import Dict, List

import torch

Tree = Dict[str, torch.Tensor]


def leaf_names(tree: Tree) -> List[str]:
    """Leaves in ``jax.tree.flatten`` order."""
    return sorted(tree)


def tree_size(tree: Tree) -> int:
    """Total number of scalar entries d (python int)."""
    return int(sum(v.numel() for v in tree.values()))


def tree_abs_max(tree: Tree) -> torch.Tensor:
    """max |leaf value| over all leaves, as f32 (wire-width metrics)."""
    return torch.stack(
        [torch.max(torch.abs(v)).to(torch.float32) for v in tree.values()]
    ).max()
