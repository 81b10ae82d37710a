"""A data × model grid of ranks (port of ``repro/launch/mesh.py``'s
``make_debug_mesh``).

The JAX package names its mesh axes ("data", "model") and runs one
``shard_map`` over them. Here every rank is one process of a
``torch.distributed`` world of ``n_data · n_model`` ranks, numbered
dp-major as ``runtime/elastic.py`` assumes: ``rank = dp_index · tp +
tp_index``. Each rank gets two groups:

- its **data group**, the ``n_data`` ranks with its tp index: the
  data-parallel workers whose integer images are summed (one per dp
  replica; ``CommCtx.on_group`` over it, ``worker_index()`` the dp index);
- its **model group**, the ``n_model`` ranks with its dp index: the
  members of one tensor-parallel replica, over which the models' psums,
  pmaxes and all-to-alls run (``models.common.Axes``).

``make_production_mesh`` does not port: it names a 256-device TPU pod.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the data × model grid and its two groups."""

    n_dp: int
    tp: int
    dp_index: int
    tp_index: int
    data_group: Any
    model_group: Any


def make_debug_mesh(n_data: int = 2, n_model: int = 2, ranks=None) -> Optional[Grid]:
    """The grid of the default process group, which must hold ``n_data ·
    n_model`` ranks, or of the world ranks ``ranks`` (that many; the
    survivors an elastic re-plan keeps, in dp-major order), on which a rank
    outside them gets None. Every rank of the world calls it; it makes every
    data and model group on every rank, in the same order, as
    ``new_group`` requires."""
    size = coll.world_size()
    ranks = list(range(size)) if ranks is None else list(ranks)
    if n_data < 1 or n_model < 1 or n_data * n_model != len(ranks):
        raise ValueError(
            f"a {n_data} × {n_model} (data × model) grid needs {n_data * n_model} ranks; "
            f"the process group has {len(ranks)}")
    me = coll.world_rank()
    pos = ranks.index(me) if me in ranks else None
    dp_index, tp_index = divmod(pos if pos is not None else 0, n_model)
    data_group = model_group = None
    for t in range(n_model):
        g = coll.new_group([ranks[d * n_model + t] for d in range(n_data)])
        if t == tp_index:
            data_group = g
    for d in range(n_data):
        g = coll.new_group([ranks[d * n_model + t] for t in range(n_model)])
        if d == dp_index:
            model_group = g
    if pos is None:
        return None
    return Grid(n_dp=n_data, tp=n_model, dp_index=dp_index, tp_index=tp_index,
                data_group=data_group, model_group=model_group)
