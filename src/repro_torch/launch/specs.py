"""Which dimension of each parameter leaf the model axis shards (port of
``repro/launch/specs.py``'s ``param_shapes``, ``infer_param_specs`` and
``global_tree_dims``).

As in the JAX package the specs are derived, not written down: the leaf
shapes with ``n_shards=1`` (global, padded for tp) and with
``n_shards=tp`` (one rank's) are diffed, and the one dimension that
differs by exactly ×tp is the sharded one; a leaf whose shapes agree is
replicated. So the table cannot drift from the model code. A spec here is
that dimension's index, or None. The cache specs wait for TP serving
(ROADMAP item 12.6c), the dry-run parts for item 12.8.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.core.stats import TreeDims
from repro_torch.models import encdec, transformer
from repro_torch.models.common import TpShard

Shapes = Dict[str, tuple]
Specs = Dict[str, Optional[int]]


def param_shapes(cfg, tp: int = 1, n_shards: int = 1) -> Shapes:
    """Leaf name -> shape: global and padded for ``tp`` with ``n_shards=1``,
    one rank's with ``n_shards=tp``; the encoder-decoder's from
    ``models/encdec.py``, every other family's from
    ``models/transformer.py``."""
    fn = encdec.param_shapes if cfg.family == "encdec" else transformer.param_shapes
    return fn(cfg, tp, n_shards)


def infer_param_specs(cfg, tp: int) -> Tuple[Shapes, Shapes, Specs]:
    """``(global_shapes, local_shapes, specs)``; a leaf's spec is the
    dimension the model axis shards, or None where it is replicated."""
    g = param_shapes(cfg, tp, 1)
    lo = param_shapes(cfg, tp, tp)

    def spec(gl: tuple, loc: tuple) -> Optional[int]:
        if gl == loc:
            return None
        diff = [i for i, (a, b) in enumerate(zip(gl, loc)) if a != b]
        if len(gl) != len(loc) or len(diff) != 1 or gl[diff[0]] != loc[diff[0]] * tp:
            raise ValueError(f"ambiguous sharding: {gl} vs {loc}")
        return diff[0]

    return g, lo, {k: spec(g[k], lo[k]) for k in g}


def global_tree_dims(cfg, tp: int) -> TreeDims:
    """The GLOBAL model dimensionality (α's d and each leaf's d_l for
    blockwise α): the global shapes padded for tp, keyed by the leaf
    names every rank's local shards carry."""
    g = param_shapes(cfg, tp, 1)
    return TreeDims(d=sum(math.prod(s) for s in g.values()),
                    leaf_dims={k: float(math.prod(s)) for k, s in g.items()})


def tp_shard(cfg, tp: int, tp_index: int) -> TpShard:
    """Rank ``tp_index``'s slice of a global tree over ``tp`` (the specs of
    :func:`infer_param_specs`)."""
    return TpShard(specs=infer_param_specs(cfg, tp)[2], index=tp_index, size=tp)
