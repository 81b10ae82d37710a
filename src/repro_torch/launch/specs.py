"""Which dimension of each parameter leaf the model axis shards, and of
each decode-cache and batch leaf the data and model axes shard (port of
``repro/launch/specs.py``).

As in the JAX package the specs are derived, not written down: the leaf
shapes with ``n_shards=1`` (global, padded for tp) and with
``n_shards=tp`` (one rank's) are diffed, and the one dimension that
differs by exactly ×tp is the sharded one; a leaf whose shapes agree is
replicated. So the table cannot drift from the model code. A spec here is
that dimension's index, or None. The cache specs follow fixed rules by
leaf name (the JAX package's ``_CACHE_BASE``), with the leading stacked
layer axes skipped: a :class:`CacheSpec` names the dimension the data axis
shards (the batch, or with ``seq_sharded`` the sequence) and the one the
model axis shards. The dry-run parts wait for ROADMAP item 12.8.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

from repro_torch.core.stats import TreeDims
from repro_torch.models import encdec, transformer
from repro_torch.models.decode import init_lm_cache
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


# cache leaf name -> (dims without the stacked axes, batch dim, seq dim, model
# dim), the JAX package's ``_CACHE_BASE``; "h" is the Mamba2 state (B, H, N, P)
# under "mamba/" and the sLSTM state (B, H, dh) under "blocks/", read by its
# prefix. The JAX table leaves its rank open and so counts a stacked state's
# layer axes as its own: its data axis lands on the first layer axis and its
# model axis on the second. Each rank's local state has the same shape and
# values either way (ROADMAP's reference behaviours); only the global layout
# of the "h" leaves differs, and the port keeps the one of the state's own
# batch and head axes
_CACHE_BASE = {
    "k": (4, 0, 1, 2),
    "v": (4, 0, 1, 2),
    "kv_pos": (2, 0, 1, None),
    "pos": (2, 0, 1, None),
    "c_kv": (3, 0, 1, None),
    "k_r": (3, 0, 1, None),
    "conv": (3, 0, None, 2),
    "h": (None, 0, None, 1),
    "C": (4, 0, None, 1),
    "n": (3, 0, None, 1),
    "c": (3, 0, None, 1),
}


class CacheSpec(NamedTuple):
    """The dimension of a cache leaf that the data axis shards (the batch,
    or the sequence when the cache is sequence-sharded; None: replicated
    over the data group) and the one the model axis shards (None:
    replicated over the model group)."""

    data: Optional[int]
    model: Optional[int]


def cache_shapes(cfg, tp: int, n_shards: int, b: int, s: int, s_src: Optional[int] = None
                 ) -> Shapes:
    """Leaf name -> shape of the decode cache of ``b`` sequences of ``s``
    slots: global over the model axis with ``n_shards=1``, one rank's with
    ``n_shards=tp`` (the encoder-decoder's cross cache of ``s_src``
    positions, ``s`` by default). Built on the meta device: no memory."""
    if cfg.family == "encdec":
        cache = encdec.init_encdec_cache(cfg, b, s, s_src or s, device="meta", tp=tp,
                                         n_shards=n_shards)
    else:
        cache = init_lm_cache(cfg, b, s, device="meta", tp=tp, n_shards=n_shards)
    return {k: tuple(v.shape) for k, v in cache.items()}


def cache_pspecs(shapes: Shapes, *, seq_sharded: bool) -> Dict[str, CacheSpec]:
    """Each cache leaf's :class:`CacheSpec`, by its last name with the
    stacked layer axes skipped: the batch dimension carries the data axis,
    or with ``seq_sharded`` (a batch smaller than the data replicas) the
    sequence dimension does and the batch is replicated (a recurrent state,
    which has no sequence, is then replicated over the data group); the KV
    heads, the Mamba2 and xLSTM heads carry the model axis."""
    out = {}
    for name, shape in shapes.items():
        last = name.rsplit("/", 1)[-1]
        if last not in _CACHE_BASE:
            raise ValueError(f"no cache rule for leaf {name}")
        nd, b_dim, s_dim, m_dim = _CACHE_BASE[last]
        if nd is None:
            nd = 4 if name.startswith("mamba/") else 3
        extra = len(shape) - nd
        if seq_sharded:
            data = None if s_dim is None else extra + s_dim
        else:
            data = extra + b_dim
        out[name] = CacheSpec(data, None if m_dim is None else extra + m_dim)
    return out


def batch_pspecs(shapes: Shapes, *, seq_sharded: bool = False) -> Specs:
    """Each batch leaf's data-sharded dimension: the batch (0), or None
    (replicated) for a sequence-sharded decode's tokens."""
    return {k: None if seq_sharded else 0 for k in shapes}
