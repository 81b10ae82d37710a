"""Static wire-traffic accountant: bytes and collective counts, proven (port
of ``repro/analysis/traffic.py``).

From the :class:`~repro_torch.analysis.wire_audit.WireSpec`'s transport
declaration alone (per-leaf image sizes, codec, overlap mode, bucket size)
it reconstructs the transport the port's step must issue — the port's own,
``core/comm.py``'s ``CommCtx.psum_wire_start`` and ``_gather_wire_start``:

  * ``overlap="off"``: one psum node per microbatch image, whose leaves are
    the param leaves' word planes, carrying exactly the codec payload
    (``Σ wire_bytes(leaf)``, what ``Logged.pack_bytes`` meters per worker
    and image);
  * ``overlap="ring"``: one psum node per image whose leaves are the
    ``plan_bucket_sizes`` buckets of the same words. There is no chunk
    padding: the library's all-reduce is the ring (the reference's
    hand-written ppermute ring has no counterpart in the port);
  * gather transport (``wire_transport="gather"``, TopKInt): one all_gather
    node per image whose leaves are the buckets of the planes (one bucket
    serial, ``bucket_words`` ones under ring overlap).

— then walks the recorded trace and demands the observed wire collectives
match:

  T001  observed wire-collective BYTES ≠ the declared transport's (payload
        drift: a codec re-encoding, an accidental widening);
  T002  observed wire-collective node COUNT or LEAF count ≠ the declared
        transport's (transport-shape drift: a split, elided or duplicated
        collective, or a bucketing change).

Wire-collective identification (shared with :mod:`repro_torch.analysis
.schedule`): a collective node over a declared dp axis with an integer leaf,
of a kind that can carry the transport ({psum, ppermute, all_gather,
reduce_scatter, psum_scatter}). Bytes are one contribution's: what one
worker sends.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.wire_audit import Violation, WireSpec

__all__ = [
    "RULES",
    "WIRE_COLLECTIVE_PRIMS",
    "TransportPlan",
    "TrafficReport",
    "leaf_wire_words",
    "word_itemsize",
    "payload_bytes",
    "plan_bucket_sizes",
    "plan_transport",
    "wire_collective_nodes",
    "int_leaf_bytes",
    "account_traffic",
]

RULES = {
    "T001": "observed wire-collective bytes equal the declared transport "
            "model's (codec payload, one contribution)",
    "T002": "observed wire-collective node and leaf counts equal the declared "
            "transport model's (one node per image; its leaves the param "
            "leaves serially, the buckets under ring overlap or a gather)",
}

WIRE_COLLECTIVE_PRIMS = frozenset(
    {"psum", "ppermute", "all_gather", "reduce_scatter", "psum_scatter"}
)


# ---------------------------------------------------------------------------
# declared-side arithmetic (torch-free: mirrors repro_torch.wire)
# ---------------------------------------------------------------------------
def word_itemsize(kind: str, bits: int) -> int:
    """Transport word size in bytes: PackedInt and TopKInt always ride
    int32 words; DenseInt rides the narrowest native lane holding one value
    (``repro_torch.wire.dense._LANE``)."""
    if kind in ("packed", "topk"):
        return 4
    return 1 if bits <= 8 else (2 if bits <= 16 else 4)


def leaf_wire_words(kind: str, bits: int, size: int, *, k: int = 0) -> int:
    """Transport words one leaf of ``size`` elements packs into
    (``PackedInt.words_len``, DenseInt's identity layout, TopKInt's index
    plane + bit-packed value plane)."""
    if kind == "packed":
        f = 32 // bits
        return -(-int(size) // f)
    if kind == "topk":
        k_eff = min(int(k), int(size)) if k else int(size)
        f = 32 // bits
        return k_eff + -(-k_eff // f)
    return int(size)


def payload_bytes(kind: str, bits: int, size: int, *, k: int = 0) -> int:
    """Exact wire bytes for one leaf — equals ``WireFormat.wire_bytes(size)``
    and therefore what ``Logged`` meters per pack call."""
    return leaf_wire_words(kind, bits, size, k=k) * word_itemsize(kind, bits)


def plan_bucket_sizes(total_words: int, bucket_words: int) -> Tuple[int, ...]:
    """Bucket word counts for a ``total_words`` payload — the same cut as
    ``repro_torch.wire.bucketing.plan_buckets`` (full buckets + ragged
    tail)."""
    if bucket_words <= 0:
        raise ValueError(f"bucket_words must be positive, got {bucket_words}")
    full, tail = divmod(int(total_words), int(bucket_words))
    return (bucket_words,) * full + ((tail,) if tail else ())


@dataclasses.dataclass(frozen=True)
class TransportPlan:
    """The node-level transport a spec declares, per STEP (all microbatch
    images)."""

    payload_bytes: int      # codec payload, one image (== Logged per image)
    total_words: int        # transport words, one image
    n_buckets: int          # 0 on the serial psum route
    n_eqns: int             # wire collective nodes the whole step must issue
    n_leaves: int           # their leaves, summed
    coll_bytes: int         # total leaf bytes those nodes carry
    padding_bytes: int      # always 0: no route of the port pads
    by_prim: Dict[str, int]  # kind -> node count (whole step)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["by_prim"] = dict(d["by_prim"])
        return d


def plan_transport(spec: WireSpec) -> Optional[TransportPlan]:
    """Reconstruct the declared transport from the spec alone — or None when
    the spec carries no leaf sizes (hand-built specs can't be accounted)."""
    if not spec.leaf_sizes:
        return None
    kind, bits = spec.wire_kind, spec.bits
    itemsize = word_itemsize(kind, bits)
    words = [leaf_wire_words(kind, bits, s, k=spec.topk_k) for s in spec.leaf_sizes]
    total_words = sum(words)
    payload = total_words * itemsize
    m = spec.n_accum
    if spec.wire_transport == "gather":
        # CommCtx._gather_wire_start: the planes bucketized, at bucket_words
        # under ring overlap and as ONE bucket otherwise, one all_gather
        if spec.overlap == "ring" and spec.bucket_words:
            buckets = plan_bucket_sizes(total_words, spec.bucket_words)
        else:
            buckets = (total_words,) if total_words else ()
        prim, n_leaves, n_buckets = "all_gather", len(buckets), len(buckets)
    elif spec.overlap == "ring":
        buckets = plan_bucket_sizes(total_words, spec.bucket_words or total_words)
        prim, n_leaves, n_buckets = "psum", len(buckets), len(buckets)
    else:
        prim, n_leaves, n_buckets = "psum", len(words), 0
    return TransportPlan(
        payload_bytes=payload, total_words=total_words, n_buckets=n_buckets,
        n_eqns=m, n_leaves=n_leaves * m, coll_bytes=payload * m, padding_bytes=0,
        by_prim={prim: m},
    )


# ---------------------------------------------------------------------------
# observed side: walk the trace
# ---------------------------------------------------------------------------
def int_leaf_bytes(node) -> int:
    return sum(lf.nbytes for lf in node.leaves if lf.kind in ("i", "u"))


def wire_collective_nodes(trace, dp_axes) -> List:
    """Every wire collective node: a WIRE_COLLECTIVE_PRIMS node over any dp
    axis with an integer leaf."""
    dp = set(dp_axes)
    return [n for n in trace.nodes
            if n.kind == "collective" and n.name in WIRE_COLLECTIVE_PRIMS and n.axis in dp
            and int_leaf_bytes(n) > 0]


@dataclasses.dataclass
class TrafficReport:
    """Declared-vs-observed wire traffic for one recorded step."""

    plan: Optional[TransportPlan]
    observed_eqns: int
    observed_leaves: int
    observed_bytes: int
    observed_by_prim: Dict[str, int]     # kind -> node count
    observed_bytes_by_prim: Dict[str, int]
    violations: Tuple[Violation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "declared": self.plan.to_dict() if self.plan else None,
            "observed_eqns": self.observed_eqns,
            "observed_leaves": self.observed_leaves,
            "observed_bytes": self.observed_bytes,
            "observed_by_prim": dict(self.observed_by_prim),
            "observed_bytes_by_prim": dict(self.observed_bytes_by_prim),
            "violations": [v.to_dict() for v in self.violations],
            "ok": self.ok,
        }


def account_traffic(trace, spec: WireSpec) -> TrafficReport:
    """Tally the recorded step's wire collectives and prove them equal to
    the spec's declared transport (T001 bytes, T002 node and leaf counts)."""
    by_prim: Dict[str, int] = {}
    bytes_by_prim: Dict[str, int] = {}
    n_nodes = n_leaves = n_bytes = 0
    for node in wire_collective_nodes(trace, spec.dp_axes):
        b = int_leaf_bytes(node)
        by_prim[node.name] = by_prim.get(node.name, 0) + 1
        bytes_by_prim[node.name] = bytes_by_prim.get(node.name, 0) + b
        n_nodes += 1
        n_leaves += sum(1 for lf in node.leaves if lf.kind in ("i", "u"))
        n_bytes += b

    violations: List[Violation] = []
    plan = plan_transport(spec)
    where = f"wire@{','.join(spec.dp_axes)}"
    if plan is not None:
        if n_bytes != plan.coll_bytes:
            violations.append(Violation(
                "T001", where,
                f"observed wire-collective bytes {n_bytes} != declared transport "
                f"{plan.coll_bytes} (codec payload {plan.payload_bytes} B/image × "
                f"M={spec.n_accum}; per-kind observed {bytes_by_prim})"))
        if n_nodes != plan.n_eqns or n_leaves != plan.n_leaves:
            violations.append(Violation(
                "T002", where,
                f"observed {n_nodes} wire collective(s) {by_prim} with {n_leaves} leaves != "
                f"declared {plan.n_eqns} {plan.by_prim} with {plan.n_leaves} leaves "
                f"({spec.overlap} route, {plan.n_buckets or 'no'} bucket(s), "
                f"M={spec.n_accum})"))
    return TrafficReport(
        plan=plan, observed_eqns=n_nodes, observed_leaves=n_leaves, observed_bytes=n_bytes,
        observed_by_prim=by_prim, observed_bytes_by_prim=bytes_by_prim,
        violations=tuple(violations))
