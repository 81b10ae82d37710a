"""Static overlap-schedule analyzer: prove the wire is hideable on the
recorded dataflow (port of ``repro/analysis/schedule.py``).

The port's overlap design hides the integer all-reduce behind backward
compute (bucketed async reduces, microbatch pipelining: image m's reduce is
waited on after image m+1's backward). This module proves the schedule
STRUCTURALLY, per recorded step: build the dataflow graph
(:func:`repro_torch.analysis.trace.build_graph`), and for every wire
collective c compute

  * ancestors(c)   — nodes whose values flow INTO c (its issue frontier);
  * descendants(c) — nodes consuming c's result (its completion frontier);

everything in neither set is UNORDERED with c: the card may run it while c
is in flight. A collective is **overlap-eligible** when unordered work
exists — matmul FLOPs (``concurrent_flops`` > 0: the reduce can hide behind
compute, e.g. another microbatch's backward) or other wire transport
(``concurrent_wire_bytes`` > 0) — and **serialized** otherwise (the
monolithic serial psum: every matmul feeds it, nothing consumes until
decode).

The static roofline aggregates this per step: of all wire bytes, which
fraction rides collectives with concurrent matmul FLOPs
(``hidden_fraction``) or with ANY unordered work
(``interleavable_fraction``), plus the step's matmul FLOPs
(``backward_flops``: every matmul, forward and backward, as the reference
names it) and per-collective FLOPs and bytes.

P-rules (schedule violations; W = wire_audit, T = traffic, C = lint):

  P001  pipelining structurally broken — a wire collective's RESULT feeds
        a matmul that another wire collective depends on: the later image's
        backward cannot start until the earlier reduce lands.
  P002  wasted wire work — a dead wire collective (its result reaches
        neither the step's returned tensors nor the tensors it wrote in
        place), a duplicate (identical operands and axis), or a redundant
        integer cast round-trip (dtype A -> B -> A) on the wire path.
  P003  fused-route HBM byte budget — each fused kernel node may read at
        most the codec's wire payload for its image as integers (packed:
        4·⌈d/k⌉ B; dense: d·lane B); an integer operand above that budget
        is an HBM round-trip the one-pass contract forbids.

:func:`full_audit` composes the W/P/T layers over ONE trace;
``build_train_step(verify="static")`` and the ``--matrix`` CLI run exactly
that.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import trace as tr
from repro_torch.analysis import traffic as tf
from repro_torch.analysis import wire_audit as wa
from repro_torch.analysis.wire_audit import Violation, WireSpec

__all__ = [
    "RULES",
    "ScheduleReport",
    "FullReport",
    "analyze_schedule",
    "dot_flops",
    "full_audit",
    "verify_step",
]

RULES = {
    "P001": "no wire collective's result feeds compute another wire "
            "collective depends on (microbatch pipelining stays structural)",
    "P002": "no dead/duplicate wire collectives, no redundant cast "
            "round-trips on the wire path",
    "P003": "fused kernel integer operands stay within the codec's per-image "
            "wire-payload byte budget (one HBM pass)",
}

_SDPA_FWD = frozenset({
    "_scaled_dot_product_efficient_attention", "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_flash_attention_for_cpu",
    "_efficient_attention_forward", "_flash_attention_forward",
})
_SDPA_BWD = frozenset(f"{n}_backward" for n in _SDPA_FWD)


def dot_flops(node, trace) -> float:
    """FLOPs of one matmul node: 2·batch·M·N·K for ``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, ``linear``; for the fused attention ops
    2·B·H·Tq·Tk·(D + Dv) forward (QKᵀ and PV) and twice that backward (dQ,
    dK, dV and dP), whatever the mask."""
    if node.kind != "op":
        return 0.0
    op = node.op

    def shape(i):
        a = node.args[i] if i < len(node.args) else None
        return trace.values[a.vid].shape if isinstance(a, tr.Ref) else None

    if op in ("mm", "bmm"):
        a, b = shape(0), shape(1)
        if a is None or b is None:
            return 0.0
        return 2.0 * math.prod(a) * b[-1]
    if op in ("addmm", "baddbmm"):
        a, b = shape(1), shape(2)
        if a is None or b is None:
            return 0.0
        return 2.0 * math.prod(a) * b[-1]
    if op == "linear":
        a, w = shape(0), shape(1)
        if a is None or w is None:
            return 0.0
        return 2.0 * math.prod(a) * w[0]
    if op in _SDPA_FWD or op in _SDPA_BWD:
        # (q, k, v, ...) forward; (grad_out, q, k, v, ...) backward
        q, k, v = (shape(0), shape(1), shape(2)) if op in _SDPA_FWD else (
            shape(1), shape(2), shape(3))
        if q is None or k is None or v is None:
            return 0.0
        f = 2.0 * math.prod(q[:-1]) * k[-2] * (q[-1] + v[-1])
        return f if op in _SDPA_FWD else 2.0 * f
    return 0.0


@dataclasses.dataclass
class ScheduleReport:
    """Per-collective overlap classification + the static roofline."""

    collectives: List[dict]          # one row per wire collective
    n_wire_collectives: int
    n_serialized: int
    total_wire_bytes: int
    hideable_bytes: int              # on collectives with concurrent FLOPs
    interleavable_bytes: int         # on collectives with ANY unordered work
    backward_flops: float            # every matmul's FLOPs in the step
    violations: Tuple[Violation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def hidden_fraction(self) -> float:
        return self.hideable_bytes / self.total_wire_bytes if self.total_wire_bytes else 0.0

    @property
    def interleavable_fraction(self) -> float:
        return (self.interleavable_bytes / self.total_wire_bytes
                if self.total_wire_bytes else 0.0)

    def to_dict(self) -> dict:
        return {
            "collectives": list(self.collectives),
            "n_wire_collectives": self.n_wire_collectives,
            "n_serialized": self.n_serialized,
            "total_wire_bytes": self.total_wire_bytes,
            "hideable_bytes": self.hideable_bytes,
            "interleavable_bytes": self.interleavable_bytes,
            "hidden_fraction": round(self.hidden_fraction, 6),
            "interleavable_fraction": round(self.interleavable_fraction, 6),
            "backward_flops": self.backward_flops,
            "violations": [v.to_dict() for v in self.violations],
            "ok": self.ok,
        }


def _where(node, idx: int) -> str:
    lf = node.leaves[0] if node.leaves else None
    desc = f" {lf.dtype}{tuple(lf.shape)}" if lf is not None else ""
    return f"{node.name}#{idx}@{node.axis}{desc}"


def analyze_schedule(trace, spec: WireSpec) -> ScheduleReport:
    """Classify every wire collective of a recorded step as overlap-eligible
    or serialized, check P001/P002/P003, and derive the static roofline."""
    graph = tr.build_graph(trace)
    flops: Dict[int, float] = {}
    for node in trace.nodes:
        f = dot_flops(node, trace)
        if f:
            flops[node.index] = f
    total_flops = float(sum(flops.values()))

    wire = tf.wire_collective_nodes(trace, spec.dp_axes)
    anc = [tr.backward_nodes(n.inputs, graph) for n in wire]
    desc = [tr.forward_nodes(n.outputs, graph) for n in wire]
    anc_union: set = set().union(*anc) if anc else set()

    violations: List[Violation] = []
    rows: List[dict] = []
    n_serialized = 0
    total_bytes = hideable = interleavable = 0
    wire_bytes = [tf.int_leaf_bytes(n) for n in wire]

    for i, node in enumerate(wire):
        conc_flops = sum(f for j, f in flops.items() if j not in anc[i] and j not in desc[i])
        conc_wire = sum(wire_bytes[j] for j in range(len(wire))
                        if j != i and wire[j].index not in anc[i]
                        and wire[j].index not in desc[i])
        eligible = conc_flops > 0 or conc_wire > 0
        b = wire_bytes[i]
        total_bytes += b
        if conc_flops > 0:
            hideable += b
        if eligible:
            interleavable += b
        else:
            n_serialized += 1
        rows.append({
            "where": _where(node, i),
            "bytes": b,
            "concurrent_flops": conc_flops,
            "concurrent_wire_bytes": conc_wire,
            "eligible": eligible,
        })
        # P001: result feeds compute an(other) wire collective waits on
        broken = [j for j in desc[i] if j in flops and j in anc_union and j not in anc[i]]
        if broken:
            violations.append(Violation(
                "P001", _where(node, i),
                f"collective result feeds {len(broken)} matmul node(s) that another wire "
                f"collective depends on — the later image's backward stalls on this "
                f"reduce; pipelining is structurally broken (decode must happen after the "
                f"last image's reduce is issued)"))

    # ---- P002: dead / duplicate collectives, cast round-trips -----------
    live = tr.backward_nodes(trace.outputs, graph)
    seen: Dict[tuple, int] = {}
    for i, node in enumerate(wire):
        if node.index not in live:
            violations.append(Violation(
                "P002", _where(node, i),
                "dead wire collective: its result never reaches the step outputs — wire "
                "bytes spent on nothing"))
        key = (node.name, node.axis, node.inputs)
        if key in seen:
            violations.append(Violation(
                "P002", _where(node, i),
                f"duplicate wire collective: identical operands and axis as collective "
                f"#{seen[key]} — the same sum crosses the wire twice"))
        else:
            seen[key] = i

    # integer cast round-trips on the wire path (upstream of reducing operands)
    roots = [v for n in wire if n.name in tr.REDUCING_COLLECTIVES
             for lf, vids in zip(n.leaves, n.leaf_inputs) if lf.kind in ("i", "u")
             for v in vids]
    if roots:
        upstream = wa.backward_wire_nodes(roots, graph)
        casts = ("_to_copy", "to")
        for i in sorted(upstream):
            node = trace.nodes[i]
            if node.kind != "op" or node.op not in casts or not node.inputs:
                continue
            src = node.args[0].vid if node.args and isinstance(node.args[0], tr.Ref) else None
            first = graph.defs.get(src) if src is not None else None
            if (first is None or first.index not in upstream or first.kind != "op"
                    or first.op not in casts or not first.args
                    or not isinstance(first.args[0], tr.Ref)):
                continue
            d0 = trace.values[first.args[0].vid]
            d1 = trace.values[src]
            d2 = trace.values[node.outputs[0]]
            # integer round-trips only: float cast chains upstream (f32 ->
            # bf16 compute -> f32 grads) are the mixed-precision recipe
            if (d0.dtype == d2.dtype and d1.dtype != d0.dtype
                    and all(d.kind in ("i", "u") for d in (d0, d1, d2))):
                violations.append(Violation(
                    "P002", f"_to_copy {d0.dtype}->{d1.dtype}->{d2.dtype}",
                    "redundant cast round-trip on the wire path: the value returns to its "
                    "original dtype (dead weight if lossless, a truncation bug if not)"))

    # ---- P003: fused-route per-kernel HBM byte budget --------------------
    if spec.fused:
        for node in trace.nodes:
            if node.kind != "kernel" or node.name not in wa.FUSED_KERNELS:
                continue
            image = max((trace.values[v].nelem for v in node.inputs + node.outputs
                         if trace.values[v].kind == "f"), default=0)
            if not image:
                continue
            budget = tf.payload_bytes(spec.wire_kind, spec.bits, image)
            for v in node.inputs:
                val = trace.values[v]
                if val.kind not in ("i", "u") or val.nelem <= spec.scalar_allowance:
                    continue
                if val.nbytes > budget:
                    violations.append(Violation(
                        "P003", f"{node.name} {val.dtype}{tuple(val.shape)}",
                        f"integer kernel operand of {val.nbytes} B exceeds the "
                        f"{spec.wire_kind}{spec.bits} wire-payload budget {budget} B for its "
                        f"{image}-element image — an HBM round-trip the one-pass fused route "
                        f"forbids"))

    return ScheduleReport(
        collectives=rows, n_wire_collectives=len(wire), n_serialized=n_serialized,
        total_wire_bytes=total_bytes, hideable_bytes=hideable,
        interleavable_bytes=interleavable, backward_flops=total_flops,
        violations=tuple(violations))


# ---------------------------------------------------------------------------
# the composed W + P + T audit
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FullReport:
    """One trace, all three static layers: wire audit (W), schedule (P),
    traffic (T). ``violations`` merges the kept violations of every layer;
    suppression spans all of them (rule ids are disjoint by prefix)."""

    audit: wa.AuditReport
    schedule: ScheduleReport
    traffic: tf.TrafficReport
    suppressed: Tuple[Tuple[Violation, str], ...]

    @property
    def violations(self) -> Tuple[Violation, ...]:
        return self.audit.violations + self.schedule.violations + self.traffic.violations

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_failed(self):
        if not self.ok:
            lines = "\n".join(f"  {v}" for v in self.violations)
            raise wa.WireAuditError(
                f"static audit failed ({len(self.violations)} violation(s)):\n{lines}")

    def to_dict(self) -> dict:
        d = self.audit.to_dict()
        d["violations"] = [v.to_dict() for v in self.violations]
        d["suppressed"] = [{**v.to_dict(), "justification": j}
                           for v, j in self.audit.suppressed + self.suppressed]
        d["schedule"] = self.schedule.to_dict()
        d["traffic"] = self.traffic.to_dict()
        d["ok"] = self.ok
        return d


def full_audit(trace, spec: WireSpec, *,
               suppress: Optional[Dict[str, str]] = None) -> FullReport:
    """Run the W (wire), P (schedule) and T (traffic) rule families over one
    recorded step. ``suppress`` may waive any rule id, W/P/T alike."""
    suppress = wa._check_suppress(suppress, {**wa.RULES, **RULES, **tf.RULES})
    audit = wa.audit_trace(trace, spec,
                           suppress={r: j for r, j in suppress.items() if r in wa.RULES})
    schedule = analyze_schedule(trace, spec)
    traffic = tf.account_traffic(trace, spec)
    suppressed: List[Tuple[Violation, str]] = []

    def keep(report):
        kept = []
        for v in report.violations:
            if v.rule in suppress:
                suppressed.append((v, suppress[v.rule]))
            else:
                kept.append(v)
        report.violations = tuple(kept)

    keep(schedule)
    keep(traffic)
    return FullReport(audit=audit, schedule=schedule, traffic=traffic,
                      suppressed=tuple(suppressed))


def verify_step(artifacts, which: str = "compressed", args=None, **kw) -> FullReport:
    """Record one step of a built step and run the full W/P/T static audit
    against its attached spec — what ``build_train_step(verify="static")``
    runs (on the meta device unless ``args`` are given)."""
    return full_audit(wa.record_step(artifacts, which, args), artifacts.audit_spec, **kw)
