"""The floatless-wire auditor: static proof of the integer wire on a recorded
step (port of ``repro/analysis/wire_audit.py``).

Rules (W = wire; violations carry these ids):

  W001  floatless dp wire — no floating-dtype leaf on a REDUCING collective
        node over the data axis. Scalar loss/metric reductions (≤
        ``scalar_allowance`` elements) are allowed; ZeRO-1's float param
        all-gathers are a gather, not a reduce, and are exempt. Integer
        GATHERS above the allowance are wire payload and must be declared:
        allowed only when the spec's codec transport is "gather" (TopKInt's
        idx/vals planes) or overlap is "ring"; otherwise they are flagged as
        undeclared wire traffic.
  W002  wire range safety — every integer leaf of a reducing data-axis
        collective is *provably bounded* by the forward interval pass, fits
        its lane after the n-contribution sum, and the declared (kind, bits,
        n_workers, n_accum) chain proof (:func:`repro_torch.analysis
        .intervals.wire_chain_proof`) holds — also for every clip OBSERVED
        upstream of the wire: a clamp's bound on the plain path, or the
        ``lim`` an ``int_compress`` kernel node was called with (a clip
        looser than the declared §5.1 limit, e.g. a forgotten ``n_accum``,
        re-proves with the observed bound and fails).
  W003  fused-route image locality — with the packed codec the unpacked
        integer image must never go into a fused kernel: every fused kernel
        node reading an int32 operand of image size (rather than packed-word
        size) is flagged.

A collective node is a WIRE collective when it runs over the data axis and
carries an integer leaf. Suppression: ``suppress={"W00x":
"justification"}`` waives a rule for one audit; the justification is
recorded in the report (an empty one is rejected), mirroring the linter's
``# lint: allow(C00x) -- why``.

The auditor trusts the kernels' internal arithmetic (each is held bit-equal
to its plain version by the port's tests and on the card): every kernel
node's integer outputs get the declared stage bounds — an encode (float in,
int out) the accumulator's, a word kernel (int in, int out) the 32-bit word
range — as the reference does for its Pallas calls with ``use_kernels``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import intervals as iv
from repro_torch.analysis import trace as tr
from repro_torch.analysis.intervals import Interval, TOP

__all__ = [
    "RULES",
    "SCALAR_REDUCE_ALLOWANCE",
    "WIRE_PATH_OPS",
    "WireSpec",
    "Violation",
    "AuditReport",
    "WireAuditError",
    "audit_trace",
    "audit_step",
    "spec_for_step",
    "backward_wire_nodes",
    "kernel_lim",
]

RULES = {
    "W001": "no float operand on a reducing dp-axis collective; integer "
            "gathers only when the spec declares a gather-transport codec "
            "or the ring route (float gathers exempt)",
    "W002": "integer wire operands provably bounded; §5.1 guard-bit chain "
            "proof holds for declared AND trace-observed clip bounds",
    "W003": "packed fused route: unpacked integer image never goes into a "
            "fused kernel between wire and update",
}

_LANE_MAX = {"int8": 127, "int16": 32767}

# W001's escape hatch for float reductions that are METRICS, not gradient
# payload (the loss, the largest |image|): the reference's constant
SCALAR_REDUCE_ALLOWANCE = 64

# the fused decode + update kernels (the packed and dense routes)
FUSED_KERNELS = frozenset({"fused_unpack_sgd", "fused_unpack_adamw", "fused_apply_sgd",
                           "fused_apply_adamw"})
ENCODE_KERNEL = "int_compress"


class WireAuditError(AssertionError):
    """Raised by ``AuditReport.raise_if_failed`` / ``verify='static'``."""


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """The declared wire configuration one audit verifies against — the
    dp-axis tagging plus codec/pipelining facts ``build_train_step``
    attaches to its :class:`~repro_torch.launch.step.StepArtifacts`. The
    port's axes are its grid's: ``("data",)`` carries the wire,
    ``axis_sizes`` holds the data and model axes' sizes."""

    dp_axes: Tuple[str, ...]
    axis_sizes: Dict[str, int]
    n_workers: int
    n_accum: int = 1
    wire_kind: str = "dense"  # "dense" | "packed" | "topk"
    bits: int = 32
    use_kernels: bool = False
    fused: bool = False
    scalar_allowance: int = SCALAR_REDUCE_ALLOWANCE
    # transport declaration: each LOCAL param leaf's element count in leaf
    # order, and the CommCtx's overlap and bucket size. Empty leaf_sizes =
    # unknown payload (hand-built specs): the traffic rules are skipped.
    leaf_sizes: Tuple[int, ...] = ()
    overlap: str = "off"
    bucket_words: int = 0
    wire_transport: str = "psum"  # "psum" | "gather"
    topk_k: int = 0

    @property
    def lim(self) -> int:
        """Declared clip limit for this codec: the §5.1 n·M-divided bound
        for summing transports, the full int-range for gather kinds."""
        return iv.declared_clip_limit(self.wire_kind, self.n_workers * self.n_accum, self.bits)

    @property
    def dp_sizes(self) -> Tuple[int, ...]:
        return tuple(self.axis_sizes.get(a, 1) for a in self.dp_axes)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["axis_sizes"] = dict(d["axis_sizes"])
        return d


def _unwrap_wire(wf):
    """WireFormat | Logged wrapper -> the underlying concrete format."""
    while hasattr(wf, "inner"):
        wf = wf.inner
    return wf


def spec_for_step(layout, wf, *, n_accum: int = 1, fused: bool = False) -> WireSpec:
    """The audit spec of a step from its :class:`~repro_torch.launch.step
    .Layout` and wire format: the codec facts, and the step's transport —
    each local leaf's element count (``layout.leaf_sizes``) and the
    overlap and bucket size of its ``CommCtx``. The port's encode always
    runs the kernel route (``use_kernels``)."""
    wf = _unwrap_wire(wf)
    ctx = layout.ctx
    return WireSpec(
        dp_axes=("data",),
        axis_sizes={"data": int(ctx.n), "model": int(layout.tp)},
        n_workers=int(ctx.n),
        n_accum=n_accum,
        wire_kind=str(wf.name),
        bits=int(wf.bits),
        use_kernels=True,
        fused=fused,
        leaf_sizes=tuple(int(s) for s in layout.leaf_sizes),
        overlap=ctx.overlap,
        bucket_words=int(ctx.bucket_words),
        wire_transport=str(getattr(wf, "transport", "psum")),
        topk_k=int(getattr(wf, "k", 0)),
    )


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    where: str  # kind@axis dtype(shape) — or chain:<stage> for proofs
    message: str

    def __str__(self):
        return f"[{self.rule}] {self.where}: {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AuditReport:
    spec: WireSpec
    proof: iv.ChainProof
    violations: Tuple[Violation, ...]
    suppressed: Tuple[Tuple[Violation, str], ...]
    stats: Dict[str, int]

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_failed(self):
        if not self.ok:
            lines = "\n".join(f"  {v}" for v in self.violations)
            raise WireAuditError(
                f"floatless-wire audit failed ({len(self.violations)} violation(s)):\n{lines}")

    def to_dict(self) -> dict:
        return {
            "spec": self.spec.to_dict(),
            "proof": {
                "lim": self.proof.lim,
                "stages": {k: [s.lo, s.hi] for k, s in self.proof.stages.items()},
            },
            "violations": [v.to_dict() for v in self.violations],
            "suppressed": [{**v.to_dict(), "justification": j} for v, j in self.suppressed],
            "stats": dict(self.stats),
            "ok": self.ok,
        }


# ---------------------------------------------------------------------------
# the wire path
# ---------------------------------------------------------------------------
# Ops a value may pass through between its §5.1 clip and the data-axis
# collective: rounding, scaling, lane casts, bit-packing, bucketing. The
# clip-attribution walk stops at anything else (matmuls, reductions), so
# data-path clips deep in the model — token-id clips, logit caps — are NOT
# mistaken for wire clips. Index-like ops pass only their source operand
# (``SOURCE_ONLY``): their index operand positions values, it does not
# carry them. schedule.py's P002 round-trip rule keys off the same walk.
WIRE_PATH_OPS = frozenset({
    "_to_copy", "to", "clone", "copy", "view", "_unsafe_view", "reshape",
    "expand", "squeeze", "unsqueeze", "permute", "t", "transpose", "slice", "select",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "cat", "stack", "pad",
    "constant_pad_nd", "add", "sub", "mul", "neg", "maximum",
    "minimum", "clamp", "clamp_min", "clamp_max", "clip", "abs", "sign", "floor",
    "round", "remainder", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "__lshift__", "__rshift__", "__and__",
    "__or__", "where", "alias", "detach", "contiguous", "flatten", "index", "index_select",
    "gather", "take", "index_put", "zeros", "zeros_like", "new_zeros",
    "_reshape_alias", "as_strided",
})
SOURCE_ONLY = {"index": (0,), "index_select": (0,), "gather": (0,), "take": (0,),
               "where": (1, 2), "index_put": (0, 2)}
# the kernels a wire value may pass through (the encode is where it starts)
WIRE_PATH_KERNELS = frozenset({"pack_words", "unpack_words"})
WIRE_PATH_COLLECTIVES = frozenset({"psum", "all_gather", "ppermute"})


def _functional(op: str) -> str:
    """An in-place op's name without its trailing underscore (``add_`` ->
    ``add``; ``__lshift__`` stays)."""
    return op[:-1] if op.endswith("_") and not op.endswith("__") else op


def _walk_inputs(node) -> List[int]:
    op = _functional(node.op)
    if node.kind == "op" and op in SOURCE_ONLY:
        vids = []
        for i in SOURCE_ONLY[op]:
            a = node.args[i] if i < len(node.args) else None
            vids.extend(r.vid for r in tr._refs(a))
        return vids + [old for _b, old, _v in node.aliases if old is not None]
    return list(node.inputs)


def backward_wire_nodes(roots, graph: tr.DataflowGraph) -> set:
    """Like :func:`trace.backward_nodes` but only walks THROUGH wire-path
    ops, the word kernels and the wire's own collectives; an encode kernel
    node is reached (it is the wire's clip) and not walked past."""
    seen: set = set()
    hit: set = set()
    stack = list(roots)
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        node = graph.defs.get(v)
        if node is None or node.index in hit:
            continue
        hit.add(node.index)
        if ((node.kind == "op" and _functional(node.op) in WIRE_PATH_OPS)
                or (node.kind == "kernel" and node.name in WIRE_PATH_KERNELS)
                or (node.kind == "collective" and node.name in WIRE_PATH_COLLECTIVES)):
            stack.extend(_walk_inputs(node))
    return hit


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------
def _fmt_where(node, leaf=None) -> str:
    if leaf is not None:
        return f"{node.name}@{node.axis} {leaf.dtype}{tuple(leaf.shape)}"
    return f"{node.name}#{node.index}"


def kernel_lim(node) -> Optional[int]:
    """The §5.1 clip an ``int_compress`` kernel node was called with:
    ``(2^(bits-1)-1) // n_workers``."""
    if node.kind != "kernel" or node.name != ENCODE_KERNEL:
        return None
    bits = node.kwargs.get("bits", 32)
    n = node.kwargs.get("n_workers", 1)
    if not isinstance(bits, int) or bits not in (4, 8, 16, 32) or not isinstance(n, int):
        return None
    return iv.safe_clip_limit(n, bits)


def _kernel_override(trace, proof: iv.ChainProof):
    """Trusted-kernel transfer: integer outputs of an encode-style kernel
    (a float operand in) get the declared accumulator bound, those of a
    word kernel (integer in, integer out) the 32-bit word range (bounded;
    field-level safety is the chain proof's job); float outputs TOP."""
    acc = proof.stages["accum"]
    word = Interval(-(2 ** 31), 2 ** 32 - 1)

    def run(node, ins):
        any_float_in = any(trace.values[v].kind == "f" for v in node.inputs)
        outs = []
        for v in node.outputs:
            if trace.values[v].kind == "i":
                outs.append(acc if any_float_in else word)
            else:
                outs.append(TOP)
        return outs

    return run


def _check_suppress(suppress, known) -> Dict[str, str]:
    suppress = dict(suppress or {})
    for rule, why in suppress.items():
        if rule not in known:
            raise ValueError(f"unknown rule {rule!r} in suppress")
        if not str(why).strip():
            raise ValueError(f"suppressing {rule} requires a non-empty justification")
    return suppress


def audit_trace(trace, spec: WireSpec, *,
                suppress: Optional[Dict[str, str]] = None) -> AuditReport:
    """Statically verify the floatless-wire contract on a recorded step."""
    suppress = _check_suppress(suppress, RULES)
    violations: List[Violation] = []
    proof = iv.wire_chain_proof(spec.wire_kind, spec.bits, spec.n_workers, spec.n_accum)
    for check_id, msg in proof.violations:
        violations.append(Violation("W002", f"chain:{check_id}", msg))

    # ---- forward interval pass ------------------------------------------
    env: Dict[int, Interval] = {}

    def on_node(node, ins, outs):
        for v, o in zip(node.inputs, ins):
            env[v] = o
        for v, o in zip(node.outputs, outs):
            env[v] = o

    iv.eval_trace_intervals(
        trace, kernel_overrides=_kernel_override(trace, proof) if spec.use_kernels else None,
        on_node=on_node)

    stats = {
        "nodes": len(trace.nodes),
        "dp_collectives": 0,
        "int_wire_ops": 0,
        "scalar_float_reduces": 0,
        "clips_checked": 0,
        "kernel_calls": sum(1 for n in trace.nodes if n.kind == "kernel"),
    }
    dp = set(spec.dp_axes)
    wire_roots: List[int] = []  # values of the integer leaves on the wire

    for node in trace.nodes:
        if node.kind != "collective" or node.axis not in dp:
            continue  # model-, seq- and stage-axis traffic: TP floats are by design
        stats["dp_collectives"] += 1
        reducing = node.name in tr.REDUCING_COLLECTIVES
        for leaf, vids in zip(node.leaves, node.leaf_inputs):
            where = _fmt_where(node, leaf)
            if not reducing:
                if leaf.kind != "i" or leaf.nelem <= spec.scalar_allowance:
                    continue  # float gathers (ZeRO-1 rows, the loss) move data
                if spec.wire_transport == "gather" or spec.overlap == "ring":
                    stats["int_wire_ops"] += 1
                    wire_roots.extend(vids)
                else:
                    violations.append(Violation(
                        "W001", where,
                        f"undeclared integer gather: {leaf.dtype} tensor of {leaf.nelem} "
                        f"elements rides a {tr.COLLECTIVES[node.name]} over the data axis, "
                        f"but the spec declares a '{spec.wire_transport}' transport with "
                        f"overlap='{spec.overlap}' — integer payload on a gather must come "
                        f"from a gather-transport codec"))
                continue
            if leaf.kind == "f":
                if leaf.nelem <= spec.scalar_allowance:
                    stats["scalar_float_reduces"] += 1
                else:
                    violations.append(Violation(
                        "W001", where,
                        f"float {leaf.dtype} tensor of {leaf.nelem} elements on a "
                        f"{tr.COLLECTIVES[node.name]} over the data axis — the wire must "
                        f"carry integers (scalar allowance is {spec.scalar_allowance} "
                        f"elements)"))
                continue
            if leaf.kind != "i":
                continue
            stats["int_wire_ops"] += 1
            wire_roots.extend(vids)
            ival = iv._union_all([env.get(v, TOP) for v in vids] or [TOP])
            if not ival.bounded:
                violations.append(Violation(
                    "W002", where,
                    "integer wire operand is not provably bounded — no clip dominates "
                    "this value on its way to the collective"))
                continue
            lane = _LANE_MAX.get(leaf.dtype)
            if lane is not None:
                post = ival.scale(node.n_contrib) if node.name != "ppermute" else ival
                if post.mag > lane:
                    violations.append(Violation(
                        "W002", where,
                        f"lane overflow: |value| ≤ {int(post.mag)} after the "
                        f"{node.n_contrib}-contribution sum exceeds the {leaf.dtype} range "
                        f"±{lane}"))

    # ---- observed-clip re-proof (the forgot-n_accum bug class) ---------
    if wire_roots:
        graph = tr.build_graph(trace)
        upstream = backward_wire_nodes(wire_roots, graph)
        # the §5.1 clip runs in the float domain just before the cast to the
        # lane type (round → clip → cast), so a clamp counts as a WIRE clip
        # when its output is integer OR is cast to an integer inside the
        # wire's backward slice
        int_cast_srcs: set = set()
        for i in upstream:
            node = trace.nodes[i]
            if (node.kind == "op" and node.op in ("_to_copy", "to", "copy_")
                    and node.outputs and trace.values[node.outputs[0]].kind == "i"):
                int_cast_srcs.update(_walk_inputs(node))
        for i in sorted(upstream):
            node = trace.nodes[i]
            lim = kernel_lim(node)
            if lim is not None:
                l_obs = lim
            elif node.kind == "op" and node.op in ("clamp", "clamp_", "clip"):
                lo = _bound(node.args[1] if len(node.args) > 1 else node.kwargs.get("min"), env)
                hi = _bound(node.args[2] if len(node.args) > 2 else node.kwargs.get("max"), env)
                if lo is None or hi is None or not (lo.bounded and hi.bounded):
                    continue
                out = node.outputs[0]
                if trace.values[out].kind != "i" and out not in int_cast_srcs:
                    continue
                l_obs = int(max(abs(lo.lo), abs(hi.hi)))
            else:
                continue
            stats["clips_checked"] += 1
            if l_obs <= spec.lim:
                continue
            re_proof = iv.wire_chain_proof(spec.wire_kind, spec.bits, spec.n_workers,
                                           spec.n_accum, lim=l_obs)
            for check_id, msg in re_proof.violations:
                violations.append(Violation(
                    "W002", f"{_fmt_where(node)}→wire",
                    f"observed clip |v| ≤ {l_obs} is looser than the declared §5.1 limit "
                    f"{spec.lim} and breaks the chain proof [{check_id}]: {msg}"))

    # ---- fused-route image locality ------------------------------------
    if spec.fused and spec.wire_kind == "packed":
        for node in trace.nodes:
            if node.kind != "kernel" or node.name not in FUSED_KERNELS:
                continue
            image = max((trace.values[v].nelem for v in node.outputs
                         if trace.values[v].kind == "f"), default=0)
            if not image:
                continue
            for v in node.inputs:
                val = trace.values[v]
                if val.kind == "i" and val.nelem > (image * 3) // 4:
                    violations.append(Violation(
                        "W003", f"{node.name} {val.dtype}{tuple(val.shape)}",
                        f"int32 kernel operand of {val.nelem} elements is image-sized "
                        f"(image {image}): the unpacked integer image took an HBM round-trip "
                        f"instead of riding the packed words (expected ≤ "
                        f"{-(-image // (32 // spec.bits))} words)"))

    kept: List[Violation] = []
    suppressed: List[Tuple[Violation, str]] = []
    for v in violations:
        if v.rule in suppress:
            suppressed.append((v, suppress[v.rule]))
        else:
            kept.append(v)
    return AuditReport(spec=spec, proof=proof, violations=tuple(kept),
                       suppressed=tuple(suppressed), stats=stats)


def _bound(a, env) -> Optional[Interval]:
    if a is None:
        return None
    if isinstance(a, tr.Ref):
        return env.get(a.vid, TOP)
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return Interval.point(a)
    return None


def audit_step(artifacts, which: str = "compressed", args=None, **kw) -> AuditReport:
    """Record one step of a built :class:`~repro_torch.launch.step
    .StepArtifacts` and audit it against the spec the builder attached
    (``audit_spec``): on ``args`` if given (the step runs on their device),
    else on the meta device with arguments built as the dry run builds
    them (``artifacts.meta_step``)."""
    trace = record_step(artifacts, which, args)
    return audit_trace(trace, artifacts.audit_spec, **kw)


def record_step(artifacts, which: str = "compressed", args=None):
    """The recorded trace of one step of ``artifacts`` (see
    :func:`audit_step`)."""
    if getattr(artifacts, "audit_spec", None) is None:
        raise ValueError(
            "StepArtifacts carries no audit_spec — build the step with "
            "repro_torch.launch.step.build_train_step with an integer-wire compressor, or "
            "pass audit_trace an explicit WireSpec")
    if args is None:
        step, args = artifacts.meta_step(which)
    else:
        step = artifacts.steps[which]
    return tr.record(step, *args)[1]
