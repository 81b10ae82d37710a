"""Interval abstract domain + the floatless-wire range proofs (port of
``repro/analysis/intervals.py``).

Two layers, both pure Python over exact integer arithmetic (no torch import
needed to USE the domain; the evaluator takes an already-recorded trace):

1. :class:`Interval` and :func:`eval_trace_intervals` — a forward abstract
   interpretation of a recorded step (:mod:`repro_torch.analysis.trace`) in
   the interval domain, the counterpart of the reference's
   ``eval_jaxpr_intervals``. Transfer functions cover the integer wire chain
   exactly (clamps, adds, subs and muls by integer constants, shifts,
   masks, sums, casts, ``where``, the scatter-adds and index-adds of the
   gather wire's decode, and the collectives, which sum their
   contributions); everything else widens to TOP. The trace is one flat
   scope, each op recorded as it ran, so there is no scan to unroll: the
   M-microbatch accumulation is M recorded adds.

2. :func:`wire_chain_proof` — the codec-level §5.1 proof for a declared
   (kind, bits, n_workers, n_accum): symbolic stage intervals for
   encode → M-accumulate → pack → n-worker wire sum → unpack, checked
   against the guard-bit invariant. ``lim`` may be overridden with a clip
   bound *observed in the trace* so a clip that is looser than the declared
   limit (the forgot-``n_accum`` bug class) fails the same proof.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Interval",
    "TOP",
    "eval_trace_intervals",
    "wire_chain_proof",
    "ChainProof",
    "int_range_max",
    "safe_clip_limit",
    "declared_clip_limit",
]

_INF = math.inf

# value range of a signed `bits`-wide field (the port's kernels.ref.INT_LIM,
# duplicated so this module stays importable without torch)
_INT_RANGE = {4: 7, 8: 127, 16: 32767, 32: 2147483647}


def int_range_max(bits: int) -> int:
    return _INT_RANGE[bits]


def safe_clip_limit(n_contrib: int, bits: int) -> int:
    """§5.1 limit ``(2^(b-1)-1)//n`` WITHOUT the WireRangeError raise —
    the proof reports lim==0 as a violation instead of throwing."""
    return _INT_RANGE[bits] // max(int(n_contrib), 1)


def declared_clip_limit(kind: str, n_contrib: int, bits: int) -> int:
    """The clip limit a (kind, bits) codec declares for ``n_contrib``
    summed contributions. Psum-transport kinds divide the value range by n
    (§5.1: the sum happens ON the wire); the gather-transport "topk" kind
    clips at the full range — nothing sums until the decode-side
    scatter-add, whose int32 bound is the chain proof's job."""
    if kind == "topk":
        return _INT_RANGE[bits]
    return safe_clip_limit(n_contrib, bits)


# --------------------------------------------------------------------------
# the domain
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed interval [lo, hi] over the extended reals; exact (Python int)
    endpoints wherever the program is exact."""

    lo: float
    hi: float

    def __post_init__(self):
        assert self.lo <= self.hi, (self.lo, self.hi)

    # -- queries ---------------------------------------------------------
    @property
    def bounded(self) -> bool:
        return self.lo != -_INF and self.hi != _INF

    @property
    def mag(self) -> float:
        """max |v| over the interval."""
        return max(abs(self.lo), abs(self.hi))

    def contains(self, v) -> bool:
        return self.lo <= v <= self.hi

    # -- lattice ---------------------------------------------------------
    def union(self, o: "Interval") -> "Interval":
        return Interval(min(self.lo, o.lo), max(self.hi, o.hi))

    # -- arithmetic ------------------------------------------------------
    def add(self, o: "Interval") -> "Interval":
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def sub(self, o: "Interval") -> "Interval":
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def neg(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def mul(self, o: "Interval") -> "Interval":
        if not (self.bounded and o.bounded):
            return TOP
        ps = [self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi]
        return Interval(min(ps), max(ps))

    def scale(self, c) -> "Interval":
        """Multiply by the exact scalar c (axis size, reduced-element count)."""
        if not self.bounded:
            return TOP
        a, b = self.lo * c, self.hi * c
        return Interval(min(a, b), max(a, b))

    def shl(self, s: "Interval") -> "Interval":
        if not (self.bounded and s.bounded) or s.lo < 0:
            return TOP
        ps = [
            int(self.lo) << int(s.lo), int(self.lo) << int(s.hi),
            int(self.hi) << int(s.lo), int(self.hi) << int(s.hi),
        ]
        return Interval(min(ps), max(ps))

    def clamp(self, lo: "Interval", hi: "Interval") -> "Interval":
        """lax.clamp(lo, x, hi): result ⊆ [lo.lo, hi.hi] REGARDLESS of x —
        this is the transfer that bounds the encode clip for TOP operands."""
        return Interval(
            max(self.lo, lo.lo) if self.bounded else lo.lo,
            min(self.hi, hi.hi) if self.bounded else hi.hi,
        )

    @staticmethod
    def point(v) -> "Interval":
        return Interval(v, v)

    @staticmethod
    def from_value(v) -> "Interval":
        """Interval of a concrete scalar/array constant."""
        import numpy as np

        a = np.asarray(v)
        if a.size == 0:
            return Interval.point(0)
        if a.dtype == bool:
            return Interval(0, 1)
        if not np.issubdtype(a.dtype, np.number):
            return TOP
        lo, hi = a.min(), a.max()
        if np.issubdtype(a.dtype, np.integer):
            return Interval(int(lo), int(hi))
        if not (np.isfinite(lo) and np.isfinite(hi)):
            return TOP
        return Interval(float(lo), float(hi))


TOP = Interval(-_INF, _INF)
_MASKABLE = Interval(0, _INF)


# --------------------------------------------------------------------------
# forward evaluation of a recorded trace
# --------------------------------------------------------------------------
def _union_all(ivals: Sequence[Interval]) -> Interval:
    out = ivals[0]
    for i in ivals[1:]:
        out = out.union(i)
    return out


def _nelem(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class _Env:
    """Value id -> Interval, with readers for a node's arguments."""

    def __init__(self, trace, env: Dict[int, Interval]):
        self.trace = trace
        self.env = env

    def ival(self, a) -> Optional[Interval]:
        """A node argument's interval: a tensor's, a python number's point,
        None for None (an absent optional bound)."""
        if a is None:
            return None
        if isinstance(a, bool):
            return Interval.point(int(a))
        if isinstance(a, (int, float)):
            return Interval.point(a) if math.isfinite(a) else TOP
        vid = getattr(a, "vid", None)
        if vid is not None:
            return self.env.get(vid, TOP)
        return TOP

    def nelem(self, a) -> int:
        vid = getattr(a, "vid", None)
        return self.trace.values[vid].nelem if vid is not None else 1

    def arg(self, node, i: int, name: str, default=None):
        if i < len(node.args):
            return node.args[i]
        return node.kwargs.get(name, default)


def _x(node, e: _Env) -> Interval:
    return e.ival(e.arg(node, 0, "self")) or TOP


def _add(node, e, sign=1):
    a, b = _x(node, e), e.ival(e.arg(node, 1, "other")) or TOP
    alpha = e.arg(node, 2, "alpha", 1)
    b = b.scale(alpha) if alpha != 1 else b
    return a.add(b) if sign > 0 else a.sub(b)


def _rsub(node, e):
    return _add(node, e, -1).neg()


def _clamp(node, e):
    x = _x(node, e)
    lo = e.ival(e.arg(node, 1, "min"))
    hi = e.ival(e.arg(node, 2, "max"))
    if node.op in ("clamp_min", "clamp_min_"):
        lo, hi = e.ival(e.arg(node, 1, "min")), None
    elif node.op in ("clamp_max", "clamp_max_"):
        lo, hi = None, e.ival(e.arg(node, 1, "max"))
    new_lo = x.lo if lo is None else (max(x.lo, lo.lo) if x.bounded else lo.lo)
    new_hi = x.hi if hi is None else (min(x.hi, hi.hi) if x.bounded else hi.hi)
    if new_lo > new_hi:
        return Interval(new_hi, new_hi)
    return Interval(new_lo, new_hi)


def _shr(x: Interval, s: Interval) -> Interval:
    if not (x.bounded and s.bounded) or s.lo < 0:
        return TOP
    ps = [int(x.lo) >> int(s.lo), int(x.lo) >> int(s.hi),
          int(x.hi) >> int(s.lo), int(x.hi) >> int(s.hi)]
    return Interval(min(ps), max(ps))


def _and(node, e):
    for m in (_x(node, e), e.ival(e.arg(node, 1, "other")) or TOP):
        if m.bounded and m.lo >= 0:
            return Interval(0, m.hi)
    return TOP


def _or(node, e):
    a, b = _x(node, e), e.ival(e.arg(node, 1, "other")) or TOP
    if a.bounded and b.bounded and a.lo >= 0 and b.lo >= 0:
        top = max(int(a.hi), int(b.hi))
        return Interval(0, (1 << top.bit_length()) - 1)
    return TOP


def _sum(node, e):
    x = _x(node, e)
    src = e.arg(node, 0, "self")
    out = node.outputs[0] if node.outputs else None
    n_in = e.nelem(src)
    n_out = e.trace.values[out].nelem if out is not None else 1
    return x.scale(max(n_in // max(n_out, 1), 1))


def _cumsum(node, e):
    x = _x(node, e)
    if not x.bounded:
        return TOP
    n = e.nelem(e.arg(node, 0, "self"))
    return Interval(min(x.lo, x.lo * n), max(x.hi, x.hi * n))


def _scatter_like(src_pos: int, src_name: str):
    # out = self with U source elements added at (possibly colliding)
    # indices: each output element receives between 0 and U of them, so
    # out ⊆ self + hull(0, U·src) — what bounds the gather wire's decode
    # image (n·k top-k values added into zeros)
    def run(node, e):
        base = _x(node, e)
        src_ref = e.arg(node, src_pos, src_name)
        src = e.ival(src_ref) or TOP
        if not (base.bounded and src.bounded):
            return TOP
        u = e.nelem(src_ref)
        return base.add(Interval(min(0, src.lo * u), max(0, src.hi * u)))

    return run


def _index_put(node, e):
    if e.arg(node, 3, "accumulate", False):
        return _scatter_like(2, "values")(node, e)
    return _x(node, e).union(e.ival(e.arg(node, 2, "values")) or TOP)


def _fill(pos: int, name: str):
    def run(node, e):
        return e.ival(e.arg(node, pos, name)) or TOP

    return run


def _arange(node, e):
    args = [a for a in node.args if isinstance(a, (int, float)) and not isinstance(a, bool)]
    if len(args) == 1:
        start, end = 0, args[0]
    elif len(args) >= 2:
        start, end = args[0], args[1]
    else:
        return TOP
    return Interval(min(start, end), max(start, end))


def _multi_passthrough(node, e):
    return [_x(node, e)] * len(node.outputs)


def _sort_like(node, e):
    # (values, indices): values are a subset of the input, indices address it
    n = e.nelem(e.arg(node, 0, "self"))
    if len(node.outputs) != 2:
        return [TOP] * len(node.outputs)
    return [_x(node, e), Interval(0, max(n - 1, 0))]


_PASSTHROUGH = frozenset({
    "_to_copy", "to", "clone", "view", "_unsafe_view", "reshape", "expand", "expand_as",
    "permute", "t", "transpose", "squeeze", "unsqueeze", "flatten", "contiguous", "alias",
    "detach", "slice", "select", "narrow", "as_strided", "index_select", "gather", "index",
    "take", "lift_fresh", "lift_fresh_copy", "repeat", "roll", "flip", "movedim",
    "diagonal", "max", "min", "amax", "amin", "floor", "trunc", "view_as", "_reshape_alias",
    "unfold", "pad", "constant_pad_nd", "masked_select", "_unsafe_index",
})
_MULTI_PASSTHROUGH = frozenset({"split", "split_with_sizes", "unbind", "chunk",
                                "tensor_split"})
_BOOLEAN = frozenset({"eq", "ne", "lt", "le", "gt", "ge", "isfinite", "isnan", "isinf",
                      "logical_and", "logical_or", "logical_not", "logical_xor", "any", "all"})

_TRANSFER: Dict[str, Callable] = {
    "add": _add, "add_": _add,
    "sub": lambda n, e: _add(n, e, -1), "sub_": lambda n, e: _add(n, e, -1),
    "rsub": _rsub,
    "mul": lambda n, e: _x(n, e).mul(e.ival(e.arg(n, 1, "other")) or TOP),
    "mul_": lambda n, e: _x(n, e).mul(e.ival(e.arg(n, 1, "other")) or TOP),
    "neg": lambda n, e: _x(n, e).neg(), "neg_": lambda n, e: _x(n, e).neg(),
    "abs": lambda n, e: (Interval(0, _x(n, e).mag) if _x(n, e).bounded else _MASKABLE),
    "sign": lambda n, e: Interval(-1, 1), "sgn": lambda n, e: Interval(-1, 1),
    "clamp": _clamp, "clamp_": _clamp, "clip": _clamp, "clip_": _clamp,
    "clamp_min": _clamp, "clamp_min_": _clamp, "clamp_max": _clamp, "clamp_max_": _clamp,
    "ceil": lambda n, e: (Interval(_x(n, e).lo, _x(n, e).hi + 1) if _x(n, e).bounded else TOP),
    "round": lambda n, e: (Interval(_x(n, e).lo - 1, _x(n, e).hi + 1)
                           if _x(n, e).bounded else TOP),
    "maximum": lambda n, e: Interval(max(_x(n, e).lo, (e.ival(e.arg(n, 1, "other")) or TOP).lo),
                                     max(_x(n, e).hi, (e.ival(e.arg(n, 1, "other")) or TOP).hi)),
    "minimum": lambda n, e: Interval(min(_x(n, e).lo, (e.ival(e.arg(n, 1, "other")) or TOP).lo),
                                     min(_x(n, e).hi, (e.ival(e.arg(n, 1, "other")) or TOP).hi)),
    "bitwise_left_shift": lambda n, e: _x(n, e).shl(e.ival(e.arg(n, 1, "other")) or TOP),
    "__lshift__": lambda n, e: _x(n, e).shl(e.ival(e.arg(n, 1, "other")) or TOP),
    "bitwise_right_shift": lambda n, e: _shr(_x(n, e), e.ival(e.arg(n, 1, "other")) or TOP),
    "__rshift__": lambda n, e: _shr(_x(n, e), e.ival(e.arg(n, 1, "other")) or TOP),
    "bitwise_and": _and, "bitwise_and_": _and, "__and__": _and,
    "bitwise_or": _or, "bitwise_or_": _or, "__or__": _or,
    "bitwise_xor": _or, "bitwise_xor_": _or, "__xor__": _or,
    "sum": _sum, "cumsum": _cumsum,
    "remainder": lambda n, e: (Interval(-(e.ival(e.arg(n, 1, "other")) or TOP).mag,
                                        (e.ival(e.arg(n, 1, "other")) or TOP).mag)
                               if (e.ival(e.arg(n, 1, "other")) or TOP).bounded else TOP),
    "fmod": lambda n, e: (Interval(-(e.ival(e.arg(n, 1, "other")) or TOP).mag,
                                   (e.ival(e.arg(n, 1, "other")) or TOP).mag)
                          if (e.ival(e.arg(n, 1, "other")) or TOP).bounded else TOP),
    "copy": lambda n, e: e.ival(e.arg(n, 1, "src")) or TOP,
    "copy_": lambda n, e: e.ival(e.arg(n, 1, "src")) or TOP,
    "where": lambda n, e: (e.ival(e.arg(n, 1, "self")) or TOP).union(
        e.ival(e.arg(n, 2, "other")) or TOP),
    "cat": lambda n, e: _union_all([e.ival(a) or TOP for a in n.args[0]] or [TOP]),
    "stack": lambda n, e: _union_all([e.ival(a) or TOP for a in n.args[0]] or [TOP]),
    "scatter_add": _scatter_like(3, "src"), "scatter_add_": _scatter_like(3, "src"),
    "index_add": _scatter_like(3, "source"), "index_add_": _scatter_like(3, "source"),
    "index_put": _index_put, "index_put_": _index_put,
    "zeros": lambda n, e: Interval(0, 0), "zeros_like": lambda n, e: Interval(0, 0),
    "new_zeros": lambda n, e: Interval(0, 0),
    "ones": lambda n, e: Interval(1, 1), "ones_like": lambda n, e: Interval(1, 1),
    "new_ones": lambda n, e: Interval(1, 1),
    "full": _fill(1, "fill_value"), "new_full": _fill(2, "fill_value"),
    "full_like": _fill(1, "fill_value"), "fill": _fill(1, "value"), "fill_": _fill(1, "value"),
    "scalar_tensor": _fill(0, "s"),
    "arange": _arange,
}


def _collective(node, env: Dict[int, Interval]) -> List[Interval]:
    """A collective's outputs, leaf by leaf: the union of the leaf over its
    contributions, scaled by their number for a summing collective (a psum
    over 4 workers of [−1, 1] is [−4, 4]); gathers, maxes, permutes and
    means leave the element values' range as it is."""
    per_leaf = []
    for vids in node.leaf_inputs:
        ivs = [env.get(v, TOP) for v in vids] or [TOP]
        u = _union_all(ivs)
        if node.name in ("psum", "psum_scatter", "reduce_scatter"):
            u = u.scale(node.n_contrib)
        per_leaf.append(u)
    if len(per_leaf) != len(node.outputs):
        return [TOP] * len(node.outputs)
    return per_leaf


def eval_trace_intervals(
    trace,
    in_ivals: Optional[Sequence[Interval]] = None,
    *,
    kernel_overrides: Optional[Callable] = None,
    on_node: Optional[Callable] = None,
) -> List[Interval]:
    """Forward interval evaluation of a recorded trace; returns the
    intervals of ``trace.outputs``.

    ``in_ivals`` gives ``trace.inputs``' intervals (TOP by default; any
    value from outside the step is TOP). ``kernel_overrides(node, ins) ->
    [out_ivals] | None`` gives a kernel node's outputs — the wire auditor
    installs the trusted kernels' declared stage bounds there (a kernel
    node is TOP otherwise). ``on_node(node, ins, outs)`` observes every
    node with its inputs' and outputs' intervals."""
    env: Dict[int, Interval] = {}
    for vid, iv_ in zip(trace.inputs, in_ivals or ()):
        env[vid] = iv_
    reader = _Env(trace, env)
    for node in trace.nodes:
        ins = [env.get(v, TOP) for v in node.inputs]
        outs: Optional[List[Interval]] = None
        if node.kind == "collective":
            outs = _collective(node, env)
        elif node.kind == "kernel":
            if kernel_overrides is not None:
                outs = kernel_overrides(node, ins)
        else:
            op = node.op
            try:
                if op in _BOOLEAN:
                    outs = [Interval(0, 1)] * len(node.outputs)
                elif op in _PASSTHROUGH:
                    outs = [_x(node, reader)] * len(node.outputs)
                elif op in _MULTI_PASSTHROUGH:
                    outs = _multi_passthrough(node, reader)
                elif op in ("topk", "sort", "kthvalue"):
                    outs = _sort_like(node, reader)
                elif op in _TRANSFER:
                    outs = [_TRANSFER[op](node, reader)] * len(node.outputs)
            except (TypeError, ValueError, AssertionError):
                outs = None
        if outs is None or len(outs) != len(node.outputs):
            outs = [TOP] * len(node.outputs)
        for v, o in zip(node.outputs, outs):
            env[v] = o
        for bvid, old, view in node.aliases:  # a write through a view
            env[bvid] = env.get(view, TOP) if old is None else env.get(old, TOP).union(
                env.get(view, TOP))
        if on_node is not None:
            on_node(node, ins, outs)
    return [env.get(v, TOP) for v in trace.outputs]


# --------------------------------------------------------------------------
# codec-level chain proof
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChainProof:
    """Symbolic §5.1 proof for one declared wire configuration.

    Stage intervals are exact bounds on any run respecting the declared
    clip: `encode` one microbatch's image, `accum` the M-microbatch local
    accumulator, `packed_field` one worker's biased transport field
    (packed) or lane value (dense), `wire_partial` any j≤n partial sum a
    ring hop may carry, `wire_sum` the full n-worker field/lane sum, and
    `image_sum` the unpacked integer image. `violations` is non-empty iff
    the configuration can overflow/degenerate; each entry is
    ``(check_id, human message)``.
    """

    kind: str
    bits: int
    n_workers: int
    n_accum: int
    lim: int
    stages: Dict[str, Interval]
    violations: Tuple[Tuple[str, str], ...]

    @property
    def ok(self) -> bool:
        return not self.violations


def wire_chain_proof(
    kind: str,
    bits: int,
    n_workers: int,
    n_accum: int = 1,
    lim: Optional[int] = None,
) -> ChainProof:
    """Prove (or refute) the guard-bit invariant for one wire config.

    ``lim`` defaults to the declared §5.1 limit ``clip_limit(n·M)``; pass a
    clip bound observed in a recorded trace to check a *looser-than-declared*
    clip against the same overflow conditions (the forgot-``n_accum`` bug
    class fails here even though the declared config is fine).
    """
    if kind not in ("dense", "packed", "topk"):
        raise ValueError(f"unknown wire kind {kind!r}")
    n, M = int(n_workers), int(n_accum)
    R = int_range_max(bits)
    lim_declared = declared_clip_limit(kind, n * M, bits)
    L = lim_declared if lim is None else int(lim)
    bad: List[Tuple[str, str]] = []
    if L <= 0:
        bad.append((
            "degenerate-clip",
            f"clip limit (2^{bits - 1}-1)//{n * M} == 0 for {n} workers × "
            f"{M} microbatches on an int{bits} wire: every gradient entry "
            f"would be clipped to 0 (the WireRangeError condition)",
        ))
        L = 0

    encode = Interval(-L, L)
    accum = encode.scale(M)
    stages: Dict[str, Interval] = {"encode": encode, "accum": accum}

    if kind == "dense":
        # lane value is the accumulator itself; ring partials / the psum grow
        # it by up to n contributions, all of which must fit the lane range
        field = accum
        wire_sum = accum.scale(n)
        stages["packed_field"] = field
        stages["wire_partial"] = wire_sum  # j≤n partials ⊆ the n-worker hull
        stages["wire_sum"] = wire_sum
        lane_max = R if bits < 32 else _INT_RANGE[32]
        if wire_sum.mag > lane_max:
            bad.append((
                "lane-overflow",
                f"n-worker lane sum |Σ| ≤ {int(wire_sum.mag)} exceeds the "
                f"int{bits} lane range ±{lane_max} (clip |v| ≤ {L} is too "
                f"loose for {n} workers × {M} microbatches)",
            ))
    elif kind == "topk":
        # gather transport: every field crosses the wire UNSUMMED as a plain
        # two's-complement `bits`-wide value next to its int32 index — no
        # bias, no field-to-field addition, and no pipelined pre-pack
        # accumulation either (topk is never fused: each of the M images is
        # encoded fresh at ±L), so the field is the ENCODE stage and the
        # only field condition is that the (possibly observed) clip fits
        # the value width. Partial and full "wire sums" are the field
        # itself: the sum happens after transport, in the scatter-add
        # image checked below — which is where the n·M product bites.
        field = encode
        stages["packed_field"] = field
        stages["wire_partial"] = field
        stages["wire_sum"] = field
        if field.mag > R:
            bad.append((
                "field-overflow",
                f"topk value field |v| ≤ {int(field.mag)} exceeds the "
                f"int{bits} two's-complement range ±{R} (clip |v| ≤ {L} "
                f"is wider than the value plane)",
            ))
    else:
        # packed: pack() biases every field by clip_limit(n) (the bias the
        # unpack side subtracts n× of), while values are bounded by the
        # pipelined clip M·clip_limit(n·M) ≤ clip_limit(n)
        bias = safe_clip_limit(n, bits)
        field = accum.add(Interval.point(bias))
        wire_sum = field.scale(n)
        stages["packed_field"] = field
        stages["wire_partial"] = Interval(
            min(0, wire_sum.lo), max(0, wire_sum.hi)
        )  # a j-hop partial is j ≤ n biased fields; hull includes j=0
        stages["wire_sum"] = wire_sum
        if field.lo < 0:
            bad.append((
                "field-underflow",
                f"biased field v+{bias} can reach {int(field.lo)} < 0 "
                f"(clip |v| ≤ {L} with {M} microbatches exceeds the "
                f"pack bias clip_limit({n}) = {bias}): a negative field "
                f"borrows from its packed neighbour",
            ))
        if wire_sum.hi > (1 << bits) - 2:
            bad.append((
                "field-overflow",
                f"{n}-worker biased field sum can reach "
                f"{int(wire_sum.hi)} > 2^{bits}-2 = {(1 << bits) - 2}: the "
                f"field carries into its packed neighbour (clip |v| ≤ {L} "
                f"is too loose for {n} workers × {M} microbatches)",
            ))

    image = accum.scale(n)
    stages["image_sum"] = image
    if image.mag > _INT_RANGE[32]:
        bad.append((
            "image-overflow",
            f"summed integer image |Σ| ≤ {int(image.mag)} exceeds int32",
        ))
    return ChainProof(
        kind=kind, bits=bits, n_workers=n, n_accum=M,
        lim=L, stages=stages, violations=tuple(bad),
    )
