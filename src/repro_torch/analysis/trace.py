"""A recorded trace of one step: the port's counterpart of the JAX package's
``repro/analysis/jaxpr_walk.py``.

The JAX package audits the jaxpr a step traces to. The port's step is eager
PyTorch, so its trace is recorded while it runs: :func:`record` runs a
function under a ``TorchDispatchMode`` and makes one :class:`Node` per aten
op, with the value ids it reads and defines, their dtypes and shapes, and
its scalar arguments (clamp bounds, shift amounts). A value is a tensor at a
version: an op that writes a tensor in place defines a new value of it (and
of the tensor it is a view of); a view read after its base was written
reads the base's new value. Tensors are held by weak references only: the
trace keeps no tensor alive, only shapes, dtypes and ids.

The port has exactly two places where the wire and the kernels are issued,
and each hooks in here:

- every data-moving function of ``parallel/collectives.py`` is decorated
  with :func:`collective` and becomes ONE collective node: its kind (the
  JAX primitive it stands for: ``psum``, ``all_gather``, ...), its axis
  (``data``, ``model``, ``seq`` or ``stage``), its number of contributions
  (the local backend's n workers, or the group's size), each leaf's dtype,
  shape and bytes (one contribution's), its outputs, and the count of
  library calls it issued asynchronously (the works it waits on). Its body
  runs outside the dispatch mode (the local backend's adds, gloo's ``c10d``
  ops are not recorded, and an issued reduce stays asynchronous); where one
  shim function calls another, only the outermost makes a node. The contributions a
  caller hands in as a generator (the local backend's workers, whose
  backward passes run while the shim pulls them) are recorded as ops of
  their own, outside the node;
- ``kernels/ops.py``'s ``KernelOp.__call__`` makes ONE kernel node per
  call, on the card and on the CPU alike, with its tensor operands, its
  outputs and its scalar arguments; the ops of the plain version are folded
  into it.

With no recording active each hook costs one check (``ACTIVE is None``)
and changes no result.

:func:`build_graph`, :func:`backward_nodes` and :func:`forward_nodes` give
what the reference's ``build_graph``, ``backward_eqns`` and
``forward_eqns`` give (``jaxpr_walk.py``), over the recorded dataflow: a
recorded trace is already one flat, topologically ordered scope, so there
are no equality links and no opaque call sites.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

__all__ = [
    "ACTIVE",
    "COLLECTIVES",
    "REDUCING_COLLECTIVES",
    "Ref",
    "Leaf",
    "Node",
    "Trace",
    "RecordError",
    "record",
    "collective",
    "DataflowGraph",
    "build_graph",
    "backward_nodes",
    "forward_nodes",
]

# the Recorder of the running :func:`record`, or None: the hooks' one check
ACTIVE: Optional["Recorder"] = None

# collective kind (the JAX primitive's name) -> communication kind
COLLECTIVES = {
    "psum": "all-reduce",
    "pmean": "all-reduce",
    "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "psum_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "ppermute": "collective-permute",
    "pmax": "all-reduce",
    "pmin": "all-reduce",
}

# kinds whose payload is combined across contributions (vs moved)
REDUCING_COLLECTIVES = frozenset(
    {"psum", "pmean", "pmax", "pmin", "reduce_scatter", "psum_scatter", "ppermute"}
)

_AXES = ("data", "model", "seq", "stage")


@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor argument of a node: the value id it read."""

    vid: int


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of a collective's payload, as one contribution sends it."""

    dtype: str
    shape: Tuple[int, ...]
    nbytes: int

    @property
    def nelem(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    @property
    def kind(self) -> str:
        return dtype_kind(self.dtype)


@dataclasses.dataclass(frozen=True)
class Value:
    """What the trace keeps of one value: dtype, shape, producing node."""

    dtype: str
    shape: Tuple[int, ...]
    itemsize: int
    producer: Optional[int]  # node index; None for a value from outside

    @property
    def nelem(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    @property
    def nbytes(self) -> int:
        return self.nelem * self.itemsize

    @property
    def kind(self) -> str:
        return dtype_kind(self.dtype)


@dataclasses.dataclass
class Node:
    """One recorded op (``kind`` "op", ``name`` like "aten.mm"), collective
    (``kind`` "collective", ``name`` the primitive it stands for) or kernel
    (``kind`` "kernel", ``name`` the kernel's)."""

    index: int
    kind: str
    name: str
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...] = ()
    # positional and keyword arguments: a Ref per tensor, lists of them,
    # python scalars, dtype names
    args: tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # writes through a view: (base's new value, base's old value or None
    # for a base the node made, the view's new value)
    aliases: Tuple[Tuple[int, int, int], ...] = ()
    # collectives only
    axis: Optional[str] = None
    n_contrib: int = 1
    leaves: Tuple[Leaf, ...] = ()
    leaf_inputs: Tuple[Tuple[int, ...], ...] = ()  # per leaf, every contribution's value
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def op(self) -> str:
        """The op's name without its namespace (``mm`` for ``aten.mm``)."""
        return self.name.rpartition(".")[2]


@dataclasses.dataclass
class Trace:
    """Nodes in execution order (a topological order of the dataflow), the
    values they read and define, and the step's inputs and outputs (the
    tensors it returned and the tensors it wrote in place)."""

    nodes: List[Node] = dataclasses.field(default_factory=list)
    values: Dict[int, Value] = dataclasses.field(default_factory=dict)
    inputs: Tuple[int, ...] = ()
    outputs: Tuple[int, ...] = ()
    # indices of the op nodes recorded off the thread that called record():
    # on the card the autograd engine runs the backward in a device thread
    off_thread: Tuple[int, ...] = ()


class RecordError(RuntimeError):
    """An op failed while a step was recorded (on the meta device: an op
    whose output depends on the data, or a host read of a tensor)."""


def dtype_kind(dtype: str) -> str:
    """numpy-style kind of a dtype name: "f", "i", "u", "b" or "c"."""
    if dtype.startswith("complex"):
        return "c"
    if dtype == "bool":
        return "b"
    if dtype.startswith("uint"):
        return "u"
    if dtype.startswith("int"):
        return "i"
    return "f"


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor in a nest of dicts, lists, tuples and dataclasses."""
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
class Recorder:
    def __init__(self):
        self.trace = Trace()
        # id(tensor) -> (a weak reference to it, its value id, the value its
        # storage held when it was bound); an entry whose reference no
        # longer points at the tensor asked for is stale (the id was reused)
        self._vid: Dict[int, Tuple[weakref.ref, int, int]] = {}
        # a storage -> (a weak reference to it, the value it holds now): a
        # tensor first seen on a known storage (autograd unpacks a saved
        # output as a new tensor on the same storage) reads that value
        self._by_storage: Dict[int, Tuple[StorageWeakRef, int]] = {}
        # per op overload: its name and the positions / names of the
        # arguments it writes
        self._ops: Dict[Any, Tuple[str, Tuple[Tuple[int, str, bool], ...]]] = {}
        self._next = 0
        # > 0 inside a collective or a kernel: ops run and are folded into it
        self.depth = 0
        self.mode: Optional["_Mode"] = None  # the dispatch mode recording
        self.thread = threading.get_ident()
        self.off_thread: List[int] = []

    # -- values ------------------------------------------------------------
    def _new_value(self, t: torch.Tensor, producer: Optional[int]) -> int:
        vid = self._next
        self._next += 1
        self.trace.values[vid] = Value(_dtype_name(t.dtype), tuple(t.shape),
                                       t.element_size(), producer)
        return vid

    def _entry(self, t: torch.Tensor):
        e = self._vid.get(id(t))
        return e if e is not None and e[0]() is t else None

    def _set(self, t: torch.Tensor, vid: int, svid: int) -> None:
        self._vid[id(t)] = (weakref.ref(t), vid, svid)

    def _add_node(self, **kw) -> Node:
        node = Node(index=len(self.trace.nodes), **kw)
        self.trace.nodes.append(node)
        return node

    def _storage(self, t: torch.Tensor) -> Tuple[Any, Optional[int]]:
        """``t``'s storage and the value it holds now (None: never seen)."""
        s = t.untyped_storage()
        hit = self._by_storage.get(s._cdata)
        # the weak reference keeps the storage's address from reuse
        return s, (None if hit is None or hit[0].expired() else hit[1])

    def _hold(self, s, vid: int) -> None:
        self._by_storage[s._cdata] = (StorageWeakRef(s), vid)

    def read(self, t: torch.Tensor) -> int:
        """The value id ``t`` holds now. A tensor's value is its storage's:
        a tensor bound since its storage last changed reads its own value;
        one not seen before, or one whose storage was written since (through
        another view, or autograd's unpacking of a saved output as a new
        tensor on the same storage), reads the storage's value through an
        alias node; a tensor on a storage never seen is a value from
        outside (a step input, a constant)."""
        s, svid = self._storage(t)
        entry = self._entry(t)
        if entry is not None and entry[2] == svid:
            return entry[1]
        if svid is None:
            vid = self._new_value(t, None)
            self._hold(s, vid)
            self._set(t, vid, vid)
            return vid
        node = self._add_node(kind="op", name="aten.alias", inputs=(svid,), args=(Ref(svid),))
        vid = self._new_value(t, node.index)
        node.outputs = (vid,)
        self._set(t, vid, svid)
        return vid

    def bind(self, t: torch.Tensor, node: Node, *, written: bool, acc) -> int:
        """``t`` holds a new value defined by ``node``. A view's relation to
        its base is not set yet where an op's output is seen (autograd makes
        it after the dispatch), so storages decide: an output on a storage
        already seen and not written is a view of it, which keeps its value;
        a written tensor, or one on a new storage, gives the storage a new
        value — its own if it spans the whole storage, else a new value of
        the whole, made from the old one and the tensor's (``acc``: extra
        inputs and aliases for :meth:`_close`)."""
        vid = self._new_value(t, node.index)
        s, svid = self._storage(t)
        if svid is not None and not written:
            self._set(t, vid, svid)
            return vid
        nbytes = s.nbytes()
        if t.storage_offset() == 0 and t.numel() * t.element_size() == nbytes:
            self._hold(s, vid)
            self._set(t, vid, vid)
            return vid
        bvid = self._next
        self._next += 1
        self.trace.values[bvid] = Value(_dtype_name(t.dtype), (nbytes // t.element_size(),),
                                        t.element_size(), node.index)
        acc[1].append((bvid, svid, vid))
        if svid is not None:
            acc[0].append(svid)
        self._hold(s, bvid)
        self._set(t, vid, bvid)
        return vid

    @staticmethod
    def _close(node: Node, outs, acc) -> None:
        node.outputs = node.outputs + tuple(outs)
        if acc[1]:
            node.aliases = node.aliases + tuple(acc[1])
        if acc[0]:
            node.inputs = tuple(dict.fromkeys(node.inputs + tuple(acc[0])))

    def _arg(self, x):
        if isinstance(x, torch.Tensor):
            return Ref(self.read(x))
        if isinstance(x, (list, tuple)):
            return [self._arg(v) for v in x]
        if isinstance(x, (bool, int, float, str)) or x is None:
            return x
        if isinstance(x, torch.dtype):
            return _dtype_name(x)
        return repr(x)

    # -- aten ops ----------------------------------------------------------
    def _op_info(self, func):
        info = self._ops.get(func)
        if info is None:
            writes = tuple((i, a.name, a.kwarg_only) for i, a in enumerate(func._schema.arguments)
                           if a.alias_info is not None and a.alias_info.is_write)
            info = (f"{func.namespace}.{func.overloadpacket.__name__}", writes)
            self._ops[func] = info
        return info

    def on_op(self, func, args, kwargs, out) -> None:
        name, writes = self._op_info(func)
        written = []
        for i, arg_name, kwarg_only in writes:
            v = kwargs.get(arg_name) if kwarg_only or i >= len(args) else args[i]
            written.extend(_tensors(v))
        pargs = tuple(self._arg(a) for a in args)
        pkw = {k: self._arg(v) for k, v in kwargs.items()} if kwargs else {}
        inputs = tuple(dict.fromkeys(r.vid for r in _refs((pargs, pkw))))
        node = self._add_node(kind="op", name=name, inputs=inputs, args=pargs, kwargs=pkw)
        written_ids = {id(t) for t in written}
        outs, acc = [], ([], [])
        for t in _tensors(out):
            outs.append(self.bind(t, node, written=id(t) in written_ids, acc=acc))
            written_ids.discard(id(t))
        for t in written:  # written in place and not returned
            if id(t) in written_ids:
                outs.append(self.bind(t, node, written=True, acc=acc))
                written_ids.discard(id(t))
        self._close(node, outs, acc)
        if threading.get_ident() != self.thread:
            self.off_thread.append(node.index)

    # -- the hooks ---------------------------------------------------------
    def collective(self, fn, sig, kind, axis, data_param, size, args, kw):
        if self.depth:  # inside another shim function or a kernel: folded
            return fn(*args, **kw)
        bound = sig.bind(*args, **kw)
        data = bound.arguments[data_param]
        group = bound.arguments.get("group")
        # per contribution, its leaves' (value id, Leaf): no tensor is kept
        contributions: List[List[Tuple[int, Leaf]]] = []

        def note(item):
            contributions.append([(self.read(t), _leaf(t)) for t in _tensors(item)])

        if isinstance(data, (torch.Tensor, dict)):  # this rank's one payload
            note(data)
            if data_param == "rows":  # (workers here, per): one row a worker
                n = int(data.shape[0]) if group is None else size(group)
                per = tuple(int(s) for s in data.shape[1:])
                leaves = [Leaf(_dtype_name(data.dtype), per,
                               _prod(per) * data.element_size())]
            else:
                n = size(group) if group is not None else 1
                leaves = [lf for _, lf in contributions[0]]
        else:
            def pull(it):
                # the producer (a worker's backward, its encode) runs outside
                # the node: the fold is lifted and the mode back on while it
                # makes the next item
                it = iter(it)
                while True:
                    saved, self.depth = self.depth, 0
                    try:
                        with self.mode:
                            item = next(it)
                    except StopIteration:
                        return
                    finally:
                        self.depth = saved
                    note(item)
                    yield item

            bound.arguments[data_param] = pull(data)
            n = leaves = None
        self.depth += 1
        try:
            # the shim's own ops and the library's calls run outside the
            # dispatch mode: none is recorded, and an issued collective stays
            # as asynchronous as it is unrecorded
            with _disable_current_modes():
                out = fn(*bound.args, **bound.kwargs)
        finally:
            self.depth -= 1
        if n is None:
            n = size(group) if group is not None else len(contributions)
            leaves = [lf for _, lf in contributions[0]] if contributions else []
        inputs = tuple(dict.fromkeys(v for c in contributions for v, _ in c))
        per_leaf = tuple(tuple(c[j][0] for c in contributions if j < len(c))
                         for j in range(len(leaves)))
        issued = hasattr(out, "wait") and hasattr(out, "_result")  # a Pending
        node = self._add_node(kind="collective", name=kind, inputs=inputs, axis=axis,
                              n_contrib=int(n), leaves=tuple(leaves), leaf_inputs=per_leaf,
                              stats={"async_calls": len(out._works) if issued else 0})
        del contributions

        def bind_result(result):
            acc = ([], [])
            self._close(node, [self.bind(t, node, written=True, acc=acc)
                               for t in _tensors(result)], acc)
            return result

        if issued:
            inner = out._result

            def result():
                self.depth += 1
                try:
                    with _disable_current_modes():
                        r = inner()
                finally:
                    self.depth -= 1
                return bind_result(r)

            out._result = result
            return out
        return bind_result(out)

    def kernel(self, op, run, x, args, kwargs):
        if self.depth:
            return run(x, *args, **kwargs)
        pargs = tuple(self._arg(a) for a in (x, *args))
        pkw = {k: self._arg(v) for k, v in kwargs.items()}
        inputs = tuple(dict.fromkeys(r.vid for r in _refs((pargs, pkw))))
        self.depth += 1
        try:
            # the kernel (or its plain version) runs outside the dispatch
            # mode: none of its ops is recorded, so none pays for it
            with _disable_current_modes():
                out = run(x, *args, **kwargs)
        finally:
            self.depth -= 1
        node = self._add_node(kind="kernel", name=op.name, inputs=inputs, args=pargs, kwargs=pkw)
        acc = ([], [])
        outs = [self.bind(t, node, written=False, acc=acc) for t in _tensors(out)]
        for name in getattr(op, "writes", ()):
            t = kwargs.get(name)
            if isinstance(t, torch.Tensor):
                outs.append(self.bind(t, node, written=True, acc=acc))
        self._close(node, outs, acc)
        return out


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _leaf(t: torch.Tensor) -> Leaf:
    return Leaf(_dtype_name(t.dtype), tuple(int(s) for s in t.shape),
                t.numel() * t.element_size())


def _refs(x) -> List[Ref]:
    out: List[Ref] = []

    def walk(v):
        if isinstance(v, Ref):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)

    walk(x)
    return out


class _Mode(TorchDispatchMode):
    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing here is compiled: without this, the mode's first dispatch
        # imports torch._dynamo (and sympy), seconds once a process
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            out = func(*args, **kwargs)
        except Exception as e:
            if not any(t.device.type == "meta" for t in _tensors((args, kwargs))):
                raise
            raise RecordError(f"{func} cannot run on the meta device (it needs the data): "
                              f"{type(e).__name__}: {e}") from e
        rec = self.rec
        if not rec.depth:
            rec.on_op(func, args, kwargs, out)
        return out


def record(fn: Callable, *args, **kw):
    """Run ``fn(*args, **kw)`` once, recording every op it runs; returns
    ``(out, Trace)``. The trace's inputs are the values of the tensors in
    ``args``/``kw``; its outputs the tensors ``fn`` returned and the input
    tensors it wrote in place. Recording changes no result: every op runs as
    it would, and ``fn``'s own outputs are returned."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("record() does not nest")
    rec = Recorder()
    in_tensors = _tensors((args, kw))
    rec.trace.inputs = tuple(dict.fromkeys(rec.read(t) for t in in_tensors))
    before = [rec.read(t) for t in in_tensors]
    ACTIVE = rec
    rec.mode = _Mode(rec)
    try:
        with rec.mode:
            out = fn(*args, **kw)
    finally:
        ACTIVE = None
    outs = [rec.read(t) for t in _tensors(out)]
    outs += [vid for t, v0 in zip(in_tensors, before) if (vid := rec.read(t)) != v0]
    rec.trace.outputs = tuple(dict.fromkeys(outs))
    rec.trace.off_thread = tuple(rec.off_thread)
    del in_tensors
    return out, rec.trace


def collective(kind: str, axis: str, *, data: str, size: Callable[[Any], int]):
    """Decorator for a data-moving function of ``parallel/collectives.py``:
    while a step is recorded, each outermost call is one collective node of
    ``kind`` over ``axis``; the contributions are argument ``data`` (an
    iterable of this context's workers' payloads, or one tensor), the group
    argument ``group`` and ``size(group)`` its number of contributions."""
    if kind not in COLLECTIVES or axis not in _AXES:
        raise ValueError(f"unknown collective {kind!r} over {axis!r}")

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            rec = ACTIVE
            if rec is None:
                return fn(*args, **kw)
            return rec.collective(fn, sig, kind, axis, data, size, args, kw)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# the dataflow graph
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DataflowGraph:
    """``defs``: value id -> the node defining it; ``uses``: value id -> the
    nodes reading it."""

    defs: Dict[int, Node]
    uses: Dict[int, List[Node]]


def build_graph(trace: Trace) -> DataflowGraph:
    g = DataflowGraph(defs={}, uses={})
    for node in trace.nodes:
        for v in node.outputs:
            g.defs[v] = node
        for bvid, _old, _view in node.aliases:
            g.defs[bvid] = node
        for v in node.inputs:
            g.uses.setdefault(v, []).append(node)
    return g


def backward_nodes(roots: Iterable[int], graph: DataflowGraph) -> set:
    """Indices of every node whose output can flow into any root value."""
    seen: set = set()
    hit: set = set()
    stack = list(roots)
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        node = graph.defs.get(v)
        if node is not None and node.index not in hit:
            hit.add(node.index)
            stack.extend(node.inputs)
    return hit


def forward_nodes(roots: Iterable[int], graph: DataflowGraph) -> set:
    """Indices of every node any root value can flow into (the consumer
    closure, the dual of :func:`backward_nodes`)."""
    seen: set = set()
    hit: set = set()
    stack = list(roots)
    while stack:
        v = stack.pop()
        if v in seen:
            continue
        seen.add(v)
        for node in graph.uses.get(v, ()):
            if node.index not in hit:
                hit.add(node.index)
                stack.extend(node.outputs)
                stack.extend(b for b, _o, _v in node.aliases)
    return hit
