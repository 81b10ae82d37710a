"""Collectives of the port (port of the matching subset of
``repro/parallel/collectives.py``), on two backends.

- **Local** (``group=None``): one process drives one card and simulates the
  n data-parallel workers in turn, the role ``vmap_workers`` plays in the
  JAX package. Each function takes the workers' contributions as an
  iterable in worker order, and what would cross the wire meets here.
- **Process group** (``group`` a ``torch.distributed`` group): one process
  per worker. The iterable holds exactly this rank's one contribution, and
  the function is the library's collective over the group (NCCL across
  cards, or gloo, which also lets several ranks share one card).

Every ``torch.distributed`` call of the port lives in this module (the
JAX package's collectives-shim rule), so the call sites read the same on
both backends.

The model axis (tensor parallelism) has no local backend: its primitives
(:func:`psum_tp`, :func:`pmax_tp`, :func:`all_to_all_tp`) take the model
group of a data × model grid of ranks (``launch/mesh.py``) and raise
without one. :func:`psum_tp` is the JAX package's ``psum`` inside its
step's ``shard_map`` (``check_vma=False``), whose transpose is again a
``psum``: its backward sums the cotangents over the group too. The stage
axis's ring send (:func:`ppermute_ring`, for ``parallel/pp.py``) likewise
takes a stage group and raises without one.

The integer-only guard carries over: gradient payloads summed here must be
integer transport words — the paper's floatless wire is structural. On a
group they are summed in their own type (int32 packed words, int8 or int32
dense lanes), which wraps as the local backend's explicit wrap does. Neither
gloo nor NCCL sums int16, so a ``dense16`` payload is refused on a group.
"""
from __future__ import annotations

import datetime
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.analysis import trace as _trace
from repro_torch.kernels.ref import wrap_int

Tree = Dict[str, torch.Tensor]
# the integer lane types gloo and NCCL both sum
GROUP_WIRE_DTYPES = (torch.int8, torch.int32)
# elements per exchange and gather of the rank-ordered float mean
ORDERED_GATHER_CHUNK = 1 << 24


class Pending:
    """An issued collective: ``wait()`` blocks on its works (none on the
    local backend, where the result is already computed) and returns the
    result."""

    def __init__(self, works: Sequence, result: Callable[[], object]):
        self._works = list(works)
        self._result = result

    def wait(self):
        for work in self._works:
            work.wait()
        self._works = []
        return self._result()

    def then(self, fn: Callable) -> "Pending":
        """The same works, the result passed through ``fn``."""
        return Pending(self._works, lambda: fn(self._result()))


def init_process_group(backend: str, *, init_method: str = "env://",
                       rank: Optional[int] = None, world_size: Optional[int] = None,
                       timeout_s: float = 600.0, device: Optional[torch.device] = None):
    """Join the default process group and return it. NCCL is bound to
    ``device`` (one card per rank); gloo takes tensors on the CPU or on a
    card, so several ranks can share one."""
    kw = {}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.group.WORLD


def destroy_process_group() -> None:
    dist.destroy_process_group()


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def group_backend(group) -> str:
    return str(dist.get_backend(group))


def barrier(group) -> None:
    dist.barrier(group)


def _only(worker_trees: Iterable, what: str):
    """This rank's one contribution on a group."""
    trees = list(worker_trees)
    if len(trees) != 1:
        raise ValueError(f"{what} on a process group takes this rank's one "
                         f"contribution, got {len(trees)}")
    return trees[0]


def check_wire_dtypes(words: Tree) -> None:
    for name, v in words.items():
        if v.is_floating_point() or v.is_complex():
            raise TypeError(
                f"wire payload {name!r} must be integer, got {v.dtype} — the "
                "IntSGD wire carries no floats (float reductions go through "
                "pmean_tree)"
            )


def check_group_wire_dtypes(words: Tree) -> None:
    check_wire_dtypes(words)
    for name, v in words.items():
        if v.dtype not in GROUP_WIRE_DTYPES:
            raise TypeError(
                f"wire payload {name!r} is {v.dtype}: a process group sums only "
                f"{[str(d) for d in GROUP_WIRE_DTYPES]} lanes (gloo refuses "
                "int16, NCCL has no 16-bit integer type); use packed16 for a "
                "16-bit wire"
            )


def add_wire_words(acc: Optional[Tree], words: Tree) -> Tree:
    """Fold one worker's transport words into the running sum, in the
    payload's own integer type and wrapping as an all-reduce in that type
    does: packed words mod 2^32 (the packed-field arithmetic relies on
    it), dense int8/int16/int32 lanes in their width (the JAX package's
    psum of int8 lanes is int8; the §5.1 clip keeps it from wrapping). The
    add runs in int64 and wraps explicitly: integer overflow is not defined
    behaviour in the elementwise kernels."""
    check_wire_dtypes(words)
    if acc is None:
        return dict(words)
    if acc.keys() != words.keys():
        raise ValueError("workers sent payloads for different leaves")
    for k in acc:
        if acc[k].dtype != words[k].dtype:
            raise TypeError(
                f"wire payload {k!r}: workers sent {acc[k].dtype} and "
                f"{words[k].dtype} lanes"
            )
    return {
        k: wrap_int(acc[k].to(torch.int64) + words[k].to(torch.int64), acc[k].dtype)
        for k in acc
    }


def _all_reduce_copies(tree: Tree, group, op=dist.ReduceOp.SUM, *,
                       inplace: bool = False) -> Pending:
    """One async all-reduce per leaf, all issued before any is waited on;
    on a copy (the library reduces in place) unless ``inplace``."""
    out = dict(tree) if inplace else {k: v.clone() for k, v in tree.items()}
    works = [dist.all_reduce(v, op=op, group=group, async_op=True) for v in out.values()]
    return Pending(works, lambda: out)


@_trace.collective("psum", "data", data="worker_words", size=group_size)
def psum_wire_words(worker_words: Iterable[Tree], group=None, *,
                    async_op: bool = False, inplace: bool = False):
    """The integer all-reduce of the workers' word planes: locally the
    wrap-around sum over the n workers in turn; on a group one
    ``all_reduce(SUM)`` per leaf payload in its own integer type, into the
    payload itself with ``inplace`` (for a caller that owns it; no copy).
    Returns the summed tree, or a :class:`Pending` of it with
    ``async_op``."""
    if group is None:
        acc = None
        for words in worker_words:
            acc = add_wire_words(acc, words)
        if acc is None:
            raise ValueError("psum over zero workers")
        pending = Pending((), lambda: acc)
    else:
        words = _only(worker_words, "psum_wire_words")
        check_group_wire_dtypes(words)
        pending = _all_reduce_copies(words, group, inplace=inplace)
    return pending if async_op else pending.wait()


@_trace.collective("psum", "data", data="worker_buckets", size=group_size)
def psum_wire_words_bucketed(worker_buckets: Iterable[List[torch.Tensor]], group=None, *,
                             async_op: bool = False, inplace: bool = False):
    """The bucketed integer all-reduce (``overlap="ring"``): each worker's
    payload cut into fixed-size 1-D buckets (:mod:`repro_torch.wire.bucketing`),
    each bucket reduced on its own. On a group every bucket's
    ``all_reduce(SUM)`` is issued async and all are waited on together, so
    the transfers queue behind one another while the caller goes on; the
    library's all-reduce is already a ring (NCCL's), so the JAX package's
    hand-written ``ring_allreduce_int`` has no counterpart here. Integer
    addition is exact in any order: bit-identical to
    :func:`psum_wire_words` on the debucketized tree. Returns the list of
    summed buckets, or a :class:`Pending` of it."""
    as_tree = ({str(i): b for i, b in enumerate(buckets)} for buckets in worker_buckets)
    pending = psum_wire_words(as_tree, group, async_op=True, inplace=inplace).then(
        lambda tree: [tree[str(i)] for i in range(len(tree))])
    return pending if async_op else pending.wait()


@_trace.collective("all_gather", "data", data="worker_buckets", size=group_size)
def allgather_wire_words(worker_buckets: Iterable[List[torch.Tensor]], n: int, group=None, *,
                         async_op: bool = False):
    """The integer all-gather of a gather codec's payload (values and the
    index plane that positions them: nothing may be summed on the wire),
    cut into 1-D buckets (:mod:`repro_torch.wire.bucketing`). Returns each
    bucket with a leading worker axis, ``(n, size)`` in worker order, or a
    :class:`Pending` of that list. Locally the workers' buckets are stacked
    in turn; on a group every bucket's ``all_gather`` is issued async and
    all are waited on together. The integer-only guard holds as on the
    psum wire."""
    if group is None:
        per_worker = []
        for buckets in worker_buckets:
            check_wire_dtypes({str(i): b for i, b in enumerate(buckets)})
            per_worker.append(buckets)
        if len(per_worker) != n:
            raise ValueError(f"all_gather over {len(per_worker)} workers, expected {n}")
        out = [torch.stack([w[i] for w in per_worker]) for i in range(len(per_worker[0]))]
        pending = Pending((), lambda: out)
    else:
        buckets = _only(worker_buckets, "allgather_wire_words")
        check_group_wire_dtypes({str(i): b for i, b in enumerate(buckets)})
        _check_size(n, group)
        out = [torch.empty((n, *b.shape), dtype=b.dtype, device=b.device) for b in buckets]
        works = [dist.all_gather(list(o.unbind(0)), b.contiguous(), group=group, async_op=True)
                 for o, b in zip(out, buckets)]
        pending = Pending(works, lambda: out)
    return pending if async_op else pending.wait()


@_trace.collective("pmean", "data", data="worker_trees", size=group_size)
def pmean_tree(worker_trees: Iterable[Tree], n: int, group=None, *,
               ordered: bool = False) -> Tree:
    """Float mean over the n workers. Locally the f32 sum runs in worker
    order. On a group it is ``all_reduce(SUM)/n`` in the library's order —
    what the uncompressed baseline pays every step — unless ``ordered``:
    then each leaf is summed in rank order by :func:`_ordered_sum`, one
    chunk at a time, bit-identical to the local backend (the exact step 0,
    where one ULP would move every later integer image)."""
    if group is None:
        acc = None
        count = 0
        for tree in worker_trees:
            count += 1
            if acc is None:
                acc = {k: v.to(torch.float32).clone() for k, v in tree.items()}
            else:
                for k, v in tree.items():
                    acc[k].add_(v.to(torch.float32))
        if count != n:
            raise ValueError(f"pmean over {count} workers, expected {n}")
        return {k: v / n for k, v in acc.items()}
    tree = _only(worker_trees, "pmean_tree")
    _check_size(n, group)
    if not ordered:
        summed = _all_reduce_copies({k: v.to(torch.float32) for k, v in tree.items()},
                                    group).wait()
        return {k: v / n for k, v in summed.items()}
    out = {}
    for k, v in tree.items():
        flat = v.reshape(-1)
        acc = torch.empty(flat.shape, dtype=torch.float32, device=flat.device)
        # in chunks, so that n pieces of one chunk (not of a whole leaf) are
        # alive at a time; the sum is elementwise, so chunking changes no bit
        for off in range(0, flat.numel(), ORDERED_GATHER_CHUNK):
            acc[off:off + ORDERED_GATHER_CHUNK] = _ordered_sum(
                flat[off:off + ORDERED_GATHER_CHUNK], n, group)
        out[k] = (acc / n).reshape(v.shape)
    return out


def _ordered_sum(v: torch.Tensor, n: int, group) -> torch.Tensor:
    """The ranks' flat ``v`` summed in float32 in rank order, on every rank,
    by exchange and gather: ``v`` is padded to n equal pieces, an
    all-to-all hands rank r the r-th piece of every rank's ``v``, rank r
    adds those n pieces in rank order, and the summed pieces are
    all-gathered. Every element is still ``v_0 + v_1 + ... + v_{n-1}``
    added left to right, as the local backend adds it; a rank receives
    2(n - 1)/n of ``v``'s bytes, where a gather of every rank's ``v``
    brings n - 1 times them."""
    size = v.numel()
    per = -(-size // n)
    if size == n * per:
        send = v.contiguous()
    else:
        send = torch.zeros(n * per, dtype=v.dtype, device=v.device)
        send[:size] = v
    pieces = torch.empty_like(send)
    dist.all_to_all_single(pieces, send, group=group)
    del send
    pieces = pieces.view(n, per)
    part = pieces[0].to(torch.float32, copy=True)
    for piece in pieces[1:]:
        part.add_(piece.to(torch.float32))
    del pieces
    summed = torch.empty((n, per), dtype=torch.float32, device=v.device)
    dist.all_gather(list(summed.unbind(0)), part, group=group)
    return summed.view(-1)[:size]


def _check_size(n: int, group) -> None:
    if dist.get_world_size(group) != n:
        raise ValueError(f"a collective over {n} workers on a group of "
                         f"{dist.get_world_size(group)} ranks")


def _gather_leaf(v: torch.Tensor, n: int, group) -> List[torch.Tensor]:
    """Every rank's ``v``, in rank order (the list form of all_gather)."""
    out = [torch.empty_like(v) for _ in range(n)]
    dist.all_gather(out, v.contiguous(), group=group)
    return out


@_trace.collective("all_gather", "data", data="worker_trees", size=group_size)
def all_gather_tree(worker_trees: Iterable[Tree], n: int, group=None) -> Tree:
    """Each leaf gathered over the n workers: a leading worker axis of size
    n, worker order (the JAX package's ``all_gather_flat`` per leaf)."""
    if group is not None:
        tree = _only(worker_trees, "all_gather_tree")
        _check_size(n, group)
        return {k: torch.stack(_gather_leaf(v, n, group)) for k, v in tree.items()}
    trees = list(worker_trees)
    if len(trees) != n:
        raise ValueError(f"all_gather over {len(trees)} workers, expected {n}")
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


@_trace.collective("pmax", "data", data="worker_trees", size=group_size)
def pmax_tree(worker_trees: Iterable[Tree], group=None) -> Tree:
    """Elementwise max over the workers (``lax.pmax`` per leaf)."""
    if group is not None:
        tree = _only(worker_trees, "pmax_tree")
        return _all_reduce_copies(tree, group, dist.ReduceOp.MAX).wait()
    acc = None
    for tree in worker_trees:
        acc = dict(tree) if acc is None else {
            k: torch.maximum(acc[k], v) for k, v in tree.items()}
    if acc is None:
        raise ValueError("pmax over zero workers")
    return acc


@_trace.collective("all_gather", "data", data="rows", size=group_size)
def all_gather_rows(rows: torch.Tensor, group=None) -> torch.Tensor:
    """The ZeRO-1 param all-gather (``all_gather_concat`` over flat rows in
    the JAX package): every worker's row concatenated in worker order, flat
    (n·per,). Locally ``rows`` is (n, per), row w worker w's, already side by
    side; on a group it is this rank's (1, per) row, gathered in rank
    order."""
    if group is None:
        return rows.reshape(-1)
    n = dist.get_world_size(group)
    out = torch.empty((n, *rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    # gathered straight into the rows of the result: no concatenated copy
    dist.all_gather(list(out.unbind(0)), rows.reshape(rows.shape[1:]).contiguous(),
                    group=group)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# the model axis (tensor parallelism)
# ---------------------------------------------------------------------------
# calls of the model-axis primitives since the last reset: "psum_tp" and
# "psum_tp_backward" (one all-reduce each), "all_to_all_tp" and
# "all_to_all_tp_backward", "pmax_tp"; of the sequence-sharded decode's
# data-group reductions, "psum_sp" and "pmax_sp"; and of the pipeline's ring
# sends over the stage group, "ppermute_ring" (either direction)
_TP_COUNTS: Dict[str, int] = {}


def tp_counts() -> Dict[str, int]:
    return dict(_TP_COUNTS)


def reset_tp_counts() -> None:
    _TP_COUNTS.clear()


def _count(name: str) -> None:
    _TP_COUNTS[name] = _TP_COUNTS.get(name, 0) + 1


def new_group(ranks: Sequence[int]):
    """A process group of ``ranks`` (global ranks). Every rank of the world
    calls it, in the same order, for every group, its own or not."""
    return dist.new_group(list(ranks))


def world_rank() -> int:
    return dist.get_rank()


def world_size() -> int:
    return dist.get_world_size()


def _need_group(group, what: str) -> None:
    if group is None:
        raise ValueError(
            f"{what} over the model axis needs the model group of a data × model grid "
            "of ranks (launch.mesh.make_debug_mesh); the local backend simulates "
            "data-parallel workers only and holds no model shards")


class _PsumTp(torch.autograd.Function):
    """all_reduce(SUM) over the model group in the forward pass and again
    in the backward pass (the JAX package's transpose of ``psum`` under
    ``check_vma=False``): every rank's cotangent is summed, so each
    gradient upstream of it comes out tp times the single-device one, as
    the JAX package's do."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("psum_tp")
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        _count("psum_tp_backward")
        return _psum_cotangent(g, ctx.group), None


@_trace.collective("psum", "model", data="g", size=group_size)
def _psum_cotangent(g: torch.Tensor, group) -> torch.Tensor:
    """:class:`_PsumTp`'s backward sum over the model group."""
    out = g.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


@_trace.collective("psum", "model", data="x", size=group_size)
def psum_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The model group's sum of ``x``, differentiable (see :class:`_PsumTp`)."""
    _need_group(group, "psum_tp")
    return _PsumTp.apply(x, group)


@_trace.collective("pmax", "model", data="x", size=group_size)
def pmax_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The model group's elementwise max of ``x``, outside autograd (the JAX
    package stops the gradient there: a stabilizer only)."""
    _need_group(group, "pmax_tp")
    _count("pmax_tp")
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


@_trace.collective("psum", "seq", data="x", size=group_size)
def psum_sp(x: torch.Tensor, group) -> torch.Tensor:
    """The data group's sum of ``x``, outside autograd: the
    sequence-sharded decode's softmax sums over the KV shards (the JAX
    package's ``psum`` over ``axes.sp``)."""
    _need_group(group, "psum_sp")
    _count("psum_sp")
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


@_trace.collective("pmax", "seq", data="x", size=group_size)
def pmax_sp(x: torch.Tensor, group) -> torch.Tensor:
    """The data group's elementwise max of ``x``, outside autograd (the
    sequence-sharded decode's softmax max)."""
    _need_group(group, "pmax_sp")
    _count("pmax_sp")
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


@_trace.collective("all_gather", "model", data="x", size=group_size)
def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, on
    every rank (a checkpoint's model shards made whole for its writer)."""
    return torch.cat(_gather_leaf(x, dist.get_world_size(group), group), dim=dim)


def all_agree(x: torch.Tensor, group) -> bool:
    """Whether every rank of ``group`` holds the same integer tensor ``x``
    (its elementwise max and min over the group both equal it)."""
    hi, lo = x.clone(), x.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return bool(torch.equal(hi, x) and torch.equal(lo, x))


@_trace.collective("psum", "model", data="tree", size=group_size)
def psum_tp_tree(tree: Tree, group) -> Tree:
    """Each leaf summed over the model group, outside autograd: the
    replicated leaves' gradients (each rank holds a partial one) and the
    sharded leaves' squared norms. One async all-reduce per leaf."""
    _need_group(group, "psum_tp_tree")
    return _all_reduce_copies(tree, group).wait()


@_trace.collective("all_to_all", "model", data="x", size=group_size)
def exchange_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The model group's all-to-all along dim 0: ``x`` is (tp, ...), row j
    goes to rank j, and row j of the result came from rank j. Its own
    inverse."""
    x = x.contiguous()
    out = torch.empty_like(x)  # contiguous too: the library writes row-major
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAllTp(torch.autograd.Function):
    """:func:`exchange_tp` whose backward is the inverse exchange (the JAX
    package's transpose of ``all_to_all``: no factor)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _count("all_to_all_tp")
        return exchange_tp(x, group)

    @staticmethod
    def backward(ctx, g):
        _count("all_to_all_tp_backward")
        return exchange_tp(g, ctx.group), None


@_trace.collective("all_to_all", "model", data="x", size=group_size)
def all_to_all_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all over the model group along dim 0 (``x`` is
    (tp, ...): row j is sent to rank j)."""
    _need_group(group, "all_to_all_tp")
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all_tp: dim 0 is {x.shape[0]}, the group has "
                         f"{dist.get_world_size(group)} ranks")
    return _AllToAllTp.apply(x, group)


# ---------------------------------------------------------------------------
# the stage axis (pipeline parallelism)
# ---------------------------------------------------------------------------
@_trace.collective("ppermute", "stage", data="x", size=group_size)
def ppermute_ring(x: torch.Tensor, group, *, shift: int = 1) -> torch.Tensor:
    """The pipeline's ring send over the stage group (the JAX package's
    ``ppermute_ring``), outside autograd (the pipeline's backward runs the
    inverse ring itself): rank r sends ``x`` to rank (r + shift) mod n and
    returns what rank (r - shift) mod n sent, of the same shape and type.
    One ``all_to_all_single`` whose only nonzero splits are the two
    neighbours', so only ``x``'s bytes move, by the same call on gloo (which
    takes card tensors in it; its ``send``/``recv`` does not) and NCCL.
    There is no local backend: without a group it raises."""
    if group is None:
        raise ValueError(
            "ppermute_ring over the stage axis needs the stage group of ranks; the local "
            "backend simulates data-parallel workers only and holds no pipeline stages")
    _count("ppermute_ring")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    flat = x.detach().contiguous().view(-1)
    out = torch.empty_like(flat)
    send, recv = [0] * n, [0] * n
    send[(r + shift) % n] = recv[(r - shift) % n] = flat.numel()
    dist.all_to_all_single(out, flat, output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    return out.view(x.shape)
