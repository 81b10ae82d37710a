"""Communication context (port of ``repro/core/comm.py``), on the local
n-worker backend or on a ``torch.distributed`` process group.

Compressors are written against ``CommCtx`` only. In the JAX package the
same per-worker code runs under ``shard_map`` or ``vmap``. Here the calls
that aggregate take the contributions of this context's LOCAL workers
(:meth:`CommCtx.local_workers`) as an iterable, in worker order:

- locally (``group=None``) one process runs the n workers in turn, and the
  local workers are all n. A generator works: the train step yields one
  worker's gradients at a time, so a worker's float gradients are freed
  before the next worker's backward runs and only the integer word sum
  stays resident;
- on a process group each rank is one worker (``worker_index()`` is the
  rank, ``n`` the world size), its one local worker is itself, and the
  collectives are the library's.

Everything downstream of a sum is the same on every rank, so every rank
ends a step with bit-identical params.

On a data × model grid (``launch/mesh.py``) the context's group is the
rank's data group: n is the number of dp replicas and ``worker_index()``
the dp index, so the TP members of one replica draw the same encode seeds
(the JAX package's ``fold_worker_key`` folds in the data-parallel index
only). ``model_group`` is the rank's model group, which only
:meth:`CommCtx.pmax_global` reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.parallel import collectives as coll
from repro_torch.wire import bucketing

Tree = Dict[str, torch.Tensor]
OVERLAP_MODES = ("off", "ring")


@dataclasses.dataclass(frozen=True)
class CommCtx:
    n_workers: int
    worker: int = 0  # the worker whose view this is
    # a torch.distributed group (one rank per worker), or None: the local
    # backend
    group: Optional[Any] = None
    # "ring": the integer wire is cut into buckets of bucket_words words,
    # each all-reduced on its own (the JAX package's overlapped ring wire)
    overlap: str = "off"
    bucket_words: int = bucketing.DEFAULT_BUCKET_WORDS
    # the model group of a data × model grid (tp > 1), or None: the JAX
    # package's model_axis
    model_group: Optional[Any] = None

    def __post_init__(self):
        if self.model_group is not None and self.group is None:
            raise ValueError(
                "a model group needs the data group of its grid: the local backend "
                "simulates data-parallel workers only and holds no model shards")
        if self.n_workers < 1 or not 0 <= self.worker < self.n_workers:
            raise ValueError(
                f"worker {self.worker} of {self.n_workers} is out of range"
            )
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(
                f"unknown overlap mode {self.overlap!r}; options {OVERLAP_MODES}"
            )
        if self.bucket_words <= 0:
            raise ValueError(f"bucket_words must be positive, got {self.bucket_words}")

    @classmethod
    def on_group(cls, group, **kw) -> "CommCtx":
        """This rank's context on ``group``: n is the world size, the
        worker the rank."""
        return cls(n_workers=coll.group_size(group), worker=coll.group_rank(group),
                   group=group, **kw)

    @property
    def n(self) -> int:
        return self.n_workers

    def at_worker(self, worker: int) -> "CommCtx":
        if self.group is not None and worker != self.worker:
            raise ValueError(f"rank {self.worker} cannot act as worker {worker}")
        return dataclasses.replace(self, worker=worker)

    def worker_index(self) -> int:
        """Data-parallel worker id in [0, n): the rank on a group."""
        return self.worker

    def local_workers(self) -> range:
        """The workers this process runs, in order: all n locally, the
        rank alone on a group."""
        if self.group is None:
            return range(self.n)
        return range(self.worker, self.worker + 1)

    @property
    def n_local(self) -> int:
        return len(self.local_workers())

    def local_slot(self, worker: int) -> int:
        """Index of ``worker``'s row in per-worker state this process holds
        (IntDIANA's h_local): the worker locally, 0 on a group."""
        return worker - self.local_workers().start

    def psum_wire(self, worker_ints: Iterable[Tree], wf) -> Tuple[Tree, Tree]:
        """Codec-aware integer aggregation: pack each local worker's image
        with the wire format ``wf`` as it arrives, sum the word planes
        across workers in their own integer type with its wrap-around (the
        only thing that crosses the wire: int32 packed words, or dense
        int8/int16/int32 lanes), and unpack once. Returns ``(words_sum,
        int_sum)`` — the fused update consumes the words, the clip factor
        and metrics the image. With ``overlap="ring"`` the words travel in
        buckets; the sums are bit-identical to the serial route's. A gather
        codec's payload is all-gathered instead and its unpack sums
        (:meth:`_gather_wire_start`): ``words_sum`` is then the gathered
        planes."""
        return self.psum_wire_start(worker_ints, wf).wait()

    def psum_wire_start(self, worker_ints: Iterable[Tree], wf) -> coll.Pending:
        """:meth:`psum_wire` with the reduce issued and not waited on: the
        images are encoded and packed (the workers' backward passes run)
        now, the unpack when the :class:`~repro_torch.parallel.collectives.Pending`
        is waited on."""
        if getattr(wf, "transport", "psum") == "gather":
            return self._gather_wire_start(worker_ints, wf)
        shapes = {}
        manifest = []

        def pack(v):
            w = wf.pack(v, n_workers=self.n)
            # a dense32 lane is the image itself: copy it before the
            # in-place reduce, which must not touch the caller's image
            return w.clone() if w.data_ptr() == v.data_ptr() else w

        def payloads():
            count = 0
            for ints in worker_ints:
                count += 1
                for k, v in ints.items():
                    shapes[k] = tuple(v.shape)
                yield {k: pack(v) for k, v in ints.items()}
                del ints
            if count != self.n_local:
                raise ValueError(
                    f"psum_wire over {count} workers, expected {self.n_local}")

        def buckets():
            for words in payloads():
                if not manifest:
                    manifest.append(bucketing.plan_buckets(
                        words, bucket_words=self.bucket_words))
                yield bucketing.bucketize(words, manifest[0])
                del words

        # the packed payloads are this call's own: reduced in place
        if self.overlap == "ring":
            pending = coll.psum_wire_words_bucketed(buckets(), self.group, async_op=True,
                                                    inplace=True)
            pending = pending.then(lambda b: bucketing.debucketize(b, manifest[0]))
        else:
            pending = coll.psum_wire_words(payloads(), self.group, async_op=True,
                                           inplace=True)

        def unpack(words_sum):
            int_sum = {
                k: wf.unpack(w, shapes[k], n_summed=self.n)
                for k, w in words_sum.items()
            }
            return words_sum, int_sum

        return pending.then(unpack)

    def _gather_wire_start(self, worker_ints: Iterable[Tree], wf) -> coll.Pending:
        """The gather-shaped transport (a gather codec such as TopKInt):
        each local worker's image packed (with n, as the JAX package packs
        it) into its planes, bucketed (one bucket, or ``bucket_words``-word
        buckets with ``overlap="ring"``), all-gathered as integers, and
        unpacked by the codec, which sums the n workers' contributions
        itself. The returned ``words`` are the gathered planes, each with a
        leading worker axis."""
        shapes = {}
        manifest = []

        def buckets():
            count = 0
            for ints in worker_ints:
                count += 1
                payload = {}
                for k, v in ints.items():
                    shapes[k] = tuple(v.shape)
                    payload[k] = wf.pack(v, n_workers=self.n)
                del ints
                if not manifest:
                    total = sum(p.numel() for planes in payload.values()
                                for p in planes.values())
                    manifest.append(bucketing.plan_buckets(payload, bucket_words=(
                        self.bucket_words if self.overlap == "ring" else max(total, 1))))
                yield bucketing.bucketize(payload, manifest[0])
                del payload
            if count != self.n_local:
                raise ValueError(
                    f"psum_wire over {count} workers, expected {self.n_local}")

        def unpack(gathered_buckets):
            gathered = bucketing.debucketize_gathered(gathered_buckets, manifest[0])
            int_sum = {k: wf.unpack(p, shapes[k], n_summed=self.n)
                       for k, p in gathered.items()}
            return gathered, int_sum

        return coll.allgather_wire_words(buckets(), self.n, self.group,
                                         async_op=True).then(unpack)

    def pmean(self, worker_trees: Iterable[Tree], *, ordered: bool = False) -> Tree:
        """Float mean over the workers; ``ordered`` sums in worker order on
        a group too (bit-identical to the local backend; see
        :func:`~repro_torch.parallel.collectives.pmean_tree`)."""
        return coll.pmean_tree(worker_trees, self.n, self.group, ordered=ordered)

    def mean_scalars(self, local_values) -> torch.Tensor:
        """Mean over the workers of one 0-d tensor each (the loss): the
        workers' values stacked in worker order, summed, over n —
        bit-identical on both backends."""
        stacked = torch.stack(list(local_values))
        if self.group is not None:
            stacked = coll.all_gather_tree([{"v": stacked}], self.n, self.group)["v"]
        return torch.sum(stacked.reshape(-1)) / self.n

    def all_gather(self, worker_trees: Iterable[Tree]) -> Tree:
        """Gather with a leading worker axis of size n."""
        return coll.all_gather_tree(worker_trees, self.n, self.group)

    def pmax(self, worker_trees: Iterable[Tree]) -> Tree:
        return coll.pmax_tree(worker_trees, self.group)

    def pmax_global(self, worker_trees: Iterable[Tree]) -> Tree:
        """Max over the workers AND the TP shards (profiling reductions that
        must see the whole model, e.g. Heuristic IntSGD's max_exp): over
        the data group, then the model group when there is one."""
        out = self.pmax(worker_trees)
        if self.model_group is not None:
            out = coll.pmax_tree([out], self.model_group)
        return out
