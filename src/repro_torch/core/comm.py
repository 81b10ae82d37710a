"""Communication context of the local n-worker backend (port of
``repro/core/comm.py``).

Compressors are written against ``CommCtx`` only. In the JAX package the
same per-worker code runs under ``shard_map`` or ``vmap``; here one process
runs the n workers in turn, so the calls that aggregate take the workers'
contributions as an iterable, in worker order. A generator works: the train
step yields one worker's gradients at a time, so a worker's float gradients
are freed before the next worker's backward runs and only the integer word
sum stays resident.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.parallel import collectives as coll

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CommCtx:
    n_workers: int
    worker: int = 0  # the worker whose view this is

    def __post_init__(self):
        if self.n_workers < 1 or not 0 <= self.worker < self.n_workers:
            raise ValueError(
                f"worker {self.worker} of {self.n_workers} is out of range"
            )

    @property
    def n(self) -> int:
        return self.n_workers

    def at_worker(self, worker: int) -> "CommCtx":
        return dataclasses.replace(self, worker=worker)

    def worker_index(self) -> int:
        """Data-parallel worker id in [0, n)."""
        return self.worker

    def psum_wire(self, worker_ints: Iterable[Tree], wf) -> Tuple[Tree, Tree]:
        """Codec-aware integer aggregation: pack each worker's image with
        the wire format ``wf`` as it arrives, sum the word planes across
        workers in their own integer type with its wrap-around (the only
        thing that would cross the wire: int32 packed words, or dense
        int8/int16/int32 lanes), and unpack once. Returns ``(words_sum, int_sum)`` — the fused
        update consumes the words, the clip factor and metrics the image."""
        shapes = {}

        def payloads():
            count = 0
            for ints in worker_ints:
                count += 1
                for k, v in ints.items():
                    shapes[k] = tuple(v.shape)
                yield {k: wf.pack(v, n_workers=self.n) for k, v in ints.items()}
                del ints
            if count != self.n:
                raise ValueError(f"psum_wire over {count} workers, expected {self.n}")

        words_sum = coll.psum_wire_words(payloads())
        int_sum = {
            k: wf.unpack(w, shapes[k], n_summed=self.n)
            for k, w in words_sum.items()
        }
        return words_sum, int_sum

    def pmean(self, worker_trees: Iterable[Tree]) -> Tree:
        return coll.pmean_tree(worker_trees, self.n)

    def all_gather(self, worker_trees: Iterable[Tree]) -> Tree:
        """Gather with a leading worker axis of size n."""
        return coll.all_gather_tree(worker_trees, self.n)
