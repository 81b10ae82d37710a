"""Collectives of the local n-worker backend (port of the matching subset of
``repro/parallel/collectives.py``).

One process drives one card and simulates the n data-parallel workers in
turn, the role ``vmap_workers`` plays in the JAX package: what would cross
the wire between workers meets here instead. Every reduction the train step
needs goes through this module, so a process-group backend (NCCL) can take
its place later without touching the call sites.

The integer-only guard carries over: gradient payloads summed here must be
integer transport words — the paper's floatless wire is structural.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from repro_torch.kernels.ref import wrap_int

Tree = Dict[str, torch.Tensor]


def check_wire_dtypes(words: Tree) -> None:
    for name, v in words.items():
        if v.is_floating_point() or v.is_complex():
            raise TypeError(
                f"wire payload {name!r} must be integer, got {v.dtype} — the "
                "IntSGD wire carries no floats (float reductions go through "
                "pmean_tree)"
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


def psum_wire_words(worker_words: Iterable[Tree]) -> Tree:
    """The integer all-reduce of the n workers' word planes."""
    acc = None
    for words in worker_words:
        acc = add_wire_words(acc, words)
    if acc is None:
        raise ValueError("psum over zero workers")
    return acc


def pmean_tree(worker_trees: Iterable[Tree], n: int) -> Tree:
    """Float mean over the n workers (the exact step-0 aggregation), summed
    in worker order in f32."""
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


def all_gather_tree(worker_trees: Iterable[Tree], n: int) -> Tree:
    """Each leaf gathered over the n workers: a leading worker axis of size
    n, worker order (the JAX package's ``all_gather_flat`` per leaf)."""
    trees = list(worker_trees)
    if len(trees) != n:
        raise ValueError(f"all_gather over {len(trees)} workers, expected {n}")
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def all_gather_rows(rows: torch.Tensor) -> torch.Tensor:
    """The ZeRO-1 param all-gather (``all_gather_concat`` over flat rows in
    the JAX package): row w of ``rows`` (n, per) is worker w's; returns
    every worker's row concatenated in worker order, flat (n·per,). On the
    local backend the n rows already sit side by side."""
    return rows.reshape(-1)
