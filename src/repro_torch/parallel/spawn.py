"""Run a function on n real ranks of a ``torch.distributed`` process group
(the port's counterpart of the JAX tests' forced 4-device mesh).

    results = run_ranks(fn, 4, args=(...,), backend="gloo")

spawns n fresh processes (``torch.multiprocessing``, start method
"spawn"), joins them to one process group through a ``file://`` store in a
temporary directory (no TCP port, so parallel callers cannot collide),
sets one intra-op thread per rank, and calls ``fn(group, rank, *args)`` on
each. ``fn`` must be importable by name (a module-level function). Each
rank's return value comes back through a queue, serialized with
``torch.save`` (tensors moved to the CPU first); the list is in rank
order. If any rank raises or dies, or the ranks outlive ``timeout_s``,
the whole call raises, and no rank is left running.
"""
from __future__ import annotations

import io
import os
import queue as queue_mod
import tempfile
import time

import torch
import torch.multiprocessing as mp

from repro_torch.parallel import collectives as coll


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _rank_main(rank, fn, n, store, backend, device, timeout_s, args, results):
    torch.set_num_threads(1)
    dev = None if device is None else torch.device(device)
    group = coll.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                    world_size=n, timeout_s=timeout_s, device=dev)
    try:
        out = fn(group, rank, *args)
        buf = io.BytesIO()
        torch.save(_to_cpu(out), buf)
        results.put((rank, buf.getvalue()))
        coll.barrier(group)  # every rank's result is queued before any leaves
    finally:
        coll.destroy_process_group()


def run_ranks(fn, n: int, *, args=(), backend: str = "gloo", device=None,
              timeout_s: float = 600.0) -> list:
    """``fn(group, rank, *args)`` on ``n`` spawned ranks; returns their
    results in rank order. ``device`` binds NCCL ranks to a card (gloo
    ranks may share one)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = mp.start_processes(
            _rank_main, args=(fn, n, store, backend, device, timeout_s, args, results),
            nprocs=n, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                _drain(results, got)
                # raises ProcessRaisedException / ProcessExitedException if
                # a rank failed
                if procs.join(timeout=0.2):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks still running after {timeout_s} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                    p.join()
        _drain(results, got)
    if sorted(got) != list(range(n)):
        raise RuntimeError(f"ranks {sorted(set(range(n)) - set(got))} returned no result")
    return [torch.load(io.BytesIO(got[r]), weights_only=False) for r in range(n)]


def _drain(results, got: dict) -> None:
    while True:
        try:
            rank, payload = results.get_nowait()
        except queue_mod.Empty:
            return
        got[rank] = payload
