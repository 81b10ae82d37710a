"""Fault-tolerant checkpointing (port of ``repro/checkpoint/store.py``, with
the same properties and the same layout on disk).

  * atomic publish: a step is written to ``step_%010d.tmp/`` and then
    renamed to ``step_%010d/``, so a crashed writer never leaves a torn
    latest checkpoint;
  * keep-last-k garbage collection;
  * an asynchronous writer thread: ``save`` copies the state to host memory
    before it returns and the thread writes it; a write's error is raised
    by ``wait()``;
  * ``manifest.json`` with each array's shape and dtype and a sha256
    checksum of the tree (keys and shapes); one ``<sha1(key)[:16]>.npy``
    file per array;
  * ``restore(tree_like, step)`` rejects a structure or shape mismatch, and
    a leaf held one row per worker (:func:`rank_rows`) saved at another
    worker count, naming the leaf and both counts (an elastic resume at n'
    workers loads a state whose leaves are all replicated).

Keys join a state tree's path with "/": dict keys, tuple indices and a
dataclass's fields as ``.name`` — the JAX package's
``tree_flatten_with_path`` spelling — so a float32 tree written by either
package is read by the other. A bf16 tensor is stored as its uint16 bit
pattern with ``bfloat16`` in the manifest (no ``ml_dtypes`` needed to read
it back).

The layout is global, as the JAX package's. On a ``torch.distributed``
process group the train state's per-rank rows (the ZeRO-1 master and
optimizer rows, IntDIANA's ``h_local``, the error-feedback residuals:
:func:`rank_rows`) are gathered on save and rank 0 writes; on restore each
rank takes its own row. So a checkpoint written by n ranks resumes on the
local n-worker backend, and the other way round.

On a data × model grid (``grid=``, ``launch.mesh.Grid``) the store
writes the JAX package's global train state, as its ``np.asarray(leaf)``
holds it under ``build_train_step(...).arg_structs[1:3]`` at the same
(dp, tp):

  * each leaf's model shards are gathered over the model group along its
    spec (``specs``: ``launch.specs.infer_param_specs``'s, by param name;
    the inverse of ``TpShard``): the params, the fused route's optimizer
    state and the param-shaped compressor entries;
  * a ZeRO-1 row (the f32 master and the optimizer rows) is a rank's row
    of its local shard, and the global leaf is (n_dp, tp · per): the
    members' rows side by side, whatever the param's spec (the JAX
    package's ``zero1_state_specs``);
  * every compressor entry carries a leading data axis of n_dp: the
    per-worker entries their rows, the replicated ones (α's state,
    IntDIANA's global shift, PowerSGD's Q) each data replica's copy;
  * PowerSGD's Q (cols, rank) is gathered along its rows where its param
    is sharded past its rows, else kept whole: model rank 0's copy, as
    the JAX package's ``np.asarray`` holds it, though each model rank's
    own Q differs once a step has run (a param sharded on its rows, such
    as ``embed``), so a resumed PowerSGD run at tp > 1 differs from the
    uninterrupted one on those leaves, in both packages.

Rank (0, 0) writes. ``restore`` reads the global array and keeps this
rank's model slice and its own rows; a replicated compressor entry is read
from its replica's copy (the first at another data count), so an elastic
resume onto a grid of fewer data replicas loads a state whose leaves are
all replicated over dp. ``stats`` holds the last save's and restore's
seconds and bytes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.compressor import PowerSGD
from repro_torch.parallel import collectives as coll

Arrays = Dict[str, torch.Tensor]


def _key(prefix: str, part) -> str:
    return f"{prefix}/{part}" if prefix else str(part)


def flatten_state(tree: Any, prefix: str = "") -> Arrays:
    """Every tensor of a state tree (nested dicts, tuples and lists,
    dataclasses such as ``AlphaState``) by its "/"-joined path; ``None``
    and empty containers hold none."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in sorted(tree.items()))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif dataclasses.is_dataclass(tree):
        items = ((f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree))
    elif tree is None:
        return out
    else:
        raise TypeError(f"{prefix or 'state'}: cannot checkpoint a {type(tree).__name__}")
    for part, v in items:
        out.update(flatten_state(v, _key(prefix, part)))
    return out


def unflatten_like(tree_like: Any, arrays: Arrays, prefix: str = "") -> Any:
    """``tree_like``'s structure with each tensor replaced by
    ``arrays[path]``."""
    if isinstance(tree_like, torch.Tensor):
        return arrays[prefix]
    if isinstance(tree_like, dict):
        return {k: unflatten_like(v, arrays, _key(prefix, k)) for k, v in tree_like.items()}
    if isinstance(tree_like, (tuple, list)):
        return type(tree_like)(unflatten_like(v, arrays, _key(prefix, i))
                               for i, v in enumerate(tree_like))
    if dataclasses.is_dataclass(tree_like):
        return dataclasses.replace(tree_like, **{
            f.name: unflatten_like(getattr(tree_like, f.name), arrays, _key(prefix, f".{f.name}"))
            for f in dataclasses.fields(tree_like)})
    return tree_like


# compressor-state entries that every rank holds whole (α's state, IntDIANA's
# global shift, PowerSGD's Q); the rest of a compressor's state is per worker
_REPLICATED_COMP = (".r", ".step", "alpha", "h_global", "q")


def rank_rows(key: str) -> bool:
    """Whether the leaf ``key`` of a ``{"params", "opt", "comp"}`` train
    state is held one row per rank on a process group (its leading axis is
    the worker's): the ZeRO-1 masters and optimizer rows but AdamW's
    count, and every per-worker compressor entry (``h_local``, ``ef``,
    PowerSGD's ``err``, SignSGD's and TopK's residual tree)."""
    parts = key.split("/")
    if parts[0] == "opt":
        return parts[1] == "master" or (parts[1] == "base" and key != "opt/base/count")
    return parts[0] == "comp" and len(parts) > 1 and parts[1] not in _REPLICATED_COMP


def model_dim(key: str, ndim: int, specs: Dict[str, Optional[int]]) -> Optional[int]:
    """The dimension of the train-state leaf ``key`` (of ``ndim`` dims)
    that the model axis shards in the global layout: 1 for a ZeRO-1 row
    (its columns), PowerSGD's Q's rows where its param is sharded past its
    rows (``PowerSGD.q_model_dim``), else its param's spec (``key`` ends in
    the param's name) after the rows' axis if it has one; None for a
    replicated leaf or a scalar (AdamW's count, α's state, blockwise α's
    per-leaf r)."""
    parts = key.split("/")
    if parts[0] == "opt" and rank_rows(key):
        return 1
    name = next((n for n in ("/".join(parts[i:]) for i in range(1, len(parts)))
                 if n in specs), None)
    if name is None or specs[name] is None:
        return None
    if parts[:2] == ["comp", "q"]:  # PowerSGD's Q (cols, rank)
        return PowerSGD.q_model_dim(specs[name])
    dim = specs[name] + (1 if rank_rows(key) else 0)
    return dim if dim < ndim else None


def _to_numpy(t: torch.Tensor, copy: bool = True):
    """A host copy of ``t`` (or, without ``copy``, ``t`` itself if it is on
    the host already) and its manifest dtype."""
    t = t.detach().to("cpu", copy=copy)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":  # the bit pattern, whichever package wrote it
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree_checksum(shapes: Dict[str, tuple]) -> str:
    h = hashlib.sha256()
    for key in sorted(shapes):
        h.update(key.encode())
        h.update(str(tuple(shapes[key])).encode())
    return h.hexdigest()


class CheckpointStore:
    """Checkpoints of state trees under ``directory``. With a process
    ``group``, or on a data × model ``grid`` (with each param leaf's model
    ``specs``, needed at tp > 1), every rank calls ``save`` and ``restore``
    on a train state (see the module docstring)."""

    def __init__(self, directory: str, keep_last: int = 3, async_writes: bool = True,
                 group=None, grid=None, specs: Optional[Dict[str, Optional[int]]] = None):
        if grid is not None:
            if group is not None:
                raise ValueError("pass the grid or a group, not both: the grid's data group "
                                 "holds the rows")
            if grid.tp > 1 and specs is None:
                raise ValueError(
                    f"a checkpoint at tp = {grid.tp} gathers each leaf's model shards along "
                    "its spec: pass specs=launch.specs.infer_param_specs(cfg, tp)[2]")
            group = grid.data_group
        self.dir = directory
        self.grid = grid
        self.specs = specs or {}
        self.keep_last = keep_last
        self.group = group
        self.rank = 0 if group is None else coll.group_rank(group)
        # the rank that writes: rank 0 of the group, model index 0 on a grid
        self.writer = self.rank == 0 and (grid is None or grid.tp_index == 0)
        self.stats: Dict[str, float] = {}
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._async = async_writes
        self._err: Optional[BaseException] = None
        self._thread = None
        if async_writes and self.writer:
            self._thread = threading.Thread(target=self._writer_loop, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        """Snapshot ``tree`` to host memory now; write it in the background
        (or now, without async writes)."""
        t0 = time.perf_counter()
        arrays = {}
        for k, t in flatten_state(tree).items():
            g = t
            if self.grid is not None:
                g = self._global(k, t)
            elif self.group is not None and rank_rows(k):
                g = self._gather(t)
            if self.writer:  # a gathered leaf is a fresh tensor: no copy of it
                arrays[k] = _to_numpy(g, copy=g is t)
            del g
        if not self.writer:
            return
        self.stats.update(host_s=time.perf_counter() - t0,
                          bytes=float(sum(a.nbytes for a, _ in arrays.values())))
        if self._async:
            self._q.put((step, arrays, extra or {}))
        else:
            self._write(step, arrays, extra or {})

    def _gather(self, rows: torch.Tensor) -> torch.Tensor:
        """A rank's (1, ...) row -> every rank's rows, (n, ...)."""
        flat = coll.all_gather_rows(rows, self.group)
        return flat.reshape(-1, *rows.shape[1:])

    def _global(self, key: str, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The grid rank's leaf ``key`` -> its global layout (the module
        docstring) on the ranks of model index 0, None on the others: the
        model shards gathered over the model group, then the rows gathered
        over the data group, or a replicated compressor entry stacked n_dp
        times."""
        g = self.grid
        dim = model_dim(key, t.dim(), self.specs) if g.tp > 1 else None
        if dim is not None:
            t = coll.all_gather_cat(t, g.model_group, dim)
        if g.tp_index != 0:  # the writer's data group holds model index 0
            return None
        if rank_rows(key):
            return self._gather(t)
        if key.startswith("comp/"):
            return t[None].expand(g.n_dp, *t.shape)
        return t

    def wait(self) -> None:
        """Block until every queued write is on disk (and, on a group, until
        rank 0's are; on a grid the writer's: its data group's barrier, then
        each model group's); raise a write's error."""
        if self._async:
            self._q.join()
        if self.group is not None:
            coll.barrier(self.group)
        if self.grid is not None and self.grid.tp > 1:
            coll.barrier(self.grid.model_group)
        if self._err is not None:
            raise self._err

    def close(self) -> None:
        """Finish the queued writes and stop the writer thread."""
        if self._thread is not None:
            self._q.join()
            self._q.put(None)
            self._thread.join()
            self._thread = None

    def _writer_loop(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                self._write(*job)
            except Exception as e:  # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, arrays: dict, extra: dict):
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra, "arrays": {}}
        for key in sorted(arrays):
            a, dtype = arrays[key]
            fn = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            np.save(os.path.join(tmp, fn), a)
            manifest["arrays"][key] = {"file": fn, "shape": list(a.shape), "dtype": dtype}
        manifest["tree_checksum"] = _tree_checksum(
            {k: a.shape for k, (a, _) in arrays.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        self.stats["disk_s"] = time.perf_counter() - t0

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None):
        """``(tree, extra, step)``: the checkpoint of ``step`` (the latest by
        default) in ``tree_like``'s structure, each tensor in the type and
        on the device of ``tree_like``'s; on a group each rank's own rows,
        on a grid its model slice of them too."""
        t0 = time.perf_counter()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        metas = manifest["arrays"]
        if _tree_checksum({k: m["shape"] for k, m in metas.items()}) != manifest[
                "tree_checksum"]:
            raise ValueError(f"{d}: the manifest's tree checksum does not match its arrays")
        want = flatten_state(tree_like)
        if sorted(want) != sorted(metas):
            missing = set(want) - set(metas)
            extra = set(metas) - set(want)
            raise ValueError(f"tree mismatch: missing={missing} extra={extra}")
        out = {}
        n_now = None if self.group is None else coll.group_size(self.group)
        tp = 1 if self.grid is None else self.grid.tp
        for key, like in want.items():
            meta = metas[key]
            a = np.load(os.path.join(d, meta["file"]), mmap_mode="r")
            dim = model_dim(key, like.dim(), self.specs) if tp > 1 else None
            if rank_rows(key):
                n_saved, n = a.shape[0], like.shape[0] if n_now is None else n_now
                if n_saved != n:  # never sliced or padded to the new count
                    raise ValueError(
                        f"{key}: held one row per worker, saved by {n_saved} workers, "
                        f"cannot be restored at {n}; resume at {n_saved} workers, or from "
                        "a state whose leaves are all replicated (the fused route with "
                        "IntSGD)")
                if self.group is not None:
                    a = a[self.rank:self.rank + 1]
            elif key.startswith("comp/") and a.ndim == like.dim() + 1:
                # each data replica's copy of a replicated entry (the global layout)
                a = a[self.rank if a.shape[0] == (n_now or 1) else 0]
            if dim is not None:
                n_loc = like.shape[dim]
                if a.shape[dim] != n_loc * tp:
                    raise ValueError(f"{key}: {a.shape[dim]} along its model dimension "
                                     f"{dim}, expected {n_loc} x tp = {n_loc * tp}")
                idx = [slice(None)] * a.ndim
                idx[dim] = slice(self.grid.tp_index * n_loc, (self.grid.tp_index + 1) * n_loc)
                a = a[tuple(idx)]
            if tuple(a.shape) != tuple(like.shape):
                raise ValueError(f"{key}: shape {tuple(a.shape)} != expected {tuple(like.shape)}")
            out[key] = _from_numpy(np.array(a), meta["dtype"]).to(like.device, like.dtype)
        self.stats["restore_s"] = time.perf_counter() - t0
        return unflatten_like(tree_like, out), manifest["extra"], step
