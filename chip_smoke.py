#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            (from the repository root)

Phases, each of which must pass for the exit code to be 0:

  1. build   — compile the eight hand-written kernels (four sources in
               src/repro_torch/csrc) with nvcc for sm_90a, one nvcc per
               source, in parallel;
  2. kernels — hold each kernel and each of its variants against its plain
               PyTorch version on the card, at the main path's largest leaf
               (234,881,024 elements) and at a ragged size (1,000,003):
               integer kernels bit-equal, the fused updates bit-equal too
               (built with --fmad=false and IEEE sqrt/division; tolerance
               0) — packed SGD with shift, packed AdamW with and without
               shift, dense SGD and AdamW on int8/int16/int32 lanes with and
               without shift. Checks the wrap-around psum law with saturated
               fields (packed) and the lane-type sum at its extremes
               (dense), and times each kernel variant (median per launch
               over batches of 20 launches, CUDA events) and its plain
               version (median of single runs). block_norms (one launch;
               float32 and int32, nblocks 1 and 4, at the largest leaf, at
               1,000,003, at a size whose last chunk is empty, at one
               element, and at 65,535 blocks) is held to its plain version
               and to a float64 sum at rtol 1e-5 (the three sum in
               different orders); a second launch, a misaligned view x[1:]
               of the largest leaf, and all cases relaunched interleaved
               must agree bit for bit (the ticket counters return to 0).
               At the largest leaf it is timed in turns with torch.dot(x, x)
               (the library call) and torch.sum(x) (a read-rate probe), and
               at every granite-8b leaf size from a CUDA graph, summed per
               compressed step;
  3. train   — the headline path through the user entry point
               (launch.train.train_loop): granite-8b at full width, depth
               cut to 4 layers, 4 data-parallel workers simulated on the
               card, per-worker batch 1, seq 2048, packed8 wire, IntSGD,
               fused AdamW (wd 1e-4, lr 3e-4 with 5-step warmup), clip 1.0,
               4 steps (step 0 exact);
  4. train-sgd — slice 1's path, the same at 4 layers with fused
               momentum SGD (lr 0.3);
  5. family  — the six other corners of {SGD, AdamW} × {IntSGD, IntDIANA}
               × {packed8, dense8} at full width, depth 2, 4 workers,
               3 steps each;
  6. train-block — IntSGD with blockwise α (Alg. 2, one α per leaf) on
               the packed8 fused-SGD route, 4 layers, 4 steps: each leaf's
               α on the first compressed step is printed and must be
               finite, positive and not all equal.
               In phases 3-6 the launch counts are zeroed just before each
               path and read just after: every kernel's count (and count
               of launches with an IntDIANA shift) must equal what that
               path implies, losses must be finite and max_int <= 4·31;
  7. wire    — step 1 of the headline path replayed for one leaf: the
               unpacked word sum equals the sum of the four workers' images.

Prints one JSON line of per-kernel numbers, then the card's name and power
limit (nvidia-smi), then {"ok": true, "device": {...}} as the last line.
Exits nonzero, printing no result, without a CUDA device or outside the
repository.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LARGEST_LEAF = 4 * 4096 * 14336  # layers/mlp/w_* at 4 layers
RAGGED = 1_000_003
N_WORKERS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# the TPU kernel each CUDA kernel replaces
REPLACES = {
    "int_compress": "src/repro/kernels/int_compress.py:66",
    "pack_words": "src/repro/kernels/wire_pack.py:43",
    "unpack_words": "src/repro/kernels/wire_pack.py:68",
    "fused_unpack_sgd": "src/repro/kernels/fused_update.py:219",
    "fused_unpack_adamw": "src/repro/kernels/fused_update.py:219",
    "fused_apply_sgd": "src/repro/kernels/fused_update.py:176",
    "fused_apply_adamw": "src/repro/kernels/fused_update.py:176",
    "block_norms": "src/repro/kernels/block_norms.py:30",
}
# float/integer operations per image element, counted from each kernel's
# arithmetic (for the compute side of the bound)
OPS_PER_ELEMENT = {
    "int_compress": 20, "pack_words": 3, "unpack_words": 3, "fused_unpack_sgd": 8,
    "fused_unpack_adamw": 20, "fused_apply_sgd": 8, "fused_apply_adamw": 18,
    "block_norms": 2,
}
# the variant of each kernel the headline numbers use: the main path's
# (packed8, no shift) or, for the dense kernels, int8 lanes without shift
MAIN_VARIANT = {
    "int_compress": "stochastic", "pack_words": "packed8", "unpack_words": "packed8",
    "fused_unpack_sgd": "packed8", "fused_unpack_adamw": "packed8",
    "fused_apply_sgd": "int8", "fused_apply_adamw": "int8",
    "block_norms": "float32",
}
STATE_BYTES = {"sgd": 16, "adamw": 24}  # f32 p and state, read and written


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bytes_moved(name: str, d: int, lane_bytes: float, shift: bool = False) -> int:
    """Bytes the function must move: each input read once, each output
    written once. ``lane_bytes`` is the integer payload per element (4/k
    for packed words, 1, 2 or 4 for dense lanes)."""
    payload = int(round(lane_bytes * d))
    fixed = {
        "int_compress": 8 * d,
        "pack_words": 4 * d + payload,
        "unpack_words": payload + 4 * d,
    }
    if name in fixed:
        return fixed[name]
    kernel = name.rsplit("_", 1)[1]
    return payload + STATE_BYTES[kernel] * d + (8 * d if shift else 0)


def bound(name: str, nbytes: int, d: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT[name] * d / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def batch_ms(torch, fn, batch: int) -> float:
    """Device time per run of ``fn``: CUDA events around ``batch`` runs."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(batch):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / batch


def interleaved_ms(torch, fns, rounds: int = 12, batch: int = 20) -> list:
    """Median time per run of each function, timed in turns within one call
    (f1, f2, ..., f2, f1 in every round, each a batch of ``batch`` runs):
    the way to tell two versions apart by 1 %."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(rounds):
        for i in order + order[::-1]:
            times[i].append(batch_ms(torch, fns[i], batch))
    return [statistics.median(t) for t in times]


def graph_ms(torch, fn, batch: int = 20, reps: int = 7) -> float:
    """Median device time per run of ``fn`` replayed from a CUDA graph of
    ``batch`` runs, so that the host's launch cost does not count (it
    would, at the small leaves, with launches issued one by one)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        times.append(batch_ms(torch, graph.replay, 1) / batch)
    del graph
    return statistics.median(times)


class Checks:
    """Records every comparison; the run fails at the end if any failed."""

    def __init__(self):
        self.failed = []

    def equal(self, what: str, got, want) -> float:
        err = (got.to(want.dtype) - want).abs().max().item() if got.numel() else 0.0
        ok = got.shape == want.shape and got.dtype == want.dtype and err == 0
        print(f"  [{'ok' if ok else 'MISMATCH'}] {what}: max_abs_err {err}", flush=True)
        if not ok:
            self.failed.append(what)
        return float(err)

    def close(self, what: str, got, want, rtol: float) -> float:
        """|got - want| <= rtol·|want| elementwise; the largest absolute
        error."""
        g, w = got.double(), want.double()
        err = (g - w).abs().max().item() if got.numel() else 0.0
        rel = ((g - w).abs() / w.abs().clamp(min=1e-300)).max().item() if got.numel() else 0.0
        ok = got.shape == want.shape and bool(((g - w).abs() <= rtol * w.abs()).all())
        print(f"  [{'ok' if ok else 'MISMATCH'}] {what}: max_abs_err {err}, "
              f"max_rel_err {rel:.3g} (rtol {rtol})", flush=True)
        if not ok:
            self.failed.append(what)
        return float(err)

    def true(self, what: str, cond: bool) -> None:
        print(f"  [{'ok' if cond else 'FAILED'}] {what}", flush=True)
        if not cond:
            self.failed.append(what)


class Timings:
    """Each kernel variant's numbers: the largest error over every size and
    variant checked, and, at the largest leaf, both versions' times."""

    def __init__(self, torch):
        self.torch = torch
        self.err = {}
        self.rows = []  # one per (kernel, variant) at the largest leaf

    def add(self, name, variant, d, nbytes, err, cuda_fn=None, plain_fn=None,
            plain_reps=3, ms=None, library_ms=None):
        """Every kernel's ``ms`` is the median per launch over batches of
        20 launches (:func:`interleaved_ms`), timed here from ``cuda_fn``
        or, with ``library_ms`` (the one PyTorch call that computes the
        same function, a yardstick only), by the caller in turns with it;
        the plain version's is the median of single runs."""
        self.err[name] = max(self.err.get(name, 0.0), err)
        if plain_fn is None:
            return
        if ms is None:
            ms = interleaved_ms(self.torch, [cuda_fn])[0]
        plain_ms = cuda_ms(self.torch, plain_fn, plain_reps)
        bound_ms, bound_by = bound(name, nbytes, d)
        self.rows.append(dict(name=name, variant=variant, d=d, bytes=nbytes, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms))
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        print(f"  time {name} [{variant}]: {ms:.3f} ms (plain {plain_ms:.3f} ms{lib}, "
              f"bound {bound_ms:.3f} ms by {bound_by}, {nbytes} bytes)", flush=True)

    def main_row(self, name):
        for r in self.rows:
            if r["name"] == name and r["variant"] == MAIN_VARIANT[name]:
                return r
        raise KeyError(name)


def compare(checks, what, got, want, labels):
    """Every output of a kernel against its plain version; the largest
    error."""
    if len(got) != len(want) or len(got) != len(labels):
        checks.true(f"{what}: {len(got)} outputs, plain version {len(want)}", False)
        return float("inf")
    return max(checks.equal(f"{what} {lab}", g, w) for lab, g, w in zip(labels, got, want))


def fused_inputs(torch, gen, device, d, kernel, shift):
    """p, optimizer state, scalar vector and shift at the main path's
    magnitudes."""
    p = torch.randn(d, generator=gen, device=device) * 0.02
    m = torch.randn(d, generator=gen, device=device) * 1e-3
    inv_nalpha = 1.0 / (N_WORKERS * 9000.0)
    if kernel == "sgd":
        state = (m,)
        sc = [inv_nalpha, 0.37, 0.3, 0.9, 1e-4]
    else:
        state = (m, torch.randn(d, generator=gen, device=device).abs() * 1e-5)
        t = 3  # [inv_nalpha, clip, lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2]
        sc = [inv_nalpha, 0.37, 3e-4, 0.9, 1.0 - 0.9, 0.95, 1.0 - 0.95, 1e-8, 1e-4,
              1.0 - 0.9**t, 1.0 - 0.95**t]
    sc = torch.tensor(sc, dtype=torch.float32, device=device)
    h = torch.randn(d, generator=gen, device=device) * 0.01 if shift else None
    return p, state, sc, h


def fused_variants(torch, ops, checks, timings, gen, device, d, big, *, payload,
                   lane_bytes, tag, ops_and_kw):
    """Each fused kernel variant on one summed payload against its plain
    version (and timed at the largest leaf)."""
    for op, kw, shifts in ops_and_kw:
        kernel = op.name.rsplit("_", 1)[1]
        for shift in shifts:
            p, state, sc, h = fused_inputs(torch, gen, device, d, kernel, shift)
            variant = tag + ("+shift" if shift else "")
            cuda = lambda: op.cuda(payload, p, *state, sc, shift=h, **kw)
            plain = lambda: op.plain(payload, p, *state, sc, shift=h, **kw)
            got, want = cuda(), plain()
            labels = ("param'", "mom'") if kernel == "sgd" else ("param'", "mu'", "nu'")
            err = compare(checks, f"{op.name} [{variant}]", got, want,
                          labels + (("shift'",) if shift else ()))
            del got, want
            nbytes = bytes_moved(op.name, d, lane_bytes, shift)
            if big:
                timings.add(op.name, variant, d, nbytes, err, cuda, plain, plain_reps=2)
            else:
                timings.add(op.name, variant, d, nbytes, err)
            del p, state, sc, h


def kernels_phase(torch, ops, checks, device):
    """Each kernel and variant against its plain version; returns the
    timings (the largest leaf) and largest errors."""
    from repro_torch.kernels.int_compress import clip_limit
    from repro_torch.parallel.collectives import psum_wire_words
    from repro_torch.wire import DenseInt

    gen = torch.Generator(device=device).manual_seed(1234)
    timings = Timings(torch)
    for d in (LARGEST_LEAF, RAGGED):
        big = d == LARGEST_LEAF
        print(f"kernels at d = {d}", flush=True)
        # encode: gradient-like values, alpha on the card, both modes
        x = torch.randn(d, generator=gen, device=device) * 3e-3
        alpha = torch.full((), 9000.0, device=device)
        seed = torch.full((), -123456789, dtype=torch.int32, device=device)
        for stochastic in (True, False):
            kw = dict(n_workers=N_WORKERS, bits=8, stochastic=stochastic)
            got = ops.int_compress.cuda(x, alpha, seed, **kw)
            want = ops.int_compress.plain(x, alpha, seed, **kw)
            err = checks.equal(f"int_compress stochastic={stochastic}", got, want)
            del got, want
            variant = "stochastic" if stochastic else "half-even"
            if big and stochastic:
                timings.add("int_compress", variant, d, bytes_moved("int_compress", d, 4), err,
                            lambda: ops.int_compress.cuda(x, alpha, seed, **kw),
                            lambda: ops.int_compress.plain(x, alpha, seed, **kw))
            else:
                timings.add("int_compress", variant, d, 0, err)
        del x

        for bits in (4, 8, 16):
            lim = clip_limit(bits, N_WORKERS)
            images = [
                torch.randint(-lim, lim + 1, (d,), generator=gen, device=device,
                              dtype=torch.int32)
                for _ in range(N_WORKERS)
            ]
            # saturated fields: every worker at +lim in the first and last
            # quarter (fields 0 and k-1; the top field's sum sets bit 31) and
            # at -lim in the second (every field's sum at its floor, 0)
            q = d // 4
            for img in images:
                img[:q] = lim
                img[q:2 * q] = -lim
                img[3 * q:] = lim
            kw = dict(bits=bits, n_workers=N_WORKERS)
            words = []
            for w, img in enumerate(images):
                got = ops.pack_words.cuda(img, **kw)
                want = ops.pack_words.plain(img, **kw)
                err = checks.equal(f"pack_words bits={bits} worker {w}", got, want)
                words.append(got)
                timings.add("pack_words", f"packed{bits}", d, 0, err)
                del want
            tag = f"packed{bits}"
            if big and bits == 8:
                img0 = images[0]
                timings.add("pack_words", tag, d, bytes_moved("pack_words", d, 4 / (32 // bits)),
                            err, lambda: ops.pack_words.cuda(img0, **kw),
                            lambda: ops.pack_words.plain(img0, **kw))
            wsum = psum_wire_words({"w": wds} for wds in words)["w"]
            del words
            ukw = dict(bits=bits, n_summed=N_WORKERS)
            got = ops.unpack_words.cuda(wsum, (d,), **ukw)
            want = ops.unpack_words.plain(wsum, (d,), **ukw)
            err = checks.equal(f"unpack_words bits={bits}", got, want)
            isum = images[0].to(torch.int64)
            for img in images[1:]:
                isum = isum + img.to(torch.int64)
            checks.equal(f"psum law unpack(sum pack) == sum ints, bits={bits}",
                         got.to(torch.int64), isum)
            del images, isum, want, got
            if big and bits == 8:
                timings.add("unpack_words", tag, d, bytes_moved("unpack_words", d, 4 / (32 // bits)),
                            err, lambda: ops.unpack_words.cuda(wsum, (d,), **ukw),
                            lambda: ops.unpack_words.plain(wsum, (d,), **ukw))
            else:
                timings.add("unpack_words", tag, d, 0, err)
            if bits == 8:  # the main path's codec: every packed fused variant
                fused_variants(
                    torch, ops, checks, timings, gen, device, d, big, payload=wsum,
                    lane_bytes=4 / (32 // bits), tag=tag, ops_and_kw=(
                        (ops.fused_unpack_sgd, dict(bits=8, n_summed=N_WORKERS), (False, True)),
                        (ops.fused_unpack_adamw, dict(bits=8, n_summed=N_WORKERS), (False, True)),
                    ),
                )
            del wsum
            torch.cuda.empty_cache()

        # dense lanes: four workers' images summed in the lane type, with
        # sums at the lane's extremes ±n·lim in the first and second quarter
        for bits in (8, 16, 32):
            wf = DenseInt(bits)
            lim = wf.clip_limit(N_WORKERS)
            q = d // 4
            lanes = None
            for _ in range(N_WORKERS):
                img = torch.randint(-lim, lim + 1, (d,), generator=gen, device=device,
                                    dtype=torch.int32)
                img[:q] = lim
                img[q:2 * q] = -lim
                packed = {"w": wf.pack(img, n_workers=N_WORKERS)}
                lanes = psum_wire_words([packed] if lanes is None else [{"w": lanes}, packed])["w"]
                del img, packed
            tag = f"int{bits}"
            checks.true(f"dense {tag} word sum keeps the lane type and reaches ±n·lim",
                        lanes.dtype == wf.lane_dtype
                        and int(lanes[:q].min()) == N_WORKERS * lim
                        and int(lanes[q:2 * q].max()) == -N_WORKERS * lim)
            fused_variants(
                torch, ops, checks, timings, gen, device, d, big, payload=lanes,
                lane_bytes=wf.lane_dtype.itemsize, tag=tag, ops_and_kw=(
                    (ops.fused_apply_sgd, {}, (False, True)),
                    (ops.fused_apply_adamw, {}, (False, True)),
                ),
            )
            del lanes
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return timings


def block_norms_inputs(torch, gen, device, d, dtype):
    """Update-like float32 values, or a summed 4-worker packed8 image."""
    if dtype == torch.float32:
        return torch.randn(d, generator=gen, device=device) * 1e-2
    return torch.randint(-124, 125, (d,), generator=gen, device=device, dtype=torch.int32)


def leaf_sizes() -> list:
    """(elements, leaves of that size) of granite-8b at 4 layers, largest
    first: the three MLP matrices, embed and lm_head, wq and wo, wk and wv,
    ln1 and ln2, ln_f."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import param_shapes

    cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=4)
    counts = collections.Counter(math.prod(s) for s in param_shapes(cfg).values())
    return sorted(counts.items(), reverse=True)


def block_norms_leaf_times(torch, kernel, device) -> dict:
    """``kernel(x, nblocks)`` at every granite-8b leaf size (4 layers),
    float32 and int32, nblocks 1, replayed from a CUDA graph: ms per launch
    and the sum over one compressed IntSGD step, which runs it once per
    leaf on float32 (||dx_l||^2) and once on int32 (||sum ints_l||^2)."""
    gen = torch.Generator(device=device).manual_seed(99)
    rows, step_ms, launches = [], 0.0, 0
    for dtype in (torch.float32, torch.int32):
        for d, leaves in leaf_sizes():
            launches += leaves
            x = block_norms_inputs(torch, gen, device, d, dtype)
            ms = graph_ms(torch, lambda: kernel(x, 1))
            del x
            step_ms += leaves * ms
            rows.append({"dtype": str(dtype).rsplit(".", 1)[1], "d": d, "leaves": leaves,
                         "ms": ms})
            print(f"  block_norms leaf time [{rows[-1]['dtype']}] d={d} x{leaves}: "
                  f"{ms:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    print(f"  block_norms per compressed step ({launches} launches): {step_ms:.4f} ms",
          flush=True)
    return {"leaves": rows, "step_ms": step_ms}


def block_norms_phase(torch, ops, checks, timings, device):
    """block_norms against its plain version and a float64 sum, and against
    itself (launches repeated, interleaved with other sizes, misaligned),
    on float32 and int32 inputs at the main path's magnitudes; timed at the
    largest leaf in turns with torch.dot, and at every leaf size."""
    import torch.nn.functional as F
    from repro_torch.kernels.block_norms import MAX_BLOCKS, chunk_len

    kernel = ops.block_norms.cuda  # a direct call: no launch counted
    gen = torch.Generator(device=device).manual_seed(4321)
    # (elements, nblocks): the largest leaf and a ragged size at 1 and 4
    # blocks; 2500 elements in 4 chunks of 1024 leave the last one empty;
    # the wrapper's most blocks on a ragged size
    cases = [(d, nb) for d in (LARGEST_LEAF, RAGGED) for nb in (1, 4)] + [
        (2500, 4), (1, 1), (RAGGED, MAX_BLOCKS)]
    for dtype in (torch.float32, torch.int32):
        tag = str(dtype).rsplit(".", 1)[1]
        firsts = []  # (x, nblocks, first result) for the interleaved repeats
        for d, nb in cases:
            x = block_norms_inputs(torch, gen, device, d, dtype)
            what = f"block_norms [{tag}] d={d} nblocks={nb}"
            got = kernel(x, nb)
            err = checks.close(f"{what} vs plain", got, ops.block_norms.plain(x, nb), 1e-5)
            per = chunk_len(d, nb)
            f64 = F.pad(x.double(), (0, per * nb - d)).view(nb, per).square().sum(1)
            checks.close(f"{what} vs float64 sum", got, f64, 1e-5)
            del f64
            checks.equal(f"{what} second launch bit-identical", kernel(x, nb), got)
            if d == 2500:
                checks.true(f"{what}: the empty last chunk is 0, the others not",
                            float(got[3]) == 0.0 and bool((got[:3] > 0).all()))
            if d == LARGEST_LEAF and nb == 1:  # 4 B read per element, 4 B written
                fns = [lambda: kernel(x, 1)]
                if dtype == torch.float32:  # the library call, and a read-rate probe
                    fns += [lambda: torch.dot(x, x), lambda: torch.sum(x)]
                times = interleaved_ms(torch, fns)
                bound_ms = bound("block_norms", 4 * d + 4, d)[0]
                line = f"  block_norms [{tag}] in turns: kernel {times[0]:.4f} ms " \
                       f"({100 * bound_ms / times[0]:.1f} % of the {bound_ms:.4f} ms bound)"
                if dtype == torch.float32:
                    line += (f", torch.dot {times[1]:.4f} ms, kernel/dot "
                             f"{times[0] / times[1]:.4f}; torch.sum (read-rate probe) "
                             f"{times[2]:.4f} ms = {4 * d / times[2] / 1e9:.3f} TB/s")
                print(line, flush=True)
                timings.add("block_norms", tag, d, 4 * d + 4, err,
                            plain_fn=lambda: ops.block_norms.plain(x, 1), ms=times[0],
                            library_ms=times[1] if dtype == torch.float32 else None)
                # a misaligned view (four scalar loads a group) reads the same
                # elements in the same order as an aligned copy of them
                x1 = torch.cat([x[:1], x])[1:]
                checks.true(f"{what}: the view x[1:] is not 16-byte aligned",
                            x1.data_ptr() % 16 != 0)
                for vb in (1, 4):
                    checks.equal(f"{what} misaligned view, nblocks={vb}, bit-equal to "
                                 f"an aligned copy", kernel(x1, vb), kernel(x, vb))
                del x1
            else:
                timings.add("block_norms", tag, d, 0, err)
            firsts.append((x, nb, got))
        # launches of every size and nblocks, interleaved and repeated: each
        # bit-identical to its first result, so the ticket counters are
        # back at 0 after every launch
        ok = all(torch.equal(kernel(x, nb), got)
                 for _ in range(3) for x, nb, got in firsts[::-1] + firsts)
        checks.true(f"block_norms [{tag}]: {6 * len(firsts)} interleaved launches of "
                    f"{len(firsts)} (size, nblocks) cases bit-identical to their first", ok)
        del firsts, x, got
        torch.cuda.empty_cache()
    block_norms_leaf_times(torch, kernel, device)


def expected_launches(ops, n_leaves: int, steps: int, opt: str, comp: str, wire: str):
    """Launch counts (all, and with an IntDIANA shift) a path implies: per
    compressed step, encode for every (worker, leaf); pack for every
    (worker, leaf) and unpack for every leaf on a packed wire (none on a
    dense one: pack is the narrowing cast, unpack the widening one); one
    fused update per leaf. block_norms: every step, one per leaf for
    ||Δx_l||²; on IntSGD paths one more per leaf and step for the clip
    factor (||ĝ_l||² on the exact step, ||Σints_l||² after); on IntDIANA
    paths only the exact step's (its shift form is plain PyTorch)."""
    c = steps - 1  # step 0 is exact: no kernel but block_norms
    want = {k.name: 0 for k in ops.KERNELS}
    want_shift = dict(want)
    want["block_norms"] = n_leaves * steps + (
        n_leaves if comp == "intdiana" else n_leaves * steps)
    want["int_compress"] = N_WORKERS * n_leaves * c
    if wire.startswith("packed"):
        want["pack_words"] = N_WORKERS * n_leaves * c
        want["unpack_words"] = n_leaves * c
        fused = f"fused_unpack_{opt}"
    else:
        fused = f"fused_apply_{opt}"
    want[fused] = n_leaves * c
    if comp == "intdiana":
        want_shift[fused] = n_leaves * c
    return want, want_shift


def train_phase(torch, ops, checks, device, *, label, layers, steps, opt, comp, wire, lr):
    """One path through the user entry point, launch counts zeroed just
    before and read just after; returns the counts."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.kernels.int_compress import clip_limit
    from repro_torch.launch.train import train_loop
    from repro_torch.utils.tree import tree_size

    cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=layers)
    shape = ShapeConfig("chip-smoke", 2048, N_WORKERS, "train")
    compressor = {("intsgd", "packed8"): "intsgd8_packed", ("intsgd", "dense8"): "intsgd8"}.get(
        (comp, wire), comp)
    print(f"{label}: {cfg.name} d_model {cfg.d_model} layers {layers} workers {N_WORKERS} "
          f"seq {shape.seq_len} steps {steps}: {opt} / {compressor} / {wire}, lr {lr}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, history = train_loop(
        cfg, shape, n_workers=N_WORKERS, compressor=compressor, wire=wire, steps=steps,
        lr=lr, log_every=1, seed=0, fused=True, clip_norm=1.0, opt=opt, device=device,
    )
    launches, shifts = ops.launch_counts(), ops.shift_launch_counts()
    n_leaves = len(params)
    print(f"{label}: launches {launches}; with shift {shifts}; {n_leaves} leaves, "
          f"{tree_size(params)} parameters; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    del params
    torch.cuda.empty_cache()
    for rec in history:
        print(f"  {label} step {rec['step']}: loss {rec['loss']:.4f} max_int "
              f"{rec['max_int']:.0f} bits {rec['bits']:.0f} ms {rec['ms']:.1f}", flush=True)
    checks.true(f"{label}: losses finite", all(math.isfinite(r["loss"]) for r in history))
    lim_sum = N_WORKERS * clip_limit(8, N_WORKERS)
    checks.true(f"{label}: max_int <= {lim_sum} on every compressed step",
                all(r["max_int"] <= lim_sum for r in history[1:]))
    if comp == "intsgd_block":  # one α per leaf, from that leaf's own ||Δx_l||²
        alpha = history[1]["alpha"]
        for leaf, a in alpha.items():
            print(f"  {label} step 1 alpha[{leaf}] = {a!r}", flush=True)
        vals = list(alpha.values())
        checks.true(f"{label}: step 1 has one α per leaf, finite, positive, not all equal",
                    len(vals) == n_leaves and all(math.isfinite(a) and a > 0 for a in vals)
                    and len(set(vals)) > 1)
    want, want_shift = expected_launches(ops, n_leaves, steps, opt, comp, wire)
    for name in want:
        checks.true(f"{label}: {name} launches {launches[name]} (expected {want[name]}), "
                    f"with shift {shifts[name]} (expected {want_shift[name]})",
                    launches[name] == want[name] and shifts[name] == want_shift[name])
    return launches


def wire_phase(torch, checks, device):
    """Step 1 of the headline path replayed for one leaf: the unpacked word
    sum equals the sum of the four workers' images."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.comm import CommCtx
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.kernels.int_compress import clip_limit
    from repro_torch.launch.step import build_train_step
    from repro_torch.launch.train import OPTIMIZERS
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.optim.base import fused_state_init
    from repro_torch.optim.schedules import constant, warmup_wrap

    cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=4)
    shape = ShapeConfig("chip-smoke", 2048, N_WORKERS, "train")
    leaf = "layers/mlp/w_up"
    lim_sum = N_WORKERS * clip_limit(8, N_WORKERS)
    comp = make_compressor("intsgd8_packed")
    base_opt = OPTIMIZERS["adamw"]()
    sched = warmup_wrap(constant(3e-4), 5)
    art = build_train_step(
        cfg, shape, n_workers=N_WORKERS, compressor=comp, base_opt=base_opt,
        lr_schedule=sched, fused=True, clip_norm=1.0, device=device,
    )
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
    n_leaves = len(params)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    seed_gen = torch.Generator().manual_seed(0)  # train_loop's seed stream
    seeds0 = leaf_seeds(seed_gen, N_WORKERS, n_leaves, device)
    seeds1 = leaf_seeds(seed_gen, N_WORKERS, n_leaves, device)
    p1, _, cs1, _, _ = art.steps["exact"](
        params, fused_state_init(base_opt, params), comp.init(params, N_WORKERS), 0,
        data.batch(0, 0, device=device), seeds0,
    )
    del params
    alpha = comp.alpha_rule.alpha(cs1, sched(1, device), N_WORKERS, art.layout.dims.d)
    b1 = data.batch(1, 0, device=device)
    j = art.layout.names.index(leaf)
    images = []
    for w in range(N_WORKERS):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p1.items()}
        loss = lm_loss(leaves, {k: v[w:w + 1] for k, v in b1.items()}, cfg)
        (g,) = torch.autograd.grad(loss, [leaves[leaf]])
        images.append(comp.wire_format.encode(g, alpha, seeds1[w, j], n_workers=N_WORKERS))
        del leaves, loss, g
    words_sum, int_sum = CommCtx(n_workers=N_WORKERS).psum_wire(
        ({leaf: img} for img in images), comp.wire_format
    )
    isum = sum(img.to(torch.int64) for img in images)
    checks.equal(f"wire: step 1 {leaf}: unpacked word sum == sum of the 4 images",
                 int_sum[leaf].to(torch.int64), isum)
    checks.true(f"wire: step 1 {leaf}: |sum| <= {lim_sum} and some field nonzero",
                int(isum.abs().max()) <= lim_sum and bool(isum.any()))
    del p1, images, words_sum, int_sum, isum
    torch.cuda.empty_cache()


# the paths phases 3-6 drive: (label, layers, steps, optimizer, compressor,
# wire, lr); the headline path first
PATHS = (
    ("train", 4, 4, "adamw", "intsgd", "packed8", 3e-4),
    ("train-sgd", 4, 4, "sgd", "intsgd", "packed8", 0.3),
    ("family sgd/intsgd/dense8", 2, 3, "sgd", "intsgd", "dense8", 0.3),
    ("family adamw/intsgd/dense8", 2, 3, "adamw", "intsgd", "dense8", 3e-4),
    ("family sgd/intdiana/packed8", 2, 3, "sgd", "intdiana", "packed8", 0.3),
    ("family sgd/intdiana/dense8", 2, 3, "sgd", "intdiana", "dense8", 0.3),
    ("family adamw/intdiana/packed8", 2, 3, "adamw", "intdiana", "packed8", 3e-4),
    ("family adamw/intdiana/dense8", 2, 3, "adamw", "intdiana", "dense8", 3e-4),
    ("train-block", 4, 4, "sgd", "intsgd_block", "packed8", 0.3),
)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops

    device = torch.device("cuda", 0)
    checks = Checks()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    build.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f}s -> {build.library_path()}", flush=True)
    build.library()

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    timings = kernels_phase(torch, ops, checks, device)
    print(f"kernels phase: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    block_norms_phase(torch, ops, checks, timings, device)
    print(f"block_norms phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 3-6. the paths through the user entry point, counts read per path
    launches = {k.name: 0 for k in ops.KERNELS}
    for label, layers, steps, opt, comp, wire, lr in PATHS:
        t0 = time.perf_counter()
        counts = train_phase(torch, ops, checks, device, label=label, layers=layers,
                             steps=steps, opt=opt, comp=comp, wire=wire, lr=lr)
        for name, c in counts.items():
            launches[name] += c
        print(f"{label}: {time.perf_counter() - t0:.1f}s", flush=True)

    # 7. step 1 replayed for one leaf: unpack(sum of words) == sum of images
    wire_phase(torch, checks, device)

    # the kernel line, the card line, the result
    kernels = []
    for op in ops.KERNELS:
        row = timings.main_row(op.name)
        kernels.append({
            "name": op.name, "route": "cuda",
            "source": f"src/repro_torch/{op.source}",
            "replaces": REPLACES[op.name], "launches": launches[op.name],
            "max_abs_err": timings.err[op.name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for k in kernels:
        lib = "" if k["library_ms"] is None else f", library {k['library_ms']:.3f} ms"
        # time lost to the bound over the driven paths, were every launch at
        # the largest leaf (an overestimate for kernels run mostly on small
        # leaves): the order in which to redesign the kernels
        excess = k["launches"] * (k["ms"] - k["bound_ms"])
        print(f"kernel {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f} ms{lib}, "
              f"bound {k['bound_ms']:.3f} ms by {k['bound_by']}), "
              f"{k['launches']} launches over the driven paths, "
              f"launches x (ms - bound) = {excess:.1f} ms", flush=True)
    if checks.failed:
        fail("; ".join(checks.failed))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
