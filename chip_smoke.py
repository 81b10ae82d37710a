#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            (from the repository root)

Phases, each of which must pass for the exit code to be 0:

  1. build  — compile the four hand-written kernels (src/repro_torch/csrc)
              with nvcc for sm_90a, one nvcc per source, in parallel;
  2. kernels — hold each kernel against its plain PyTorch version on the
              card, at the slice's largest leaf (234,881,024 elements) and
              at a ragged size: integer kernels bit-equal, the fused update
              bit-equal too (built with --fmad=false; tolerance 0). Checks
              the wrap-around psum law with saturated fields, and times each
              kernel and its plain version with CUDA events;
  3. train  — the port's main path through its user entry point
              (launch.train.train_loop): granite-8b at full width, depth cut
              to 4 layers, 4 data-parallel workers simulated on the card,
              per-worker batch 1, seq 2048, packed8 wire, fused SGD, clip
              1.0, 4 steps (step 0 exact). Launch counts are zeroed just
              before and read just after; every kernel must have run;
  4. wire   — step 1 replayed for one leaf: the unpacked word sum equals
              the sum of the four workers' images.

Prints one JSON line of per-kernel numbers, then the card's name and power
limit (nvidia-smi), then {"ok": true, "device": {...}} as the last line.
Exits nonzero, printing no result, without a CUDA device or outside the
repository.
"""
from __future__ import annotations

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
}
# float/integer operations per image element, counted from each kernel's
# arithmetic (for the compute side of the bound)
OPS_PER_ELEMENT = {
    "int_compress": 20, "pack_words": 3, "unpack_words": 3, "fused_unpack_sgd": 8,
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bytes_moved(name: str, d: int, bits: int) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    m = -(-d // (32 // bits))
    return {
        "int_compress": 8 * d,
        "pack_words": 4 * d + 4 * m,
        "unpack_words": 4 * m + 4 * d,
        "fused_unpack_sgd": 4 * m + 16 * d,
    }[name]


def bound(name: str, d: int, bits: int):
    t_bytes = bytes_moved(name, d, bits) / HBM_BYTES_PER_S * 1e3
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

    def true(self, what: str, cond: bool) -> None:
        print(f"  [{'ok' if cond else 'FAILED'}] {what}", flush=True)
        if not cond:
            self.failed.append(what)


def kernels_phase(torch, ops, checks: Checks, device):
    """Each kernel against its plain version; returns per-kernel numbers at
    the largest leaf (the main path's codec: packed8, 4 workers)."""
    from repro_torch.kernels.int_compress import clip_limit
    from repro_torch.parallel.collectives import psum_wire_words

    gen = torch.Generator(device=device).manual_seed(1234)
    numbers = {}
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
            if big and stochastic:
                numbers["int_compress"] = dict(
                    max_abs_err=err, d=d, bits=8,
                    ms=cuda_ms(torch, lambda: ops.int_compress.cuda(x, alpha, seed, **kw), 20),
                    plain_ms=cuda_ms(torch, lambda: ops.int_compress.plain(x, alpha, seed, **kw), 3),
                )
            del got, want
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
                del want
            if big and bits == 8:
                img0 = images[0]
                numbers["pack_words"] = dict(
                    max_abs_err=err, d=d, bits=bits,
                    ms=cuda_ms(torch, lambda: ops.pack_words.cuda(img0, **kw), 20),
                    plain_ms=cuda_ms(torch, lambda: ops.pack_words.plain(img0, **kw), 3),
                )
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
                numbers["unpack_words"] = dict(
                    max_abs_err=err, d=d, bits=bits,
                    ms=cuda_ms(torch, lambda: ops.unpack_words.cuda(wsum, (d,), **ukw), 20),
                    plain_ms=cuda_ms(torch, lambda: ops.unpack_words.plain(wsum, (d,), **ukw), 3),
                )
            if bits == 8:
                p = torch.randn(d, generator=gen, device=device) * 0.02
                m = torch.randn(d, generator=gen, device=device) * 1e-3
                # [inv_nalpha, clip, lr, mu, wd] at the main path's magnitudes
                sc = torch.tensor([1.0 / (4 * 9000.0), 0.37, 0.3, 0.9, 1e-4],
                                  dtype=torch.float32, device=device)
                fkw = dict(bits=8, n_summed=N_WORKERS)
                gp, gm = ops.fused_unpack_sgd.cuda(wsum, p, m, sc, **fkw)
                wp, wm = ops.fused_unpack_sgd.plain(wsum, p, m, sc, **fkw)
                err = max(checks.equal("fused_unpack_sgd param'", gp, wp),
                          checks.equal("fused_unpack_sgd mom'", gm, wm))
                del gp, gm, wp, wm
                if big:
                    numbers["fused_unpack_sgd"] = dict(
                        max_abs_err=err, d=d, bits=8,
                        ms=cuda_ms(torch, lambda: ops.fused_unpack_sgd.cuda(wsum, p, m, sc, **fkw), 20),
                        plain_ms=cuda_ms(torch, lambda: ops.fused_unpack_sgd.plain(wsum, p, m, sc, **fkw), 3),
                    )
                del p, m
            del wsum
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return numbers


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.comm import CommCtx
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.kernels import build, ops
    from repro_torch.launch.step import build_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.optim.base import fused_state_init
    from repro_torch.optim.schedules import constant, warmup_wrap
    from repro_torch.optim.sgd import sgd
    from repro_torch.utils.tree import tree_size

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
    numbers = kernels_phase(torch, ops, checks, device)

    # 3. the main path through the user entry point
    cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=4)
    shape = ShapeConfig("chip-smoke", 2048, N_WORKERS, "train")
    steps = 4
    print(f"train: {cfg.name} d_model {cfg.d_model} layers {cfg.n_layers} "
          f"workers {N_WORKERS} seq {shape.seq_len} steps {steps}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, history = train_loop(
        cfg, shape, n_workers=N_WORKERS, compressor="intsgd8_packed",
        wire="packed8", steps=steps, lr=0.3, log_every=1, seed=0, fused=True,
        clip_norm=1.0, opt="sgd", device=device,
    )
    launches = ops.launch_counts()
    print(f"train: launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    n_leaves = len(params)
    print(f"train: {n_leaves} leaves, {tree_size(params)} parameters", flush=True)
    del params
    torch.cuda.empty_cache()
    for rec in history:
        print(f"  step {rec['step']}: loss {rec['loss']:.4f} max_int "
              f"{rec['max_int']:.0f} bits {rec['bits']:.0f} ms {rec['ms']:.1f}", flush=True)
    checks.true("losses finite", all(math.isfinite(r["loss"]) for r in history))
    lim_sum = N_WORKERS * 31
    checks.true(f"max_int <= {lim_sum} on every compressed step",
                all(r["max_int"] <= lim_sum for r in history[1:]))
    per_step = {
        "int_compress": N_WORKERS * n_leaves, "pack_words": N_WORKERS * n_leaves,
        "unpack_words": n_leaves, "fused_unpack_sgd": n_leaves,
    }
    for name, count in launches.items():
        want = per_step[name] * (steps - 1)
        checks.true(f"{name} launched on the main path ({count}, expected {want})",
                    count > 0 and count == want)

    # 4. step 1 replayed for one leaf: unpack(sum of words) == sum of images
    leaf = "layers/mlp/w_up"
    comp = make_compressor("intsgd8_packed")
    base_opt = sgd(momentum=0.9, weight_decay=1e-4)
    sched = warmup_wrap(constant(0.3), 5)
    art = build_train_step(
        cfg, shape, n_workers=N_WORKERS, compressor=comp, base_opt=base_opt,
        lr_schedule=sched, fused=True, clip_norm=1.0, device=device,
    )
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    seed_gen = torch.Generator().manual_seed(0)  # train_loop's seed stream
    seeds0 = leaf_seeds(seed_gen, N_WORKERS, n_leaves, device)
    seeds1 = leaf_seeds(seed_gen, N_WORKERS, n_leaves, device)
    p1, _, cs1, _, _ = art.steps["exact"](
        params, fused_state_init(base_opt, params), comp.init(params), 0,
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
    checks.equal(f"step 1 {leaf}: unpacked word sum == sum of the 4 images",
                 int_sum[leaf].to(torch.int64), isum)
    checks.true(f"step 1 {leaf}: |sum| <= {lim_sum} and some field nonzero",
                int(isum.abs().max()) <= lim_sum and bool(isum.any()))
    del p1, images, words_sum, int_sum, isum

    # the kernel line, the card line, the result
    kernels = []
    for op in ops.KERNELS:
        nb = numbers[op.name]
        bound_ms, bound_by = bound(op.name, nb["d"], nb["bits"])
        kernels.append({
            "name": op.name, "route": "cuda",
            "source": f"src/repro_torch/{op.source}",
            "replaces": REPLACES[op.name], "launches": launches[op.name],
            "max_abs_err": nb["max_abs_err"], "ms": nb["ms"],
            "plain_ms": nb["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f} ms, "
              f"bound {k['bound_ms']:.3f} ms by {k['bound_by']}), "
              f"{k['launches']} launches on the main path", flush=True)
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
