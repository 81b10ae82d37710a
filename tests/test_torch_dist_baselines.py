"""The paper's baselines and the sparse wire on real processes: a gloo
process group of 4 ranks (``repro_torch.parallel.spawn``, one spawn for
everything) against the local n-worker backend.

For ``heuristic_intsgd`` (packed8), ``qsgd``, ``topk``, ``powersgd`` and
``intsgd`` on ``topk8:64``:

1. ``aggregate`` over three rounds on fixed gradients (each rank its own
   worker's): ĝ bit-identical on every rank and bit-equal to the local
   backend's, and so is each rank's row of the per-worker state (the
   error feedback, the residual) — the float means are summed in worker
   order on the group too (``pmean(ordered=True)``), the gathers and the
   profiling max are order-free;
2. three train steps of granite-8b (smoke widths, 1 layer, seq 32, global
   batch 4) on the ZeRO-1 route: losses and every rank's params after
   every step bit-equal to the local backend's (the tolerance stated is
   0: nothing on these routes sums floats in another order on a group).

The ranks and the local reference run one intra-op thread each.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import leaf_seeds, make_compressor  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMData  # noqa: E402
from repro_torch.launch.step import build_init_state, build_train_step  # noqa: E402
from repro_torch.launch.train import OPTIMIZERS  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402
from repro_torch.optim.schedules import constant, warmup_wrap  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402

N, SEQ, BATCH, STEPS, ROUNDS = 4, 32, 4, 3, 3
COMPRESSORS = {
    # name: make_compressor arguments
    "heuristic_intsgd": dict(wire="packed8"),
    "qsgd": {},
    "topk": dict(k_frac=0.05),
    "powersgd": dict(min_compress_size=256),
    "intsgd-topk8": dict(bits=8, wire="topk8:64"),
}
SHAPES = {"b": (10,), "s": (2, 24, 40), "w": (64, 50)}


def _comp(name):
    return make_compressor(name.split("-")[0], **COMPRESSORS[name])


def _worker_grads(rnd):
    rng = np.random.default_rng(100 + rnd)
    return [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
             for k, s in SHAPES.items()} for _ in range(N)]


def _aggregate(group, name):
    """ROUNDS rounds of ``aggregate``: per round ĝ, and at the end the
    per-worker state (the rank's row on a group)."""
    comp = _comp(name)
    ctx = CommCtx(n_workers=N) if group is None else CommCtx.on_group(group)
    state = comp.init({k: torch.zeros(s) for k, s in SHAPES.items()}, ctx.n_local)
    if name.startswith("intsgd"):
        from repro_torch.core.scaling import AlphaState

        state["alpha"] = AlphaState(r=torch.tensor(1e-2), step=torch.tensor(1, dtype=torch.int32))
    gen = torch.Generator().manual_seed(7)
    out = []
    for rnd in range(ROUNDS):
        seeds = leaf_seeds(gen, N, len(SHAPES), "cpu")
        grads = _worker_grads(rnd)
        mine = [grads[w] for w in ctx.local_workers()]
        ghat, state, _ = comp.aggregate(state, iter(mine), seeds=seeds, eta=torch.tensor(0.1),
                                        ctx=ctx)
        out.append(ghat)
    if isinstance(state, dict) and "ef" in state:
        per_worker = state["ef"]
    elif isinstance(state, dict) and "err" in state:
        per_worker = state["err"]
    else:
        per_worker = state or {}
    return out, {k: v.clone() for k, v in per_worker.items()}


def _train(group, name):
    """STEPS ZeRO-1 SGD steps of a 1-layer smoke granite-8b: per step the
    loss and the params."""
    cfg = dataclasses.replace(smoke_config(get_arch("granite-8b")), n_layers=1)
    shape = ShapeConfig("dist", SEQ, BATCH, "train")
    comp, base_opt = _comp(name), OPTIMIZERS["sgd"]()
    art = build_train_step(
        cfg, shape, n_workers=N, compressor=comp, base_opt=base_opt,
        lr_schedule=warmup_wrap(constant(0.3), 5), clip_norm=1.0,
        param_dtype=torch.float32, device="cpu", group=group)
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    opt_state, comp_state = build_init_state(params, n_workers=N, compressor=comp,
                                             base_opt=base_opt, group=group)
    seed_gen = torch.Generator().manual_seed(3)
    data = SyntheticLMData(cfg.vocab, SEQ, BATCH, seed=3)
    out = []
    for i in range(STEPS):
        seeds = leaf_seeds(seed_gen, N, len(art.layout.names), "cpu")
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        params, opt_state, comp_state, loss, _ = fn(
            params, opt_state, comp_state, i, data.batch(i, 0, device="cpu"), seeds)
        out.append((loss, dict(params)))
    return out


def _everything(group, rank=0):
    return {name: (_aggregate(group, name), _train(group, name)) for name in COMPRESSORS}


@pytest.fixture(scope="module")
def runs():
    ranks = run_ranks(_everything, N)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        local = _everything(None)
    finally:
        torch.set_num_threads(threads)
    return ranks, local


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_ghat_bit_identical_across_ranks_and_to_the_local_backend(runs, name):
    ranks, local = runs
    (want_ghats, want_state), _ = local[name]
    assert any(bool(v.any()) for v in want_ghats[-1].values())
    for rank, r in enumerate(ranks):
        (ghats, state), _ = r[name]
        for rnd, (g, w) in enumerate(zip(ghats, want_ghats)):
            assert _equal(g, w), f"{name}: rank {rank} round {rnd}"
        assert _equal(state, {k: v[rank:rank + 1] for k, v in want_state.items()}), name


@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_train_steps_match_the_local_backend(runs, name):
    ranks, local = runs
    want = local[name][1]
    for rank, r in enumerate(ranks):
        for step, ((loss, params), (wloss, wparams)) in enumerate(zip(r[name][1], want)):
            assert torch.equal(loss, wloss), f"{name}: rank {rank} step {step}"
            assert _equal(params, wparams), f"{name}: rank {rank} step {step}"
