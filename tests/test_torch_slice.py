"""Port vs JAX: the whole slice — four train steps of granite-8b (smoke
config) on the fused packed8 IntSGD route with SGD, n = 1.

Reference: the JAX package's ``build_train_step`` on the single CPU device
(``fused=True``, ``clip_norm=1.0``, ``sgd(0.9, 1e-4)``, the train loop's
warmup schedule), with ``use_kernels=True`` so its encode uses the counter
PRNG. The port's ``build_train_step`` gets the same weights, batches and
encode seeds (derived from the JAX step keys exactly as the JAX step derives
them). Losses agree within rtol=2e-2 — the bf16 forward rounds differently
in XLA and PyTorch, and a flipped rounding boundary moves a few integers —
and max_int within ±1.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ShapeConfig as JShape, get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.core.compressor import IntSGD as JIntSGD, _leaf_keys  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.launch.step import build_init_state, build_train_step as jbuild  # noqa: E402
from repro.models.transformer import init_lm_params  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim.schedules import constant as jconstant, warmup_wrap as jwarmup  # noqa: E402
from repro.parallel.collectives import mesh_from_counts  # noqa: E402
from repro.wire import PackedInt as JPackedInt  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.launch.step import build_train_step  # noqa: E402
from repro_torch.models.transformer import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.optim.base import fused_state_init  # noqa: E402
from repro_torch.optim.schedules import constant, warmup_wrap  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

STEPS, SEQ, BATCH = 4, 32, 4


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (BATCH, SEQ))
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        out.append((toks, labels))
    return out


def _jax_run(batches):
    cfg = jsmoke(jget_arch("granite-8b"))
    mesh = mesh_from_counts(data=1, model=1)
    comp = JIntSGD(bits=8, wire=JPackedInt(8, use_kernels=True), use_kernels=True)
    opt = jsgd(momentum=0.9, weight_decay=1e-4)
    art = jbuild(
        cfg, mesh, JShape("slice", SEQ, BATCH, "train"), compressor=comp,
        base_opt=opt, lr_schedule=jwarmup(jconstant(0.3), 5),
        param_dtype=jnp.float32, fused=True, clip_norm=1.0,
    )
    key = jax.random.PRNGKey(0)
    params = init_lm_params(key, cfg, tp=1, n_shards=1, dtype=jnp.float32)
    params0 = jax.tree.map(np.asarray, params)
    opt_state, comp_state = build_init_state(cfg, mesh, compressor=comp, base_opt=opt, fused=True)(params)
    opt0 = jax.tree.map(np.asarray, opt_state)
    losses, max_ints, seeds = [], [], []
    for i, (toks, labels) in enumerate(batches):
        k = jax.random.fold_in(key, i)
        # the compressed step's encode keys: fold_in(k, 1), then the worker
        # index (0), then one split per leaf in tree order
        wkey = jax.random.fold_in(jax.random.fold_in(k, 1), 0)
        seeds.append([int(kops.seed_from_key(s))
                      for s in jax.tree.leaves(_leaf_keys(wkey, params0))])
        fn = art.jitted["exact"] if i == 0 else art.jitted["compressed"]
        batch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, jnp.int32(i), k, batch
        )
        losses.append(float(loss))
        max_ints.append(float(metrics[0]))
    return params0, opt0, losses, max_ints, seeds


def test_slice_matches_jax_four_steps():
    batches = _batches()
    params0, opt0, jlosses, jmax, jseeds = _jax_run(batches)

    cfg = smoke_config(get_arch("granite-8b"))
    comp = make_compressor("intsgd8_packed")
    opt = sgd(momentum=0.9, weight_decay=1e-4)
    art = build_train_step(
        cfg, ShapeConfig("slice", SEQ, BATCH, "train"), n_workers=1,
        compressor=comp, base_opt=opt, lr_schedule=warmup_wrap(constant(0.3), 5),
        fused=True, clip_norm=1.0, device="cpu",
    )
    params = params_from_jax(params0, "cpu")
    opt_state, comp_state = opt_state_from_jax(opt0, "cpu"), comp.init(params)
    zeros = fused_state_init(opt, params)
    assert all(torch.equal(opt_state["mom"][k], zeros["mom"][k]) for k in params)
    losses, max_ints = [], []
    for i, (toks, labels) in enumerate(batches):
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
        seeds = torch.tensor([jseeds[i]], dtype=torch.int32)
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, batch, seeds
        )
        losses.append(loss.item())
        max_ints.append(metrics[0].item())

    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    assert all(abs(a - b) <= 1 for a, b in zip(max_ints, jmax)), (max_ints, jmax)
    assert max_ints[0] == 0 and all(0 < v <= 127 for v in max_ints[1:])
    assert all(np.isfinite(v.numpy()).all() for v in params.values())
