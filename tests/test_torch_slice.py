"""Port vs JAX: the whole slice — four train steps of granite-8b (smoke
config) on the fused route at n = 1: the packed8 IntSGD route with SGD
(``test_slice_matches_jax_four_steps``), and the family corners (AdamW,
IntSGD, packed8), (SGD, IntSGD, dense8) and (AdamW, IntDIANA, dense8)
(``test_slice_family_matches_jax_four_steps``), and IntSGD's other α and
rounding rules: blockwise α (Alg. 2) on packed8 and round-half-to-even on
dense8, both with SGD (``test_slice_alpha_rules_match_jax_four_steps``); and
with bf16 params (the JAX step's default ``param_dtype``), which the fused
kernels read and write themselves, on (SGD, IntSGD, packed8) and (AdamW,
IntDIANA, dense8) (``test_slice_bf16_params_match_jax_four_steps``).

Reference: the JAX package's ``build_train_step`` on the single CPU device
(``fused=True``, ``clip_norm=1.0``, ``sgd(0.9, 1e-4)`` or
``adamw(weight_decay=1e-4)``, the train loop's warmup schedule), with
``use_kernels=True`` so its encode uses the counter PRNG. The port's
``build_train_step`` gets the same weights, optimizer and compressor state
(carried over with ``opt_state_from_jax`` / ``comp_state_from_jax``),
batches and encode seeds (derived from the JAX step keys exactly as the JAX
step derives them). Losses agree within rtol=2e-2 — the bf16 forward
rounds differently in XLA and PyTorch, and a flipped rounding boundary
moves a few integers — and max_int within ±1. At n = 1 the one worker's
payload is the sum, so the port's max_local_int equals its max_int and
JAX's max_int within ±1 too.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ShapeConfig as JShape, get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.core.compressor import IntDIANA as JIntDIANA, IntSGD as JIntSGD, _leaf_keys  # noqa: E402
from repro.core.scaling import AlphaBlockwise as JAlphaBlockwise  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.launch.step import build_init_state, build_train_step as jbuild  # noqa: E402
from repro.models.transformer import init_lm_params  # noqa: E402
from repro.optim import adamw as jadamw, sgd as jsgd  # noqa: E402
from repro.optim.schedules import constant as jconstant, warmup_wrap as jwarmup  # noqa: E402
from repro.parallel.collectives import mesh_from_counts  # noqa: E402
from repro.wire import DenseInt as JDenseInt, PackedInt as JPackedInt  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.launch.step import build_train_step  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    comp_state_from_jax, opt_state_from_jax, params_from_jax,
)
from repro_torch.optim.base import fused_state_init  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
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


# (optimizer, compressor, wire) -> (JAX optimizer, JAX compressor, port
# optimizer, port compressor, lr)
def _corner(opt, comp, wire):
    jwire = {"packed8": JPackedInt, "dense8": JDenseInt}[wire](8, use_kernels=True)
    if comp == "intsgd":
        jcomp = JIntSGD(bits=8, wire=jwire, use_kernels=True)
    elif comp == "intsgd_block":
        jcomp = JIntSGD(bits=8, wire=jwire, use_kernels=True, alpha_rule=JAlphaBlockwise())
    elif comp == "intsgd_determ":
        jcomp = JIntSGD(bits=8, wire=jwire, use_kernels=True, stochastic=False)
    else:
        jcomp = JIntDIANA(bits=8, wire=jwire)
    if opt == "sgd":
        jo, to, lr = jsgd(momentum=0.9, weight_decay=1e-4), sgd(momentum=0.9, weight_decay=1e-4), 0.3
    else:
        jo, to, lr = jadamw(weight_decay=1e-4), adamw(weight_decay=1e-4), 3e-4
    name = {("intsgd", "packed8"): "intsgd8_packed", ("intsgd", "dense8"): "intsgd8"}.get(
        (comp, wire), comp)
    width_free = comp in ("intdiana", "intsgd_block", "intsgd_determ")
    tcomp = make_compressor(name, **({"bits": 8, "wire": wire} if width_free else {}))
    return jo, jcomp, to, tcomp, lr


def _jax_run(batches, jo, jcomp, lr, jdt=jnp.float32):
    cfg = jsmoke(jget_arch("granite-8b"))
    mesh = mesh_from_counts(data=1, model=1)
    art = jbuild(
        cfg, mesh, JShape("slice", SEQ, BATCH, "train"), compressor=jcomp,
        base_opt=jo, lr_schedule=jwarmup(jconstant(lr), 5),
        param_dtype=jdt, fused=True, clip_norm=1.0,
    )
    key = jax.random.PRNGKey(0)
    params = init_lm_params(key, cfg, tp=1, n_shards=1, dtype=jdt)
    params0 = jax.tree.map(np.asarray, params)
    opt_state, comp_state = build_init_state(cfg, mesh, compressor=jcomp, base_opt=jo, fused=True)(params)
    opt0 = jax.tree.map(np.asarray, opt_state)
    comp0 = jax.tree.map(np.asarray, comp_state)
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
    return params0, opt0, comp0, losses, max_ints, seeds


def _check_corner(opt, comp, wire, param_dtype="float32"):
    batches = _batches()
    jo, jcomp, to, tcomp, lr = _corner(opt, comp, wire)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    params0, opt0, comp0, jlosses, jmax, jseeds = _jax_run(batches, jo, jcomp, lr, jdt)

    cfg = smoke_config(get_arch("granite-8b"))
    art = build_train_step(
        cfg, ShapeConfig("slice", SEQ, BATCH, "train"), n_workers=1,
        compressor=tcomp, base_opt=to, lr_schedule=warmup_wrap(constant(lr), 5),
        param_dtype=tdt, fused=True, clip_norm=1.0, device="cpu",
    )
    params = params_from_jax(params0, "cpu")
    assert all(p.dtype == tdt for p in params.values())
    opt_state = opt_state_from_jax(opt0, "cpu")
    zeros = fused_state_init(to, params)
    assert set(opt_state) == set(zeros)
    for name, z in zeros.items():
        if isinstance(z, dict):
            assert all(torch.equal(opt_state[name][k], z[k]) for k in params)
        else:
            assert opt_state[name].dtype == z.dtype and torch.equal(opt_state[name], z)
    comp_state = comp_state_from_jax(comp0, "cpu")
    zeros = tcomp.init(params, 1)
    if comp == "intdiana":
        for name in ("h_local", "h_global"):
            assert all(torch.equal(comp_state[name][k], zeros[name][k]) for k in params)
        alpha0, zero_alpha = comp_state["alpha"], zeros["alpha"]
    else:
        alpha0, zero_alpha = comp_state, zeros
    if isinstance(zero_alpha.r, dict):  # blockwise α: one r per leaf
        assert set(alpha0.r) == set(params)
        assert all(torch.equal(alpha0.r[k], zero_alpha.r[k]) for k in params)
    else:
        assert torch.equal(alpha0.r, zero_alpha.r)
    assert torch.equal(alpha0.step, zero_alpha.step)
    losses, max_ints, max_local, alphas = [], [], [], []
    for i, (toks, labels) in enumerate(batches):
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
        seeds = torch.tensor([jseeds[i]], dtype=torch.int32)
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, batch, seeds
        )
        losses.append(loss.item())
        max_ints.append(metrics[0].item())
        alphas.append({k: float(a) for k, a in metrics[2].items()})
        max_local.append(metrics[3].item())

    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    assert all(abs(a - b) <= 1 for a, b in zip(max_ints, jmax)), (max_ints, jmax)
    assert max_local == max_ints, (max_local, max_ints)
    assert max_ints[0] == 0 and all(0 < v <= 127 for v in max_ints[1:])
    assert all(p.dtype == tdt and torch.isfinite(p).all() for p in params.values())
    if opt == "adamw":
        assert int(opt_state["count"]) == STEPS
    if comp == "intdiana":  # the shift moved off zero
        assert any(bool(v.any()) for v in comp_state["h_global"].values())
    assert alphas[0] == {} and all(set(a) == set(params) for a in alphas[1:])
    for a in alphas[1:]:
        assert all(np.isfinite(v) and v > 0 for v in a.values())
        # blockwise α differs from leaf to leaf; a global α is one number
        assert (len(set(a.values())) > 1) == (comp == "intsgd_block")


def test_slice_matches_jax_four_steps():
    _check_corner("sgd", "intsgd", "packed8")


@pytest.mark.parametrize("opt,comp,wire", [
    ("adamw", "intsgd", "packed8"),
    ("sgd", "intsgd", "dense8"),
    ("adamw", "intdiana", "dense8"),
])
def test_slice_family_matches_jax_four_steps(opt, comp, wire):
    _check_corner(opt, comp, wire)


@pytest.mark.parametrize("opt,comp,wire", [
    ("sgd", "intsgd_block", "packed8"),
    ("sgd", "intsgd_determ", "dense8"),
])
def test_slice_alpha_rules_match_jax_four_steps(opt, comp, wire):
    _check_corner(opt, comp, wire)


@pytest.mark.parametrize("opt,comp,wire", [
    ("sgd", "intsgd", "packed8"),
    ("adamw", "intdiana", "dense8"),
])
def test_slice_bf16_params_match_jax_four_steps(opt, comp, wire):
    _check_corner(opt, comp, wire, param_dtype="bfloat16")


def test_build_train_step_defaults_to_bf16_params_like_jax():
    import inspect

    want = inspect.signature(jbuild).parameters["param_dtype"].default
    got = inspect.signature(build_train_step).parameters["param_dtype"].default
    assert want == jnp.bfloat16 and got == torch.bfloat16
