"""Port vs JAX: the hybrid family, zamba2-2.7b (Mamba2 SSD layers and one
shared attention block applied after every ``attn_every`` of them).

The config equals the JAX package's field for field, at its published size
and at its smoke size (4 layers, attn_every 2: two blocks). Its 23 leaves
come in ``jax.tree.flatten``'s order with JAX's shapes — the Mamba2 leaves
with two leading axes ``(n_layers // attn_every, attn_every, ...)``, the
``shared_attn/*`` leaves once — at 9, 18 and 54 layers, and a depth that is
not a multiple of ``attn_every`` is refused by name. The constant
initialisers are JAX's. The smoke model's loss and every gradient leaf
match JAX's ``lm_loss`` in float32 (rtol 1e-4, atol 1e-5) at T = 32 (one
SSD chunk) and T = 512 (two chunks of 256, so the state carries); the
shared block's gradient is the sum of its two applications.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ShapeConfig as JShape, get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.launch.inputs import input_specs as jinput_specs  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro.models.transformer import init_lm_params, lm_loss as jlm_loss  # noqa: E402
import repro_torch.models.transformer as transformer  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.launch.inputs import input_specs  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_lm_params as tinit, lm_loss, param_shapes, params_from_jax,
)
from repro_torch.utils.tree import leaf_names  # noqa: E402

NAME = "zamba2-2.7b"
# parameters at full width, from shapes: layers -> total (the chip paths
# run 18 and, card against CPU, 9)
FULL_WIDTH = {9: 640_757_360, 18: 999_699_680, 54: 2_435_468_960}
SHARED_BLOCK = 117_972_480
TOL = dict(rtol=1e-4, atol=1e-5)


def _paths(tree):
    return ["/".join(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs(layers=None):
    if layers is None:
        return smoke_config(get_arch(NAME)), jsmoke(jget_arch(NAME))
    return (dataclasses.replace(get_arch(NAME), n_layers=layers),
            dataclasses.replace(jget_arch(NAME), n_layers=layers))


@pytest.mark.parametrize("layers", [None, 9, 18, 54])
def test_config_and_leaf_order_match_jax(layers):
    assert dataclasses.asdict(get_arch(NAME)) == dataclasses.asdict(jget_arch(NAME))
    cfg, jcfg = _cfgs(layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if layers is None:
        assert (cfg.n_layers, cfg.attn_every, cfg.d_model, cfg.ssm_state, cfg.head_dim) == (
            4, 2, 64, 16, 16)
    params = jax.eval_shape(lambda k: init_lm_params(k, jcfg), jax.random.PRNGKey(0))
    shapes = param_shapes(cfg)
    assert len(shapes) == 23 and leaf_names(shapes) == _paths(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert shapes["/".join(p.key for p in path)] == leaf.shape
    nb = cfg.n_layers // cfg.attn_every
    assert shapes["layers/m/w_xz"][:2] == (nb, cfg.attn_every)
    assert shapes["shared_attn/w_in"] == (2 * cfg.d_model, cfg.d_model)


@pytest.mark.parametrize("layers", sorted(FULL_WIDTH))
def test_full_width_parameter_counts(layers):
    cfg, _ = _cfgs(layers)
    sizes = {k: math.prod(s) for k, s in param_shapes(cfg).items()}
    assert sum(sizes.values()) == FULL_WIDTH[layers]
    assert sum(v for k, v in sizes.items() if k.startswith("shared_attn/")) == SHARED_BLOCK
    # the hybrid's largest leaf: 2,560 x 10,240 per layer
    assert sizes["layers/m/w_xz"] == layers * 26_214_400
    if layers == 18:
        assert max(sizes.values()) == sizes["layers/m/w_xz"] == 471_859_200
    # the tiny per-head leaves: 80 entries a layer
    assert sizes["layers/m/a_log"] == sizes["layers/m/dt_bias"] == layers * 80


@pytest.mark.parametrize("layers", [2, 10, 0])
def test_depth_not_a_multiple_of_attn_every_is_refused(layers):
    cfg, _ = _cfgs(layers)
    with pytest.raises(ValueError, match="attn_every 9"):
        param_shapes(cfg)
    with pytest.raises(ValueError, match="attn_every"):
        tinit(cfg, generator=torch.Generator().manual_seed(0), device="meta")


def test_constant_initialisers_and_fan_ins():
    cfg, jcfg = _cfgs()
    params = tinit(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    want = _flat(init_lm_params(jax.random.PRNGKey(0), jcfg))
    consts = {"layers/ln": 1.0, "shared_attn/ln": 1.0, "shared_attn/ln2": 1.0, "ln_f": 1.0,
              "layers/m/norm_w": 1.0, "layers/m/d_skip": 1.0, "layers/m/a_log": 0.0,
              "layers/m/dt_bias": -4.0}
    for k, v in consts.items():
        assert torch.equal(params[k], torch.full(params[k].shape, v)), k
        np.testing.assert_array_equal(params[k].numpy(), want[k], err_msg=k)
    # uniform ±1/√fan_in, fan_in the next-to-last axis: conv_w's 4 taps,
    # w_in's 2·d_model
    fans = {"layers/m/conv_w": 4, "shared_attn/w_in": 2 * cfg.d_model,
            "layers/m/w_out": 2 * cfg.d_model, "layers/m/w_xz": cfg.d_model,
            "shared_attn/mlp/w_down": cfg.d_ff, "embed": cfg.d_model}
    for k, fan in fans.items():
        bound = 1 / math.sqrt(fan)
        assert params[k].abs().max() <= bound and params[k].abs().max() > 0.9 * bound, k
        assert float(np.abs(want[k]).max()) <= bound, k
    assert {str(v.dtype) for v in params.values()} == {"torch.float32"}
    bf = tinit(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
               dtype=torch.bfloat16)
    assert {str(v.dtype) for v in bf.values()} == {"torch.bfloat16"}  # no float32-only leaf
    assert torch.equal(bf["layers/m/dt_bias"].float(), params["layers/m/dt_bias"])


def test_input_specs_are_tokens_only():
    cfg = get_arch(NAME)
    got = input_specs(cfg, ShapeConfig("t", 2048, 4, "train"))
    want = jinput_specs(jget_arch(NAME), JShape("t", 2048, 4, "train"))
    assert set(got) == set(want) == {"tokens", "labels"}
    assert all(got[k][0] == want[k].shape for k in got)


@functools.lru_cache(maxsize=None)
def _jax_loss():
    _, jcfg = _cfgs()
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm_loss(p, b, Axes(), jcfg, dtype=jnp.float32)))


def _batch(vocab, t, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, t))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def _jax_params(seed):
    """JAX's smoke init with seeded non-default a_log, dt_bias and d_skip
    (the defaults give every head the same decay and skip)."""
    _, jcfg = _cfgs()
    jp = init_lm_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 7)
    m = dict(jp["layers"]["m"])
    m["a_log"] = jnp.asarray(rng.normal(size=m["a_log"].shape) * 0.5, jnp.float32)
    m["dt_bias"] = jnp.asarray(-4.0 + rng.uniform(-1, 1, m["dt_bias"].shape), jnp.float32)
    m["d_skip"] = jnp.asarray(rng.normal(size=m["d_skip"].shape), jnp.float32)
    return dict(jp, layers=dict(jp["layers"], m=m))


@pytest.mark.parametrize("t,seed", [(32, 0), (512, 1)])
def test_loss_and_grads_match_jax_f32(monkeypatch, t, seed):
    cfg, _ = _cfgs()
    jp = _jax_params(seed)
    nb = _batch(cfg.vocab, t, seed)
    jloss, jgrads = _jax_loss()(jp, {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()})
    flat = _flat(jgrads)

    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    shapes = param_shapes(cfg)
    assert set(params) == set(shapes)
    assert all(tuple(v.shape) == shapes[k] for k, v in params.items())
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    loss = lm_loss(leaves, batch, cfg, dtype=torch.float32)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert set(flat) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[k], err_msg=k, **TOL)
        assert bool(g.abs().max() > 0), k  # every leaf carries gradient

    # the shared block once per application, each with its own copy of the
    # leaves: two applications, each with a nonzero gradient, whose sum is
    # the tied gradient (and JAX's)
    copies, real = [], transformer._shared_attn_block

    def untied(p, *a):
        copies.append({k: v.detach().clone().requires_grad_(True) for k, v in p.items()})
        return real(copies[-1], *a)

    monkeypatch.setattr(transformer, "_shared_attn_block", untied)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss2 = lm_loss(leaves, batch, cfg, dtype=torch.float32)
    assert len(copies) == cfg.n_layers // cfg.attn_every == 2
    names = list(copies[0])
    per_block = torch.autograd.grad(loss2, [c[k] for c in copies for k in names])
    for i, k in enumerate(names):
        g0, g1 = per_block[i], per_block[len(names) + i]
        assert bool(g0.abs().max() > 0) and bool(g1.abs().max() > 0), k
        summed = (g1 + g0).numpy()  # backward reaches the last block first
        np.testing.assert_allclose(summed, grads[f"shared_attn/{k}"].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
        np.testing.assert_allclose(summed, flat[f"shared_attn/{k}"], err_msg=k, **TOL)
