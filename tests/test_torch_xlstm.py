"""Port vs JAX: the xLSTM family of ``repro_torch/models/xlstm.py`` and the
``ssm`` branch of ``repro_torch/models/transformer.py`` against
``repro/models/xlstm.py`` and ``repro/models/transformer.py`` on the same
numpy-seeded inputs, and tied embeddings on every family.

* ``mlstm_train`` at T = 64 in chunks of 16 (the C and n carries cross
  three chunk boundaries) and at the default chunk (one chunk), and
  ``slstm_train`` at T = 32, each in float32 and with bf16 activations
  (float32 params, as the train path runs them): the output and the
  gradients of x and every leaf under a random cotangent, against
  ``jax.grad`` of the JAX function. Float32 is held to rtol 1e-4, atol
  1e-5 (cumulative sums and log-sigmoid differ from XLA's by an ULP here
  and there), each gradient to atol 1e-5 of its leaf's largest |g|. With
  bf16 activations the projections round to bf16 in both packages, where
  one ULP (2^-8) apart flips a rounding downstream: outputs to rtol 2e-2,
  atol 2e-2 of their largest |value|, gradients to a relative L2 error of
  2e-2 per leaf.
* The sLSTM's gate layout: each step reads its pre-activations as (B, H,
  4·dh) and splits the last axis into i, f, g, o (head-major columns).
* The sLSTM time loop's hand-written backward: against finite differences
  (float64 gradcheck) and against the same loop through autograd.
* The config and its 24 leaves in ``jax.tree.flatten`` order with JAX's
  shapes (71,744,320 parameters at published width, no ``lm_head``), the
  (m, m, s) depth rule, the constant initialisers, and the smoke model's
  loss and every gradient against JAX's ``lm_loss`` in float32.
* Tied embeddings on a dense config (granite-8b's smoke config with
  ``tie_embeddings=True``): no ``lm_head`` leaf, the loss and ``embed``'s
  gradient (the lookup's and the head's, summed) equal to JAX's.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro.models.transformer import init_lm_params, lm_loss as jlm_loss  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_lm_params as tinit, lm_loss, param_shapes, params_from_jax,
)
from repro_torch.utils.tree import leaf_names  # noqa: E402

NAME = "xlstm-125m"
TOL = dict(rtol=1e-4, atol=1e-5)
D, H, DH = 64, 4, 16  # the smoke config's widths
FULL_WIDTH = 71_744_320  # the config as written (it calls itself unverified)


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a, np.float32))
    return out if dtype is None else out.to(dtype)


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _paths(tree):
    return list(_flat(tree))


def _close_grad(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(scale, 1.0),
                               err_msg=name)


def _close_bf16(got, want, name):
    """Relative L2 error below 2e-2 (bf16 activations)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err < 2e-2, (name, err)


def _cell_params(cell, seed):
    """The JAX init of an mLSTM or sLSTM cell from ``seed``, with seeded
    non-default biases (the defaults give every head the same gates) and
    norm weights."""
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed + 1000)
    if cell == "mlstm":
        p = jxl.init_mlstm_params(key, D, H, DH)
        p["if_bias"] = p["if_bias"] + jnp.asarray(rng.uniform(-1, 1, (2 * H,)), jnp.float32)
    else:
        p = jxl.init_slstm_params(key, D, H, DH)
        p["b"] = jnp.asarray(rng.normal(size=(4 * H * DH,)) * 0.5, jnp.float32)
    p["norm_w"] = jnp.asarray(1.0 + 0.2 * rng.normal(size=(H * DH,)), jnp.float32)
    return p


@functools.lru_cache(maxsize=None)
def _jax_cell(cell, chunk):
    """JAX's output and its gradients for (params, x) under cotangent
    ``cot``, jitted once per cell and chunk size."""
    def f(p, xx, cot):
        kw = dict(n_heads_local=H, head_dim=DH)
        if cell == "mlstm":
            y = jxl.mlstm_train(p, xx, Axes(), chunk=chunk, **kw)
        else:
            y = jxl.slstm_train(p, xx, Axes(), **kw)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def _cell_vs_jax(cell, seed, t, chunk, dtype):
    jp = _cell_params(cell, seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    cot = rng.standard_normal((2, t, D)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    (_, jy), (jgp, jgx) = _jax_cell(cell, chunk)(jp, jnp.asarray(x).astype(jd), jnp.asarray(cot))
    p = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    xx = _t(x, td).requires_grad_(True)
    kw = dict(n_heads=H, head_dim=DH)
    if cell == "mlstm":
        y = xlstm.mlstm_train(p, xx, chunk=chunk, **kw)
    else:
        y = xlstm.slstm_train(p, xx, **kw)
    assert y.dtype == td and tuple(y.shape) == jy.shape
    grads = torch.autograd.grad((y.float() * _t(cot)).sum(), [xx, *p.values()])
    assert set(p) == set(jgp)
    got = {"y": y.detach().float().numpy(), "x": grads[0].float().numpy(),
           **{k: g.numpy() for k, g in zip(p, grads[1:])}}
    want = {"y": np.asarray(jy.astype(jnp.float32)), "x": np.asarray(jgx.astype(jnp.float32)),
            **{k: np.asarray(v) for k, v in jgp.items()}}
    for k in got:
        if k != "y":
            assert bool(np.abs(got[k]).max() > 0), k  # every leaf carries gradient
        if dtype == "float32":
            if k == "y":
                np.testing.assert_allclose(got[k], want[k], **TOL)
            else:
                _close_grad(got[k], want[k], k)
        elif k == "y":
            np.testing.assert_allclose(got[k], want[k], rtol=2e-2,
                                       atol=2e-2 * float(np.abs(want[k]).max()))
        else:
            _close_bf16(got[k], want[k], k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,chunk", [(64, 16), (64, 256)])
def test_mlstm_train_and_its_gradients_match_jax(t, chunk, dtype):
    _cell_vs_jax("mlstm", 0, t, chunk, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_train_and_its_gradients_match_jax(dtype):
    _cell_vs_jax("slstm", 1, 32, None, dtype)


@pytest.mark.parametrize("seed", [2, 3])
def test_mlstm_and_slstm_match_jax_at_other_seeds(seed):
    _cell_vs_jax("mlstm", seed, 64, 16, "float32")
    _cell_vs_jax("slstm", seed, 32, None, "float32")


def test_mlstm_asserts_whole_chunks():
    p = {k: _t(v) for k, v in _cell_params("mlstm", 0).items()}
    with pytest.raises(AssertionError):
        xlstm.mlstm_train(p, torch.zeros(1, 24, D), n_heads=H, head_dim=DH, chunk=16)


def test_mlstm_chunking_does_not_change_the_output():
    """The same sequence in chunks of 8, 16 and 64 (one): the carried C and
    n stand in for the earlier chunks."""
    p = {k: _t(v) for k, v in _cell_params("mlstm", 4).items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 64, D)).astype(np.float32))
    outs = [xlstm.mlstm_train(p, x, n_heads=H, head_dim=DH, chunk=c) for c in (8, 16, 64)]
    for o in outs[:2]:
        torch.testing.assert_close(o, outs[2], rtol=1e-4, atol=1e-5)


def test_mlstm_masked_decays_keep_a_zero_gradient():
    """Large input gates push the masked entries of qk·decay to e^30; the
    where keeps their gradient at 0 (no inf·0), as JAX's."""
    jp = _cell_params("mlstm", 5)
    jp["if_bias"] = jp["if_bias"].at[:H].set(0.0).at[H:].set(-30.0)  # logf ~ -30 a step
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 32, D)).astype(np.float32)
    cot = rng.standard_normal((1, 32, D)).astype(np.float32)
    (_, jy), (jgp, jgx) = _jax_cell("mlstm", 16)(jp, jnp.asarray(x), jnp.asarray(cot))
    p = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    xx = _t(x).requires_grad_(True)
    y = xlstm.mlstm_train(p, xx, n_heads=H, head_dim=DH, chunk=16)
    grads = torch.autograd.grad((y * _t(cot)).sum(), [xx, *p.values()])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    _close_grad(grads[0].numpy(), np.asarray(jgx), "x")
    for k, g in zip(p, grads[1:]):
        _close_grad(g.numpy(), np.asarray(jgp[k]), k)


def test_slstm_gate_layout_is_head_major():
    """A w_in whose gate blocks differ by head, r_h zero, x a one-hot: step
    0's pre-activations for head j are its own 4·dh columns, split into i,
    f, g, o. The port, JAX and the formula agree; splitting the 4·H·dh axis
    into gates first would not."""
    dk = H * DH
    a = np.linspace(-1.5, 1.5, 4 * H).reshape(H, 4)  # (head, gate) values
    w_in = np.zeros((D, 4 * dk), np.float32)
    w_in[0] = np.repeat(a.reshape(-1), DH)  # column j·4dh + g·dh + e: a[j, g]
    p = {"w_in": w_in, "r_h": np.zeros((H, DH, 4 * DH), np.float32),
         "b": np.zeros(4 * dk, np.float32), "norm_w": np.ones(dk, np.float32),
         "w_out": np.eye(dk, D, dtype=np.float32)}
    x = np.zeros((1, 1, D), np.float32)
    x[0, 0, 0] = 1.0
    zx = xlstm.slstm_proj({k: _t(v) for k, v in p.items()}, _t(x))
    hs = xlstm.slstm_scan(zx, _t(p["r_h"]), H, DH)[0, 0].reshape(H, DH)

    def h0(zi, zf, zg, zo):  # one step from h = c = 0
        c = np.exp(np.minimum(zi, 0.0)) * np.tanh(zg)
        return 1 / (1 + np.exp(-zo)) * np.tanh(c)

    want = np.stack([np.full(DH, h0(*a[j])) for j in range(H)])
    np.testing.assert_allclose(hs.numpy(), want, rtol=1e-6)
    gate_major = w_in[0].reshape(4, H, DH)[:, :, 0]  # the wrong split: (gate, head)
    wrong = np.stack([np.full(DH, h0(*gate_major[:, j])) for j in range(H)])
    assert not np.allclose(wrong, want, atol=1e-3)
    jy = jxl.slstm_train({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), Axes(),
                         n_heads_local=H, head_dim=DH)
    y = xlstm.slstm_train({k: _t(v) for k, v in p.items()}, _t(x), n_heads=H, head_dim=DH)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_slstm_scan_backward_passes_gradcheck():
    """The hand-written backward against finite differences, float64 (the
    scan's buffers take its input's type): (T, H, B, 4·dh) = (7, 2, 2, 12)."""
    g = torch.Generator().manual_seed(6)
    z_all = torch.randn(7, 2, 2, 12, generator=g, dtype=torch.float64).requires_grad_(True)
    r = (torch.randn(2, 3, 12, generator=g, dtype=torch.float64) / 2).requires_grad_(True)
    assert torch.autograd.gradcheck(xlstm._SlstmScan.apply, (z_all, r))


@pytest.mark.parametrize("t", [1, 33])
def test_slstm_scan_matches_the_autograd_loop(t):
    """Output and gradients of the hand-written scan against the loop
    through autograd (``slstm_scan_reference``), float32 (the recurrent
    product and add are one baddbmm here: rtol 1e-5, atol 1e-6 of the
    largest |value|)."""
    g = torch.Generator().manual_seed(7)
    zx = (torch.randn(2, t, 4 * H * DH, generator=g) * 2).requires_grad_(True)
    r_h = (torch.randn(H, DH, 4 * DH, generator=g) / 4).requires_grad_(True)
    cot = torch.randn(2, t, H * DH, generator=g)
    outs = []
    for fn in (xlstm.slstm_scan, xlstm.slstm_scan_reference):
        y = fn(zx, r_h, H, DH)
        outs.append([y, *torch.autograd.grad((y * cot).sum(), [zx, r_h])])
    for got, want in zip(*outs):
        scale = float(want.detach().abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# the family: config, leaves, initialisers, the smoke model against JAX's
# ---------------------------------------------------------------------------
def _cfgs(layers=None):
    if layers is None:
        return smoke_config(get_arch(NAME)), jsmoke(jget_arch(NAME))
    return (dataclasses.replace(get_arch(NAME), n_layers=layers),
            dataclasses.replace(jget_arch(NAME), n_layers=layers))


@pytest.mark.parametrize("layers", [None, 3, 12])
def test_config_and_leaf_order_match_jax(layers):
    assert dataclasses.asdict(get_arch(NAME)) == dataclasses.asdict(jget_arch(NAME))
    assert get_arch(NAME).source == "arXiv:2405.04517" and get_arch(NAME).tie_embeddings
    cfg, jcfg = _cfgs(layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if layers is None:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim) == (3, 64, 4, 16)
    params = jax.eval_shape(lambda k: init_lm_params(k, jcfg), jax.random.PRNGKey(0))
    shapes = param_shapes(cfg)
    assert len(shapes) == 24 and leaf_names(shapes) == _paths(params)
    assert "lm_head" not in shapes
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert shapes["/".join(p.key for p in path)] == leaf.shape
    nb, h, dh = cfg.n_layers // 3, cfg.n_heads, cfg.head_dim
    assert shapes["layers/s/cell/r_h"] == (nb, h, dh, 4 * dh)
    assert shapes["layers/m1/cell/if_bias"] == (nb, 2 * h)


def test_full_width_parameter_count():
    cfg, _ = _cfgs(12)
    sizes = {k: math.prod(s) for k, s in param_shapes(cfg).items()}
    assert sum(sizes.values()) == FULL_WIDTH
    assert max(sizes.values()) == sizes["embed"] == 50304 * 768 == 38_633_472
    assert min(sizes.values()) == sizes["layers/m1/cell/if_bias"] == 4 * 8
    assert sizes["layers/s/cell/r_h"] == 4 * 4 * 192 * 768


@pytest.mark.parametrize("layers", [2, 4, 13, 0])
def test_depth_not_a_multiple_of_three_is_refused(layers):
    cfg, _ = _cfgs(layers)
    with pytest.raises(ValueError, match=r"\(m, m, s\) blocks of 3"):
        param_shapes(cfg)
    with pytest.raises(ValueError, match="multiple of 3"):
        tinit(cfg, generator=torch.Generator().manual_seed(0), device="meta")


def test_constant_initialisers_and_fan_ins():
    cfg, jcfg = _cfgs(6)
    params = tinit(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    want = _flat(init_lm_params(jax.random.PRNGKey(0), jcfg))
    consts = [k for k in params if k.endswith(("/ln", "norm_w", "ln_f", "cell/b", "if_bias"))]
    assert len(consts) == 10
    for k in consts:
        np.testing.assert_array_equal(params[k].numpy(), want[k], err_msg=k)
    assert params["layers/m2/cell/if_bias"][1].tolist() == [-2.0] * 4 + [3.0] * 4
    assert not params["layers/s/cell/b"].any()
    # uniform ±1/√fan_in, fan_in the next-to-last axis: r_h's head_dim
    fans = {"layers/s/cell/r_h": cfg.head_dim, "layers/s/cell/w_in": cfg.d_model,
            "layers/m1/cell/w_if": cfg.d_model, "layers/m1/cell/w_out": 4 * cfg.head_dim,
            "embed": cfg.d_model}
    for k, fan in fans.items():
        bound = 1 / math.sqrt(fan)
        assert params[k].abs().max() <= bound and params[k].abs().max() > 0.9 * bound, k
        assert float(np.abs(want[k]).max()) <= bound, k
    bf = tinit(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
               dtype=torch.bfloat16)
    assert {str(v.dtype) for v in bf.values()} == {"torch.bfloat16"}
    assert torch.equal(bf["layers/m1/cell/if_bias"].float(), params["layers/m1/cell/if_bias"])


@functools.lru_cache(maxsize=None)
def _jax_loss(name, tie):
    if name == NAME:
        _, jcfg = _cfgs()
    else:
        jcfg = dataclasses.replace(jsmoke(jget_arch(name)), tie_embeddings=tie)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm_loss(p, b, Axes(), jcfg, dtype=jnp.float32)))


def _batch(vocab, t, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, t))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def _loss_vs_jax(cfg, jcfg, jp, t, seed, name, tie=False):
    nb = _batch(cfg.vocab, t, seed)
    jloss, jgrads = _jax_loss(name, tie)(jp, {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()})
    flat = _flat(jgrads)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    shapes = param_shapes(cfg)
    assert list(params) == list(flat) and set(params) == set(shapes)
    assert all(tuple(v.shape) == shapes[k] for k, v in params.items())
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    loss = lm_loss(leaves, batch, cfg, dtype=torch.float32)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for k, g in grads.items():
        _close_grad(g.numpy(), flat[k], k)
        assert bool(g.abs().max() > 0), k  # every leaf carries gradient
    return params, batch, grads


@pytest.mark.parametrize("t,seed", [(32, 0), (512, 1)])
def test_loss_and_grads_match_jax_f32(t, seed):
    """The smoke model (one (m, m, s) block), at T = 32 (one mLSTM chunk)
    and T = 512 (two chunks of 256); the mLSTM gate biases seeded off
    their defaults."""
    cfg, jcfg = _cfgs()
    jp = init_lm_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 7)
    lay = jp["layers"]
    for m in ("m1", "m2"):
        cell = dict(lay[m]["cell"])
        cell["if_bias"] = cell["if_bias"] + jnp.asarray(
            rng.uniform(-1, 1, cell["if_bias"].shape), jnp.float32)
        lay = dict(lay, **{m: dict(lay[m], cell=cell)})
    jp = dict(jp, layers=lay)
    assert "lm_head" not in jp
    _loss_vs_jax(cfg, jcfg, jp, t, seed, NAME)


def test_tied_embeddings_on_a_dense_config_match_jax():
    """granite-8b's smoke config with tie_embeddings: no lm_head leaf; the
    loss and embed's gradient (lookup and head summed) equal JAX's; and
    the head's share is what an untied copy of embed would receive."""
    cfg = dataclasses.replace(smoke_config(get_arch("granite-8b")), tie_embeddings=True)
    jcfg = dataclasses.replace(jsmoke(jget_arch("granite-8b")), tie_embeddings=True)
    assert "lm_head" not in param_shapes(cfg)
    assert len(param_shapes(cfg)) == len(param_shapes(dataclasses.replace(
        cfg, tie_embeddings=False))) - 1
    jp = init_lm_params(jax.random.PRNGKey(3), jcfg)
    assert "lm_head" not in jp
    params, batch, grads = _loss_vs_jax(cfg, jcfg, jp, 32, 3, "granite-8b", tie=True)
    # untie: lm_head = embed.T as its own leaf; the two gradients sum to
    # the tied one
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    leaves["lm_head"] = params["embed"].detach().T.clone().requires_grad_(True)
    loss = lm_loss(leaves, batch, untied, dtype=torch.float32)
    g_embed, g_head = torch.autograd.grad(loss, [leaves["embed"], leaves["lm_head"]])
    assert bool(g_head.abs().max() > 0) and bool(g_embed.abs().max() > 0)
    torch.testing.assert_close(g_embed + g_head.T, grads["embed"], rtol=1e-5, atol=1e-8)
