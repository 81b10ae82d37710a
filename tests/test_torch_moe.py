"""Port vs JAX: the moe family — mixtral-8x22b (8 experts, top-2, a
sliding window) and deepseek-v2-lite-16b (MLA, 64 routed experts top-6 and
2 shared experts).

Each config equals the JAX package's field for field, at its published
size and at its smoke size, and its leaves come in ``jax.tree.flatten``'s
order with JAX's shapes (the order fixes each leaf's encode seed).

Routing is discontinuous, so it is held bit for bit: the port's ``route``
picks JAX's ``_route`` experts exactly (ties to the lowest index, as
``lax.top_k``) on logits made exact in float32 (small integers times
multiples of 1/8, so the two GEMMs cannot round apart) with planted ties,
and ``dispatch_indices`` equals ``_dispatch_indices`` on the same ids,
with and without tokens past capacity. The MoE block (``moe_tp`` with
``Axes()``), MLA's ``mla_train`` and both smoke models' loss and every
gradient leaf match JAX's in float32 at rtol 1e-4, atol 1e-5.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models import mla as jmla, moe as jmoe  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro.models.transformer import init_lm_params, lm_loss as jlm_loss  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.mla import mla_train  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    FLOAT32_LEAVES, init_lm_params as tinit, lm_loss, param_shapes, params_from_jax,
)
from repro_torch.utils.tree import leaf_names  # noqa: E402

MOE = ("mixtral-8x22b", "deepseek-v2-lite-16b")
# parameters at full width, from shapes, at the chip paths' depths
FULL_WIDTH = {
    "mixtral-8x22b": (1, 2_906_720_256, 13, "layers/moe/w_gate", 805_306_368),
    "deepseek-v2-lite-16b": (2, 1_589_127_168, 18, "layers/moe/w_down", 369_098_752),
}
TOL = dict(rtol=1e-4, atol=1e-5)


def _paths(tree):
    return ["/".join(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", MOE)
def test_config_and_leaf_order_match_jax(name):
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(jget_arch(name))
    for cfg, jcfg in ((smoke_config(get_arch(name)), jsmoke(jget_arch(name))),
                      (dataclasses.replace(get_arch(name), n_layers=2),
                       dataclasses.replace(jget_arch(name), n_layers=2))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        params = jax.eval_shape(lambda k: init_lm_params(k, jcfg), jax.random.PRNGKey(0))
        shapes = param_shapes(cfg)
        assert leaf_names(shapes) == _paths(params)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            assert shapes["/".join(p.key for p in path)] == leaf.shape


def test_deepseek_leaves_in_jax_flatten_order():
    names = leaf_names(param_shapes(smoke_config(get_arch("deepseek-v2-lite-16b"))))
    assert names == [
        "embed", "layers/attn/w_dkv", "layers/attn/w_kr", "layers/attn/w_q",
        "layers/attn/w_uk", "layers/attn/w_uv", "layers/attn/wo", "layers/ln1", "layers/ln2",
        "layers/moe/router", "layers/moe/shared/w_down", "layers/moe/shared/w_gate",
        "layers/moe/shared/w_up", "layers/moe/w_down", "layers/moe/w_gate", "layers/moe/w_up",
        "lm_head", "ln_f",
    ]


@pytest.mark.parametrize("name", MOE)
def test_full_width_parameter_counts(name):
    layers, total, n_leaves, largest, size = FULL_WIDTH[name]
    shapes = param_shapes(dataclasses.replace(get_arch(name), n_layers=layers))
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    assert sum(sizes.values()) == total and len(sizes) == n_leaves
    assert sizes[largest] == max(sizes.values()) == size
    if name == "mixtral-8x22b":  # the three expert leaves, the port's largest
        assert [k for k, v in sizes.items() if v == size] == [
            "layers/moe/w_down", "layers/moe/w_gate", "layers/moe/w_up"]


def _exact(rng, shape, scale):
    """float32 values k·scale, k in -8..8: products and sums of a few
    dozen stay exact in float32, whatever the summation order."""
    return (rng.integers(-8, 9, shape) * scale).astype(np.float32)


def _router_inputs(seed, n, d, e, skew=False):
    """x (n, d) with a few all-zero rows (every expert tied) and a router
    (d, e) whose columns 1 and 2 are equal (those two experts tied on every
    token); with ``skew`` expert 0 wins every token that is not all zero."""
    rng = np.random.default_rng(seed)
    x = _exact(rng, (n, d), 0.25)
    x[::5] = 0.0
    router = _exact(rng, (d, e), 0.125)
    router[:, 2] = router[:, 1]
    if skew:
        x = np.abs(x)
        router[:, 0] = 1.0
    return x, router


@pytest.mark.parametrize("seed,e,k,skew", [(0, 4, 2, False), (1, 8, 2, True),
                                           (2, 16, 6, False), (3, 6, 3, True)])
def test_route_and_dispatch_bit_equal_to_jax(seed, e, k, skew):
    n, d = 60, 32
    x, router = _router_inputs(seed, n, d, e, skew)
    jw, jids = jmoe._route(jnp.asarray(router), jnp.asarray(x), e, k)
    w, ids = moe.route(torch.from_numpy(router), torch.from_numpy(x), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
    assert w.dtype == torch.float32
    # the planted ties went to the lowest index
    assert (ids[::5] == torch.arange(k)).all()
    for cap in (moe.capacity(n, k, e), 8, 3):
        jflat, jslot, jkeep = jmoe._dispatch_indices(jids, jw, e, cap)
        flat_e, slot, keep = moe.dispatch_indices(ids, e, cap)
        np.testing.assert_array_equal(flat_e.numpy(), np.asarray(jflat))
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        if cap == 3 or skew:  # tokens past capacity were dropped
            assert not bool(keep.all())
            assert int(slot[~keep].min()) == int(slot[~keep].max()) == cap - 1


def test_capacity_matches_the_jax_arithmetic():
    for n, k, e in ((4096 // 2, 2, 8), (2048, 6, 64), (128, 2, 8), (16, 2, 4), (1, 1, 64)):
        assert moe.capacity(n, k, e) == max(8, int(n * k * 1.25 / e))
    assert moe.capacity(2048, 2, 8) == 640 and moe.capacity(2048, 6, 64) == 240


def _moe_params(seed, d, f, e, n_shared, skew):
    rng = np.random.default_rng(seed + 50)
    p = {
        "router": rng.standard_normal((d, e)).astype(np.float32) / np.sqrt(d),
        "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / np.sqrt(d),
        "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / np.sqrt(d),
        "w_down": rng.standard_normal((e, f, d)).astype(np.float32) / np.sqrt(f),
    }
    if skew:  # expert 0 first for most tokens: past its capacity
        p["router"][:, 0] += 2.0
    if n_shared:
        fs = f * n_shared
        p["shared"] = {
            "w_gate": rng.standard_normal((d, fs)).astype(np.float32) / np.sqrt(d),
            "w_up": rng.standard_normal((d, fs)).astype(np.float32) / np.sqrt(d),
            "w_down": rng.standard_normal((fs, d)).astype(np.float32) / np.sqrt(fs),
        }
    return p


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("drops", [False, True])
def test_moe_block_and_grads_match_jax_f32(n_shared, drops):
    d, f, e, k = 32, 48, 4, 2
    # 8 tokens never overflow (an expert gets each token at most once, and
    # the capacity floor is 8); 48 skewed ones do (capacity 30)
    b, t = (2, 24) if drops else (2, 4)
    jp = _moe_params(b * t + n_shared, d, f, e, n_shared, drops)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    if drops:
        x += 0.5
    cot = rng.standard_normal((b, t, d)).astype(np.float32)

    def jf(p, xx):
        return jnp.sum(jmoe.moe_tp(p, xx, Axes(), n_experts=e, top_k=k) * cot)

    jout = jax.jit(lambda p, xx: jmoe.moe_tp(p, xx, Axes(), n_experts=e, top_k=k))(
        jp, jnp.asarray(x))
    jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))

    p = {k_: torch.from_numpy(v).requires_grad_(True) for k_, v in _flat(jp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_tp(p, tx, n_experts=e, top_k=k)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), [tx, *p.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    want = _flat(jgp)
    for (name, _), g in zip(p.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name, **TOL)
        assert bool(g.abs().max() > 0), name
    # the case is what its name says
    _, ids = moe.route(p["router"], tx.reshape(-1, d), k)
    _, _, keep = moe.dispatch_indices(ids, e, moe.capacity(b * t, k, e))
    assert bool(keep.all()) != drops


@pytest.mark.parametrize("seed,t", [(0, 24), (1, 40)])
def test_mla_train_and_grads_match_jax_f32(seed, t):
    d, h, hd, lora = 48, 3, 16, 32
    jp = jmla.init_mla_params(jax.random.PRNGKey(seed), d, h, hd, lora)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    cot = rng.standard_normal((2, t, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (2, t))

    def jf(p, xx):
        out = jmla.mla_train(p, xx, jnp.asarray(pos), Axes(), n_heads_local=h, head_dim=hd)
        return jnp.sum(out * cot), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = mla_train(p, tx, torch.from_numpy(pos.copy()), n_heads=h, head_dim=hd)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), [tx, *p.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for (name, _), g in zip(p.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[name]), err_msg=name, **TOL)


def _batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


# mixtral at 80 tokens, past its smoke window (64)
@pytest.mark.parametrize("name,t,seed", [("mixtral-8x22b", 80, 0), ("mixtral-8x22b", 32, 1),
                                         ("deepseek-v2-lite-16b", 40, 0)])
def test_loss_and_grads_match_jax_f32(name, t, seed):
    jcfg, cfg = jsmoke(jget_arch(name)), smoke_config(get_arch(name))
    jparams = init_lm_params(jax.random.PRNGKey(seed), jcfg)
    nb = _batch(cfg, 2, t, seed)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jbatch, Axes(), jcfg, dtype=jnp.float32)))(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert set(params) == set(param_shapes(cfg))
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    loss = lm_loss(leaves, {k: torch.from_numpy(v) for k, v in nb.items()}, cfg,
                   dtype=torch.float32)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    flat = _flat(jgrads)
    assert set(flat) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[k], err_msg=k, **TOL)
        assert bool(g.abs().max() > 0), k  # every new leaf carries gradient


# fan-in of each new matrix leaf, as the JAX package's dense_init calls
FAN_IN = {
    "layers/moe/router": "d", "layers/moe/w_gate": "d", "layers/moe/w_up": "d",
    "layers/moe/w_down": "f", "layers/moe/shared/w_gate": "d", "layers/moe/shared/w_up": "d",
    "layers/moe/shared/w_down": "fs", "layers/attn/w_dkv": "d", "layers/attn/w_kr": "d",
    "layers/attn/w_q": "d", "layers/attn/w_uk": "lora", "layers/attn/w_uv": "lora",
    "layers/attn/wo": "q",
}


@pytest.mark.parametrize("name", MOE)
def test_init_ties_dtypes_and_fan_ins_as_jax(name):
    cfg = smoke_config(get_arch(name))
    params = tinit(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                   dtype=torch.bfloat16)
    jparams = init_lm_params(jax.random.PRNGKey(0), jsmoke(jget_arch(name)), dtype=jnp.bfloat16)
    jflat = {k: str(v.dtype) for k, v in _flat(jparams).items()}
    for k, v in params.items():
        assert (v.dtype == torch.float32) == (k in FLOAT32_LEAVES) == (jflat[k] == "float32"), k
    gate, up, down = (params[f"layers/moe/{w}"] for w in ("w_gate", "w_up", "w_down"))
    assert torch.equal(up, gate)  # JAX: one key for both
    # JAX's w_down holds w_gate's uniforms at its own bound (up to bf16
    # rounding of both: within one bf16 step at w_gate's bound; untied
    # values would differ by up to twice w_down's bound)
    jg = _flat(jparams)
    scale, step = math.sqrt(cfg.d_model / cfg.d_ff), 2**-7 / math.sqrt(cfg.d_model)
    for g, dn in ((gate.float().numpy(), down.float().numpy()),
                  (np.asarray(jg["layers/moe/w_gate"], np.float32),
                   np.asarray(jg["layers/moe/w_down"], np.float32))):
        np.testing.assert_allclose(dn.reshape(g.shape), g * scale, rtol=0, atol=step)
    dims = dict(d=cfg.d_model, f=cfg.d_ff, fs=cfg.d_ff * cfg.n_shared_experts,
                lora=cfg.kv_lora, q=cfg.n_heads * cfg.head_dim)
    for k, fan in FAN_IN.items():
        if k in params:
            bound = 1 / np.sqrt(dims[fan])
            m = params[k].float().abs().max().item()
            assert 0.9 * bound < m <= bound * (1 + 2**-8), k
