"""Port vs JAX: the rest of the dense decoder family — minitron-4b,
qwen2.5-32b (QKV bias, rope_theta 1e6), h2o-danube-3-4b (sliding window,
head_dim 120) and internvl2-2b (the vit frontend stub of the vlm family).

Each config equals the JAX package's field for field, at its published
size and at its smoke size, and its leaves come in ``jax.tree.flatten``'s
order with JAX's shapes (the order fixes each leaf's encode seed). The loss
and every gradient leaf of each smoke config match JAX's ``lm_loss`` in
float32 (rtol 1e-4, atol 1e-5, as ``test_torch_model.py``): with nonzero
QKV biases set from the seed (zeros would leave the bias path untested),
danube's smoke window (64) at T = 160 (at T <= 64 it masks nothing), and
internvl2 with patch embeddings and text-only labels.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ShapeConfig as JShape, get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.launch.inputs import input_specs as jinput_specs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.common import Axes, plan_heads, rope as jrope  # noqa: E402
from repro.models.transformer import init_lm_params, lm_loss as jlm_loss  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.launch.inputs import input_specs, materialize_batch  # noqa: E402
from repro_torch.models.attention import attention_train  # noqa: E402
from repro_torch.models.common import rope  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_lm_params as tinit, lm_loss, param_shapes, params_from_jax,
)
from repro_torch.utils.tree import leaf_names  # noqa: E402

NEW = ("minitron-4b", "qwen2.5-32b", "h2o-danube-3-4b", "internvl2-2b")
# parameters at full width, from shapes (two layers: the chip paths' depth)
FULL_WIDTH_2L = {
    "qwen2.5-32b": 2_532_350_976,
    "minitron-4b": 1_793_080_320,
    "h2o-danube-3-4b": 555_436_800,
    "internvl2-2b": 507_033_600,
}


def _paths(tree):
    return ["/".join(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", NEW)
def test_config_and_leaf_order_match_jax(name):
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(jget_arch(name))
    cfg, jcfg = smoke_config(get_arch(name)), jsmoke(jget_arch(name))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = jax.eval_shape(lambda k: init_lm_params(k, jcfg), jax.random.PRNGKey(0))
    shapes = param_shapes(cfg)
    assert leaf_names(shapes) == _paths(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert shapes["/".join(p.key for p in path)] == leaf.shape


def test_new_leaves_sort_where_jax_flattens_them():
    qwen = leaf_names(param_shapes(smoke_config(get_arch("qwen2.5-32b"))))
    assert qwen.index("layers/attn/bk") < qwen.index("layers/attn/wk")
    assert qwen[1:4] == ["layers/attn/bk", "layers/attn/bq", "layers/attn/bv"]
    vl = leaf_names(param_shapes(smoke_config(get_arch("internvl2-2b"))))
    assert vl[:2] == ["embed", "frontend_proj"] and vl[2].startswith("layers/")


@pytest.mark.parametrize("name", NEW)
def test_full_width_parameter_counts(name):
    shapes = param_shapes(dataclasses.replace(get_arch(name), n_layers=2))
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    assert sum(sizes.values()) == FULL_WIDTH_2L[name]
    # the largest leaf: embed / lm_head (minitron's 786,432,000 elements is
    # the largest the port has carried; 3.1 GB in float32, past 2^31 bytes)
    cfg = get_arch(name)
    assert max(sizes.values()) == cfg.vocab * cfg.d_model < 2**31
    if name == "minitron-4b":
        assert cfg.vocab * cfg.d_model == 786_432_000 and 4 * 786_432_000 > 2**31


def _batch(cfg, b, t_text, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t_text))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.frontend == "vit":  # bf16 values, as the batch carries them
        pe = rng.standard_normal((b, cfg.n_frontend_tokens, cfg.frontend_dim), np.float32)
        out["patch_embeds"] = torch.from_numpy(pe).to(torch.bfloat16).float().numpy()
    return out


def _with_biases(jparams, seed):
    """Every QKV bias leaf set to N(0, 0.1) from ``seed``."""
    rng = np.random.default_rng(seed + 100)

    def one(path, x):
        if path[-1].key in ("bq", "bk", "bv"):
            return jnp.asarray(rng.standard_normal(x.shape, np.float32) * 0.1)
        return x

    return jax.tree_util.tree_map_with_path(one, jparams)


# (config, text length, seed): danube at 160 tokens, past its smoke window
LOSS_CASES = [
    ("minitron-4b", 32, 0), ("qwen2.5-32b", 32, 0), ("qwen2.5-32b", 32, 1),
    ("h2o-danube-3-4b", 160, 0), ("internvl2-2b", 24, 0), ("internvl2-2b", 24, 1),
]


@pytest.mark.parametrize("name,t_text,seed", LOSS_CASES)
def test_loss_and_grads_match_jax_f32(name, t_text, seed):
    jcfg = jsmoke(jget_arch(name))
    cfg = smoke_config(get_arch(name))
    jparams = init_lm_params(jax.random.PRNGKey(seed), jcfg)
    if cfg.qkv_bias:
        jparams = _with_biases(jparams, seed)
        assert all(bool(jnp.any(jparams["layers"]["attn"][b] != 0)) for b in ("bq", "bk", "bv"))
    nb = _batch(cfg, 2, t_text, seed)
    jbatch = {k: jnp.asarray(v, jnp.int32) if v.dtype.kind == "i" else jnp.asarray(v).astype(
        jnp.bfloat16) for k, v in nb.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm_loss(p, jbatch, Axes(), jcfg, dtype=jnp.float32)
    )(jparams)

    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert set(params) == set(param_shapes(cfg))
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    if "patch_embeds" in batch:
        batch["patch_embeds"] = batch["patch_embeds"].to(torch.bfloat16)
    loss = lm_loss(leaves, batch, cfg, dtype=torch.float32)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-5)
    flat = {"/".join(p.key for p in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(flat) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("layers/attn/bq", "frontend_proj"):
        if k in grads:  # the new leaves carry gradient
            assert bool(grads[k].abs().max() > 0)


@pytest.mark.parametrize("window", [8, None])
def test_sliding_window_masks_far_tokens(window):
    """Port of ``tests/test_archs.py::test_sliding_window_masks_far_tokens``:
    with a window of 8 the last query does not see token 0; without one it
    does. The port's attention also matches JAX's on both inputs."""
    layout = plan_heads(4, 2, 16, 1)
    key = jax.random.PRNGKey(0)
    jp = jattn.init_attn_params(key, 32, layout)
    x = jax.random.normal(key, (1, 64, 32))
    x2 = x.at[0, 0].add(100.0)
    pos = jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32), (1, 64))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    tpos = torch.arange(64)[None]
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, window=window)
    out = attention_train(p, torch.from_numpy(np.array(x)), tpos, **kw)
    out2 = attention_train(p, torch.from_numpy(np.array(x2)), tpos, **kw)
    for xx, got in ((x, out), (x2, out2)):
        # outputs reach ~60 with the perturbed token: atol at that scale
        want = jattn.attention_train(jp, xx, pos, Axes(), layout, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if window is None:
        assert not torch.allclose(out[0, -1], out2[0, -1], atol=1e-4)
    else:
        # the last query's window is 56..63: token 0 lies outside it
        assert torch.allclose(out[0, -1], out2[0, -1], atol=1e-4)
        assert not torch.allclose(out[0, 7], out2[0, 7], atol=1e-4)


@pytest.mark.parametrize("theta,dh", [(1e6, 128), (1e4, 120), (1e6, 16)])
def test_rope_matches_jax(theta, dh):
    rng = np.random.default_rng(int(dh))
    x = rng.standard_normal((2, 40, 3, dh), np.float32)
    # the smoke sizes' positions: far out, one ULP of a frequency (XLA's exp
    # against PyTorch's) moves the angle by position x ULP
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    want = jrope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NEW)
def test_input_specs_match_jax(name):
    cfg = get_arch(name)
    shape = ShapeConfig("t", 2048, 4, "train")
    want = jinput_specs(jget_arch(name), JShape("t", 2048, 4, "train"))
    got = input_specs(cfg, shape)
    assert set(got) == set(want)
    for k, (dims, dtype) in got.items():
        assert dims == want[k].shape
        assert (dtype == torch.bfloat16) == (want[k].dtype == jnp.bfloat16)
    batch = materialize_batch(cfg, ShapeConfig("t", 300, 2, "train"),
                              torch.Generator().manual_seed(0), "cpu")
    t_text = 300 - cfg.n_frontend_tokens if cfg.frontend == "vit" else 300
    assert batch["tokens"].shape == (2, t_text) and torch.equal(batch["labels"], batch["tokens"])
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < cfg.vocab
    if cfg.frontend == "vit":
        assert batch["patch_embeds"].shape == (2, 256, 1024)
        assert batch["patch_embeds"].dtype == torch.bfloat16


def test_random_init_of_the_new_leaves():
    qwen = smoke_config(get_arch("qwen2.5-32b"))
    params = tinit(qwen, generator=torch.Generator().manual_seed(0), device="cpu")
    for b in ("bq", "bk", "bv"):
        assert torch.equal(params[f"layers/attn/{b}"], torch.zeros(param_shapes(qwen)[f"layers/attn/{b}"]))
    vl = smoke_config(get_arch("internvl2-2b"))
    proj = tinit(vl, generator=torch.Generator().manual_seed(0), device="cpu")["frontend_proj"]
    bound = 1 / np.sqrt(vl.frontend_dim)
    assert proj.shape == (vl.frontend_dim, vl.d_model)
    assert proj.abs().max() <= bound and proj.abs().max() > 0.9 * bound


def test_vlm_loss_reads_only_the_text_positions():
    """The labels cover the text; the patches shift every text position by
    n_frontend_tokens and change the loss through attention alone."""
    cfg = smoke_config(get_arch("internvl2-2b"))
    params = tinit(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    batch = materialize_batch(cfg, ShapeConfig("t", 8 + 16, 2, "train"),
                              torch.Generator().manual_seed(4), "cpu")
    loss = lm_loss(params, batch, cfg, dtype=torch.float32)
    other = dict(batch, patch_embeds=batch["patch_embeds"] * 2)
    assert torch.isfinite(loss) and lm_loss(params, other, cfg, dtype=torch.float32) != loss


def test_train_loop_refuses_the_vit_frontend():
    """The synthetic token data carries no patch embeddings: ``train_loop``
    names the entry points that drive internvl2-2b instead."""
    from repro_torch.launch.train import train_loop

    cfg = smoke_config(get_arch("internvl2-2b"))
    with pytest.raises(ValueError, match="build_train_step and launch.inputs.materialize_batch"):
        train_loop(cfg, ShapeConfig("t", 16, 2, "train"), steps=1, device="cpu")
