"""Port vs JAX: the dense decoder (granite-8b smoke config), loss and every
gradient leaf, with the JAX weights carried across.

Compared in float32 (``dtype=float32`` on both sides), where the point is
the algorithm: rtol=1e-4, atol=1e-5 covers the different reduction orders
(XLA's chunked online-softmax attention vs PyTorch's SDPA, matmul blocking).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro.models.transformer import init_lm_params, lm_loss as jlm_loss  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_lm_params as tinit, lm_loss, param_shapes, params_from_jax,
)
from repro_torch.utils.tree import leaf_names  # noqa: E402


def _batch(vocab, b, t, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def test_leaf_order_matches_jax_flatten():
    cfg = smoke_config(get_arch("granite-8b"))
    params = jax.eval_shape(
        lambda k: init_lm_params(k, jsmoke(jget_arch("granite-8b"))), jax.random.PRNGKey(0)
    )
    paths = ["/".join(p.key for p in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    shapes = param_shapes(cfg)
    assert leaf_names(shapes) == paths
    for (path, leaf) in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert shapes["/".join(p.key for p in path)] == leaf.shape


def test_full_width_granite_has_the_slice_leaves():
    import dataclasses

    shapes = param_shapes(dataclasses.replace(get_arch("granite-8b"), n_layers=4))
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()}
    assert max(sizes.values()) == 4 * 4096 * 14336 < 2**32
    assert abs(sum(sizes.values()) - 1.28e9) < 0.01e9


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_jax_f32(seed):
    jcfg = jsmoke(jget_arch("granite-8b"))
    cfg = smoke_config(get_arch("granite-8b"))
    jparams = init_lm_params(jax.random.PRNGKey(seed), jcfg)
    toks, labels = _batch(cfg.vocab, 2, 16, seed)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm_loss(p, jbatch, Axes(), jcfg, dtype=jnp.float32)
    )(jparams)

    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    loss = lm_loss(leaves, batch, cfg, dtype=torch.float32)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-5)
    flat = {"/".join(p.key for p in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(flat) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_random_init_matches_the_jax_distributions():
    cfg = smoke_config(get_arch("granite-8b"))
    params = tinit(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(params["ln_f"], torch.ones(cfg.d_model))
    for k, fan_in in (("embed", cfg.d_model), ("lm_head", cfg.d_model),
                      ("layers/mlp/w_down", cfg.d_ff)):
        bound = 1 / np.sqrt(fan_in)
        assert params[k].abs().max() <= bound and params[k].abs().max() > 0.9 * bound


def test_unported_model_features_raise():
    import dataclasses

    cfg = smoke_config(get_arch("granite-8b"))
    # the decoder-only LM refuses the encoder-decoder's family and frontend,
    # as the JAX package's init_lm_params does, naming models/encdec.py
    for change, name in ((dict(family="encdec"), "family 'encdec'"),
                         (dict(frontend="audio"), "the 'audio' frontend")):
        with pytest.raises(ValueError, match=f"{name}.*models/encdec.py"):
            param_shapes(dataclasses.replace(cfg, **change))
    # ported since: the encdec family, seamless-m4t-medium (models/encdec.py)
    seamless = get_arch("seamless-m4t-medium")
    assert (seamless.family, seamless.frontend) == ("encdec", "audio")
    with pytest.raises(ValueError, match="models/encdec.py"):
        param_shapes(seamless)
    # ported since: the ssm (xLSTM) family, tied embeddings, xlstm-125m
    assert "lm_head" not in param_shapes(dataclasses.replace(cfg, tie_embeddings=True))
    assert get_arch("xlstm-125m").family == "ssm"
    param_shapes(smoke_config(get_arch("xlstm-125m")))
