"""Port vs JAX: the encoder-decoder family, seamless-m4t-medium (the audio
frontend stub, a bidirectional encoder, a decoder with causal
self-attention and cross attention, LayerNorms and GELU MLPs).

The config equals the JAX package's field for field, at its published
size and at its smoke size (2 + 2 layers, d_model 64, frontend_dim 32).
Its 37 leaves come in ``jax.tree.flatten``'s order with the shapes of
``jax.eval_shape(init_encdec_params)``: 877,445,120 parameters at full
size, ``lm_head`` untied. Every ``ln*/w`` starts at ones, every ``ln*/b``
and MLP bias at zeros, as JAX's do.

At smoke widths, on numpy-seeded inputs: ``layernorm``, ``gelu_mlp``, the
bidirectional attention (Tk not a multiple of JAX's chunk, so its padding
mask is exercised) and ``_cross_attention`` (Tq != Tk) match JAX's at
rtol 1e-5, atol 1e-6 in float32; with the exact erf GELU in place of the
tanh form the MLP misses that tolerance more than tenfold.
``encode`` and ``encdec_loss`` (value and every gradient leaf) match JAX's
in float32 at rtol 1e-4, atol 1e-5, and with bf16 activations at the
slices' relative L2 over the tree of 3e-2 (the loss at rtol 2e-2).
``input_specs`` and ``materialize_batch`` have JAX's structure (frames
bf16, target as long as source); ``params_from_jax`` gives the 37 names,
and the checkpoint store saves and restores them unchanged.
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.attention import _chunked_attn  # noqa: E402
from repro.models.common import Axes, layernorm as jlayernorm  # noqa: E402
from repro.models.mlp import gelu_mlp as jgelu_mlp  # noqa: E402
from repro.models.transformer import resolve_dims  # noqa: E402
import repro_torch.models.mlp as tmlp  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.launch.inputs import input_specs, materialize_batch  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.attention import gqa_attend  # noqa: E402
from repro_torch.models.common import layernorm  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.utils.tree import leaf_names  # noqa: E402

NAME = "seamless-m4t-medium"
N_LEAVES = 37
FULL_SIZE = 877_445_120
TOL = dict(rtol=1e-4, atol=1e-5)
MODULE_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_REL_L2 = 3e-2


def _paths(tree):
    return ["/".join(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs():
    return smoke_config(get_arch(NAME)), jsmoke(jget_arch(NAME))


def _jparams(seed=0):
    _, jcfg = _cfgs()
    return jencdec.init_encdec_params(jax.random.PRNGKey(seed), jcfg)


def _batch(cfg, b=2, ts=24, seed=7):
    """frames (B, Ts, fd) float32 from numpy, then bf16 as the batch carries
    them; tokens and labels (B, Ts), the last label masked."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, ts, cfg.frontend_dim)).astype(np.float32)
    frames = np.array(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32))
    toks = rng.integers(0, cfg.vocab, (b, ts))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"frames": frames, "tokens": toks, "labels": labels}


def _jbatch(batch):
    return {"frames": jnp.asarray(batch["frames"], jnp.bfloat16),
            "tokens": jnp.asarray(batch["tokens"], jnp.int32),
            "labels": jnp.asarray(batch["labels"], jnp.int32)}


def _tbatch(batch):
    return {"frames": torch.from_numpy(batch["frames"]).to(torch.bfloat16),
            "tokens": torch.from_numpy(batch["tokens"]),
            "labels": torch.from_numpy(batch["labels"])}


def _rel_l2(got, want):
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k].astype(np.float64)) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_config_and_leaves_match_jax(size):
    assert dataclasses.asdict(get_arch(NAME)) == dataclasses.asdict(jget_arch(NAME))
    cfg, jcfg = _cfgs() if size == "smoke" else (get_arch(NAME), jget_arch(NAME))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = jax.eval_shape(lambda k: jencdec.init_encdec_params(k, jcfg),
                            jax.random.PRNGKey(0))
    shapes = encdec.param_shapes(cfg)
    assert len(shapes) == N_LEAVES and leaf_names(shapes) == _paths(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert shapes["/".join(p.key for p in path)] == leaf.shape
    assert "lm_head" in shapes and shapes["lm_head"] == (cfg.d_model, cfg.vocab)
    if size == "full":
        sizes = {k: math.prod(s) for k, s in shapes.items()}
        assert sum(sizes.values()) == FULL_SIZE
        assert sizes["embed"] == sizes["lm_head"] == 262_354_944 == max(sizes.values())
        assert shapes["enc_layers/attn/wq"] == (12, 1024, 1024)
        assert shapes["dec_layers/mlp/w_in"] == (12, 1024, 4096)
        assert shapes["frontend_proj"] == (160, 1024)
    else:
        assert (cfg.enc_layers, cfg.dec_layers, cfg.d_model, cfg.frontend_dim) == (2, 2, 64, 32)


def test_initialisers_match_jax():
    cfg, _ = _cfgs()
    params = encdec.init_encdec_params(cfg, generator=torch.Generator().manual_seed(0),
                                       device="cpu")
    want = _flat(_jparams())
    assert set(params) == set(want)
    consts = [k for k in params if "/ln" in f"/{k}" or "/mlp/b_" in k]
    assert len(consts) == 18  # ln_enc, ln_dec; 6 leaves an encoder layer, 8 a decoder layer
    for k in consts:
        np.testing.assert_array_equal(params[k].numpy(), want[k], err_msg=k)
        assert float(params[k].abs().max()) in (0.0, 1.0), k
    assert torch.equal(params["dec_layers/ln_x/w"], torch.ones(cfg.dec_layers, cfg.d_model))
    fans = {"frontend_proj": cfg.frontend_dim, "embed": cfg.d_model, "lm_head": cfg.d_model,
            "enc_layers/attn/wo": cfg.d_model, "dec_layers/mlp/w_out": cfg.d_ff,
            "dec_layers/cross_attn/wk": cfg.d_model}
    for k, fan in fans.items():
        bound = 1 / math.sqrt(fan)
        for v in (params[k].numpy(), want[k]):
            assert 0.9 * bound < np.abs(v).max() <= bound, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 9, 64)) * 3 + 1.5).astype(np.float32)
    w, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    want = jlayernorm(jx, jnp.asarray(w), jnp.asarray(b))
    got = layernorm(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    else:  # the float32 result rounded to bf16: at most one ULP apart
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=2.0**-7, atol=1e-6)


def _mlp_inputs():
    rng = np.random.default_rng(2)
    p = {"w_in": rng.standard_normal((64, 128)) / 8, "b_in": rng.standard_normal(128) / 4,
         "w_out": rng.standard_normal((128, 64)) / 11, "b_out": rng.standard_normal(64) / 4}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    want = np.asarray(jgelu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                Axes()))
    return {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), want


def test_gelu_mlp_matches_jax():
    p, x, want = _mlp_inputs()
    np.testing.assert_allclose(tmlp.gelu_mlp(p, x).numpy(), want, **MODULE_TOL)


def test_exact_erf_gelu_misses_jax(monkeypatch):
    """The tolerance above tells the GELUs apart: with the exact erf form
    (``F.gelu``'s default) in place of the tanh one the MLP is off by far
    more than ten times what it allows."""
    p, x, want = _mlp_inputs()
    gelu = tmlp.F.gelu
    monkeypatch.setattr(tmlp.F, "gelu", lambda h, approximate="none": gelu(h))
    got = tmlp.gelu_mlp(p, x).numpy()
    err = np.abs(got - want).max()
    assert err > 10 * (MODULE_TOL["atol"] + MODULE_TOL["rtol"] * np.abs(want).max())
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **MODULE_TOL)


@pytest.mark.parametrize("tq,tk", [(40, 40), (24, 40), (33, 17)])
def test_unmasked_attention_matches_jax(tq, tk):
    """JAX's ``_chunked_attn(causal=False)`` with chunks of 16 (Tk padded
    to a multiple, the padding masked) against ``gqa_attend(causal=False)``,
    GQA with 4 query heads on 2 KV heads."""
    rng = np.random.default_rng([tq, tk])
    q = rng.standard_normal((2, tq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, tk, 2, 16)).astype(np.float32) for _ in range(2))
    pos = lambda t: jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (2, t))
    want = _chunked_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos(tq), pos(tk),
                         window=None, chunk=16, causal=False)
    got = gqa_attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(2, tq, 64), **MODULE_TOL)


def test_cross_attention_matches_jax():
    cfg, jcfg = _cfgs()
    jp = _jparams()
    cross = {k: v[0] for k, v in jp["dec_layers"]["cross_attn"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    dims = resolve_dims(jcfg, 1, 1)
    kv = jencdec._project_enc_kv(cross, jnp.asarray(enc), dims)
    pos = lambda t: jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (2, t))
    want = jencdec._cross_attention(cross, jnp.asarray(x), kv, pos(12), pos(20), Axes(), dims)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in cross.items()}
    tkv = encdec._project_enc_kv(tp, torch.from_numpy(enc), cfg)
    for a, b in zip(tkv, kv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODULE_TOL)
    got = encdec._cross_attention(tp, torch.from_numpy(x), tkv, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    cfg, jcfg = _cfgs()
    jp = _jparams()
    batch = _batch(cfg)
    want = jencdec.encode(jp, _jbatch(batch)["frames"], Axes(), jcfg, getattr(jnp, dtype))
    got = encdec.encode(params_from_jax(jp, "cpu"), _tbatch(batch)["frames"], cfg,
                        getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 24, cfg.d_model)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        assert _rel_l2({"h": got.float().numpy()}, {"h": want}) < BF16_REL_L2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    """``encdec_loss``, value and all 37 gradient leaves: the gradient of
    the encoder's leaves flows back through the cross attention of every
    decoder layer."""
    cfg, jcfg = _cfgs()
    jp = _jparams()
    batch = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p, b: jencdec.encdec_loss(p, b, Axes(), jcfg, dtype=getattr(jnp, dtype)))(
        jp, _jbatch(batch))
    jgrads = _flat(jgrads)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_jax(jp, "cpu").items()}
    loss = encdec.encdec_loss(leaves, _tbatch(batch), cfg, dtype=getattr(torch, dtype))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(jgrads) and len(grads) == N_LEAVES
    got = {k: g.numpy() for k, g in grads.items()}
    for k in ("enc_layers/attn/wq", "frontend_proj", "dec_layers/cross_attn/wk", "lm_head"):
        assert np.abs(jgrads[k]).max() > 0, k
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        for k, g in got.items():
            np.testing.assert_allclose(g, jgrads[k], err_msg=k, **TOL)
    else:
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-2)
        assert _rel_l2(got, jgrads) < BF16_REL_L2


def test_input_specs_and_batch_match_jax():
    cfg, jcfg = _cfgs()
    for kind in ("train", "prefill"):
        want = jinput_specs(jcfg, JShape("s", 48, 4, kind), kind)
        got = input_specs(cfg, ShapeConfig("s", 48, 4, kind), kind)
        assert set(got) == set(want)
        for k, (shape, dt) in got.items():
            assert shape == want[k].shape, k
            assert (dt == torch.bfloat16) == (want[k].dtype == jnp.bfloat16), k
    batch = materialize_batch(cfg, ShapeConfig("s", 48, 4, "train"),
                              torch.Generator().manual_seed(0), "cpu")
    assert batch["frames"].dtype == torch.bfloat16 and batch["frames"].shape == (4, 48, 32)
    assert torch.equal(batch["labels"], batch["tokens"])
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < cfg.vocab
    f = batch["frames"].float()
    assert abs(float(f.mean())) < 0.1 and 0.9 < float(f.std()) < 1.1


def test_params_from_jax_and_checkpoint_keep_the_leaves(tmp_path):
    jp = _jparams()
    params = params_from_jax(jp, "cpu")
    assert list(leaf_names(params)) == _paths(jp) and len(params) == N_LEAVES
    store = CheckpointStore(str(tmp_path), async_writes=False)
    store.save(3, {"params": params})
    state, _, step = store.restore({"params": params})
    assert step == 3 and set(state["params"]) == set(params)
    for k, v in params.items():
        assert torch.equal(state["params"][k], v), k
    store.close()


def test_train_loop_refuses_the_audio_frontend():
    """As the JAX package's train CLI cannot run encdec (it calls
    ``init_lm_params``), the port's ``train_loop`` refuses the config,
    naming the frames and the entry points that take them."""
    from repro_torch.launch.train import train_loop

    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="'audio' frontend takes frame embeddings.*"
                                         "build_train_step.*materialize_batch"):
        train_loop(cfg, ShapeConfig("s", 16, 2, "train"), steps=1, device="cpu")
