"""Port vs JAX: the decode path of the attention families (``models/decode.py``,
``attention_decode``, ``mla_decode`` and their caches).

1. One attention step against JAX's from the same layer weights, input and
   cache (random, partly filled: one row empty, one past the window): GQA
   (granite), the sliding window (danube, window 64 at position 70+), the
   QKV bias (qwen, the zero-initialised biases replaced by random ones), and
   MLA's latent cache (deepseek); float32 and bf16. The output and the new
   cache are compared; ``kv_pos`` bit for bit.
2. ``lm_decode_step`` of the seven attention-family smoke configs, float32
   and bf16: three consecutive steps from a random cache, JAX's cache handed
   to the port before each step (``cache_from_jax``), the logits and the new
   cache compared after each. In bf16 the JAX step runs un-jitted, each
   operation rounded to bf16 as written: jitted, XLA keeps the bf16 values
   inside a fusion in float32 (its excess precision), which moves the
   logits by up to 3.5 bf16 ULPs of the largest |logit| from its own
   un-jitted step (the port matches the un-jitted step bit for bit on
   these inputs).
3. Train == decode on the port (float32): decoding a prompt token by token
   gives ``lm_forward``'s logits at every position: GQA (granite), the
   window (danube at T = 80), MLA with the MoE block (deepseek at T = 8,
   where the MoE capacity of 8 drops nothing in either).
4. MoE decode drops nothing at 8 slots or fewer, even with every token on
   one expert (a token picks an expert at most once); at 9 tokens it can.
5. The encoder-decoder has no decoder-only cache: ``init_lm_cache`` and
   ``lm_decode_step`` raise ``ValueError`` for it, as the JAX package's
   ``init_lm_cache`` does (the recurrent families' decode is
   ``test_torch_recurrent_decode.py``'s).

Tolerances: float32 at rtol 1e-5 with atol 1e-5 of the largest |value|
(the two packages sum the products in different orders); bf16 within 2
bf16 ULPs of the largest |value| (the ULP of a value in [2^e, 2^(e+1)) is
2^(e-7)).
"""
import dataclasses
import math
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro.models.transformer import init_lm_params as jinit, resolve_dims  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.models.attention import attention_decode  # noqa: E402
from repro_torch.models.decode import cache_from_jax, init_lm_cache, lm_decode_step  # noqa: E402
from repro_torch.models.mla import mla_decode  # noqa: E402
from repro_torch.models.moe import capacity, dispatch_indices  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_lm_params, lm_forward, lm_logits, params_from_jax,
)

ATTN_ARCHS = ("granite-8b", "qwen2.5-32b", "minitron-4b", "h2o-danube-3-4b", "internvl2-2b",
              "mixtral-8x22b", "deepseek-v2-lite-16b")
B, S = 3, 80
START = np.array([0, 17, 70])  # row b's first position: empty, short, past the window
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(name):
    return jsmoke(jget_arch(name)), smoke_config(get_arch(name))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close(got, want, dtype: str, what: str):
    """The module docstring's tolerance; integers bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    want = want.astype(np.float32)
    big = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * big, err_msg=what)
    else:
        ulp = 2.0 ** (math.floor(math.log2(big)) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp, err_msg=what)


def _random_cache(rng, shapes, jdt, start=START):
    """A cache tree of numpy arrays in JAX's cache type: random entries, and
    ``kv_pos`` filled for positions < start[b], empty (2**30) after."""
    out = {}
    for name, shape in shapes.items():
        if name == "kv_pos":
            pos = np.arange(shape[-1])[None, :]
            kv = np.where(pos < start[:, None], pos, 2**30).astype(np.int32)
            out[name] = np.broadcast_to(kv, shape).copy()
        else:
            out[name] = np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
    return out


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def cache_to_numpy(cache):
    """The port's cache as float32 / int32 numpy arrays by leaf name."""
    return {k: (v.to(torch.float32) if v.is_floating_point() else v).cpu().numpy()
            for k, v in cache.items()}


# --------------------------------------------------------------------- 1.
STEP_CASES = ("granite-8b", "h2o-danube-3-4b", "qwen2.5-32b", "deepseek-v2-lite-16b")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", STEP_CASES)
def test_attention_step_matches_jax(name, dtype):
    jcfg, cfg = _cfgs(name)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    layer = jax.tree.map(lambda a: np.asarray(a)[0], _np_tree(jinit(jax.random.PRNGKey(0), jcfg))
                         ["layers"]["attn"])
    if "bq" in layer:  # zeros at init: random here, so that the bias shows
        layer = {k: (rng.standard_normal(v.shape).astype(np.float32) if k[0] == "b" else v)
                 for k, v in layer.items()}
    x = np.asarray(jnp.asarray(rng.standard_normal((B, 1, jcfg.d_model)), jdt))
    pos = START + 2
    hd = cfg.head_dim
    if cfg.kv_lora:
        shapes = {"c_kv": (B, S, cfg.kv_lora), "k_r": (B, S, 64), "kv_pos": (B, S)}
    else:
        shapes = {"k": (B, S, cfg.n_kv_heads, hd), "v": (B, S, cfg.n_kv_heads, hd),
                  "kv_pos": (B, S)}
    cache = _random_cache(rng, shapes, jdt)
    jcache = jax.tree.map(jnp.asarray, cache)
    if cfg.kv_lora:
        want, wcache = jmla.mla_decode(layer, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                       jcache, Axes(), n_heads_local=cfg.n_heads, head_dim=hd)
        got, gcache = mla_decode(params_from_jax(layer, "cpu"), _t(x),
                                 torch.from_numpy(np.array(pos)), cache_from_jax(cache, "cpu"),
                                 n_heads=cfg.n_heads, head_dim=hd)
    else:
        layout = resolve_dims(jcfg, 1, 1).layout
        want, wcache = jattn.attention_decode(
            layer, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jcache, Axes(), layout,
            window=jcfg.window, rope_theta=jcfg.rope_theta)
        got, gcache = attention_decode(
            params_from_jax(layer, "cpu"), _t(x), torch.from_numpy(pos),
            cache_from_jax(cache, "cpu"), n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=hd, rope_theta=cfg.rope_theta, window=cfg.window)
    assert got.dtype == tdt
    _close(got.float(), want, dtype, f"{name} out")
    for k, v in cache_to_numpy(gcache).items():
        _close(v, _flat(wcache)[k], dtype, f"{name} cache {k}")


def _t(a):
    """A numpy array (bf16 through float32, exactly) as a CPU tensor."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- 2.
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_lm_decode_step_matches_jax(name, dtype):
    jcfg, cfg = _cfgs(name)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np_tree(jparams), "cpu")
    shapes = {k: tuple(v.shape) for k, v in
              _flat(_np_tree(jdecode.init_lm_cache(jcfg, 1, 1, B, S, jdt))["layers"]).items()}
    jcache = {"layers": _random_cache(rng, shapes, jdt)}
    jstep = partial(jdecode.lm_decode_step, axes=Axes(), cfg=jcfg, dtype=jdt)
    if dtype == "float32":
        jstep = jax.jit(jstep)
    for i in range(3):
        tokens = rng.integers(0, jcfg.vocab, B).astype(np.int32)
        pos = (START + i).astype(np.int32)
        cache = cache_from_jax(_np_tree(jcache), "cpu")
        got, cache = lm_decode_step(params, cache, torch.from_numpy(tokens).long(),
                                    torch.from_numpy(pos), cfg, dtype=tdt)
        with jax.disable_jit(dtype == "bfloat16"):
            want, jcache = jstep(jparams, jax.tree.map(jnp.asarray, jcache), jnp.asarray(tokens),
                                 jnp.asarray(pos))
        assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
        _close(got, want, dtype, f"{name} step {i} logits")
        wflat = _flat(_np_tree(jcache))
        assert sorted(cache) == sorted(wflat)
        for k, v in cache_to_numpy(cache).items():
            _close(v, wflat[k], dtype, f"{name} step {i} cache {k}")


# --------------------------------------------------------------------- 3.
@pytest.mark.parametrize("name,batch,seq", [("granite-8b", 2, 16), ("h2o-danube-3-4b", 1, 80),
                                            ("deepseek-v2-lite-16b", 1, 8)])
def test_train_equals_decode(name, batch, seq):
    cfg = dataclasses.replace(smoke_config(get_arch(name)), n_layers=2)
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=torch.Generator().manual_seed(4))
    want = lm_logits(params, lm_forward(params, {"tokens": tokens}, cfg, torch.float32), cfg)
    cache = init_lm_cache(cfg, batch, seq, device="cpu", dtype=torch.float32)
    got = []
    for t in range(seq):
        logits, cache = lm_decode_step(params, cache, tokens[:, t],
                                       torch.full((batch,), t), cfg, dtype=torch.float32)
        got.append(logits)
    _close(torch.stack(got, 1).numpy(), want.detach().numpy(), "float32", name)


# --------------------------------------------------------------------- 4.
@pytest.mark.parametrize("tokens", [1, 2, 4, 8])
def test_moe_decode_drops_nothing_at_8_slots(tokens):
    """Every token on the same top-k experts (the worst case for capacity)
    still fits: capacity(N, k, E) >= 8 and an expert gets at most one pick
    per token."""
    for name in ("mixtral-8x22b", "deepseek-v2-lite-16b"):
        for cfg in (smoke_config(get_arch(name)), get_arch(name)):
            ids = torch.arange(cfg.top_k).expand(tokens, cfg.top_k)
            _, _, keep = dispatch_indices(ids, cfg.n_experts,
                                          capacity(tokens, cfg.top_k, cfg.n_experts))
            assert bool(keep.all()), (name, cfg.n_experts, tokens)
    cfg = smoke_config(get_arch("mixtral-8x22b"))
    ids = torch.zeros((9, cfg.top_k), dtype=torch.long) + torch.arange(cfg.top_k)
    _, _, keep = dispatch_indices(ids, cfg.n_experts, capacity(9, cfg.top_k, cfg.n_experts))
    assert not bool(keep.all())  # past 8 tokens an expert can overflow


def test_moe_decode_batch_equals_alone():
    """A slot's logits do not depend on its companions (nothing dropped)."""
    cfg = dataclasses.replace(smoke_config(get_arch("mixtral-8x22b")), n_layers=2)
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    tokens = torch.tensor([5, 5, 5, 5, 5, 5, 5, 9])
    pos = torch.zeros(8, dtype=torch.long)
    cache = init_lm_cache(cfg, 8, 4, device="cpu", dtype=torch.float32)
    batch, _ = lm_decode_step(params, cache, tokens, pos, cfg, dtype=torch.float32)
    alone, _ = lm_decode_step(params, init_lm_cache(cfg, 1, 4, device="cpu",
                                                    dtype=torch.float32),
                              tokens[7:], pos[7:], cfg, dtype=torch.float32)
    _close(batch[7:].numpy(), alone.numpy(), "float32", "slot 7")


# --------------------------------------------------------------------- 5.
@pytest.mark.parametrize("name", ["seamless-m4t-medium"])
def test_unported_decode_raises(name):
    cfg = smoke_config(get_arch(name))
    with pytest.raises(ValueError):  # as JAX's init_lm_cache
        jdecode.init_lm_cache(jsmoke(jget_arch(name)), 1, 1, 2, 8)
    with pytest.raises(ValueError, match="init_encdec_cache"):
        init_lm_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="init_encdec_cache"):
        lm_decode_step({}, {}, torch.zeros(2, dtype=torch.long), torch.zeros(2), cfg)
