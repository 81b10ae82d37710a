"""Port vs JAX: the recurrent decode of the hybrid (Mamba2) and ssm (xLSTM)
families (``mamba2_decode``, ``mlstm_decode``, ``slstm_decode``, their
caches, and their branches of ``models/decode.py``).

1. Train == decode on the port (the JAX package's
   ``tests/test_recurrent_equivalence.py`` cases for Mamba2, mLSTM and
   sLSTM, port against port): stepping the decode over T = 32 tokens from
   a zero state gives the chunked train path's output at every position,
   at the reference test's atol 5e-5, rtol 1e-4.
2. One step of each of ``mamba2_decode``, ``mlstm_decode`` and
   ``slstm_decode`` against JAX's from the same weights, input and a
   random nonzero state, float32 and bf16 (bf16 weights and input); the
   output and the new state are compared.
3. ``lm_decode_step`` of the zamba2-2.7b and xlstm-125m smoke configs
   against JAX's over three steps from a random cache (Mamba2 and xLSTM
   states random; the shared block's KV cache random and partly filled,
   one row empty), JAX's cache handed to the port before each step
   (``cache_from_jax``), the logits and the whole new cache compared.
4. The JAX package's ``test_arch_decode_step`` for both configs on the
   port: one step from an empty cache gives finite logits, a greedy token
   in the vocabulary, and a changed cache.

Tolerances: ``test_torch_decode.py``'s. Float32 at rtol 1e-5 with atol
1e-5 of the largest |value| (the two packages sum products in different
orders); bf16 within 2 bf16 ULPs of the largest |value|, the JAX step run
un-jitted (jitted, XLA keeps fused bf16 intermediates in float32). The
states are float32 in both types; in bf16 they are held to the bf16
tolerance, as they are computed from bf16 projections whose rounding may
differ by an ULP. Integers (``kv_pos``) bit for bit.
"""
import dataclasses
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro.models.transformer import init_lm_params as jinit  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.models import ssm, xlstm  # noqa: E402
from repro_torch.models.decode import (  # noqa: E402
    cache_from_jax, init_lm_cache, lm_decode_step, tp_greedy,
)
from repro_torch.models.transformer import init_lm_params, params_from_jax  # noqa: E402
from test_torch_decode import (  # noqa: E402
    DTYPES, _close, _flat, _np_tree, _random_cache, _t, cache_to_numpy,
)

AXES = Axes()
B, T, D = 2, 32, 24  # test_recurrent_equivalence.py's shapes
H, P, N = 2, 8, 16
RECURRENT_ARCHS = ("zamba2-2.7b", "xlstm-125m")


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------- 1.
def _port(jparams):
    return params_from_jax(_np_tree(jparams), "cpu")


def _train_vs_decode(train, step, cache):
    """``train`` (B, T, D) -> (B, T, D) against ``step`` over each token."""
    x = torch.from_numpy(_x(1, (B, T, D)))
    want = train(x)
    got = []
    for t in range(T):
        y, cache = step(x[:, t:t + 1], cache)
        got.append(y)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.detach().numpy(),
                               atol=5e-5, rtol=1e-4)


def test_mamba2_train_equals_decode():
    p = _port(jssm.init_mamba2_params(jax.random.PRNGKey(0), D, H, P, N))
    kw = dict(n_heads=H, head_dim=P, d_state=N)
    _train_vs_decode(lambda x: ssm.mamba2_train(p, x, chunk=8, **kw),
                     lambda x, c: ssm.mamba2_decode(p, x, c, **kw),
                     ssm.init_mamba2_cache(B, device="cpu", **kw))


def test_mlstm_train_equals_decode():
    p = _port(jxlstm.init_mlstm_params(jax.random.PRNGKey(0), D, H, P))
    kw = dict(n_heads=H, head_dim=P)
    _train_vs_decode(lambda x: xlstm.mlstm_train(p, x, chunk=8, **kw),
                     lambda x, c: xlstm.mlstm_decode(p, x, c, **kw),
                     xlstm.init_mlstm_cache(B, device="cpu", **kw))


def test_slstm_train_equals_decode():
    p = _port(jxlstm.init_slstm_params(jax.random.PRNGKey(0), D, H, P))
    kw = dict(n_heads=H, head_dim=P)
    _train_vs_decode(lambda x: xlstm.slstm_train(p, x, **kw),
                     lambda x, c: xlstm.slstm_decode(p, x, c, **kw),
                     xlstm.init_slstm_cache(B, device="cpu", **kw))


# --------------------------------------------------------------------- 2.
def _step_case(name, seed):
    """(JAX params, JAX step, port step, random state shapes) of one cell."""
    key = jax.random.PRNGKey(seed)
    if name == "mamba2":
        kw = dict(n_heads_local=H, head_dim=P, d_state=N)
        return (jssm.init_mamba2_params(key, D, H, P, N), partial(jssm.mamba2_decode, **kw),
                partial(ssm.mamba2_decode, n_heads=H, head_dim=P, d_state=N),
                {"conv": (B, ssm.CONV_K - 1, H * P), "h": (B, H, N, P)})
    kw = dict(n_heads_local=H, head_dim=P)
    if name == "mlstm":
        return (jxlstm.init_mlstm_params(key, D, H, P), partial(jxlstm.mlstm_decode, **kw),
                partial(xlstm.mlstm_decode, n_heads=H, head_dim=P),
                {"C": (B, H, P, P), "n": (B, H, P)})
    return (jxlstm.init_slstm_params(key, D, H, P), partial(jxlstm.slstm_decode, **kw),
            partial(xlstm.slstm_decode, n_heads=H, head_dim=P),
            {"h": (B, H, P), "c": (B, H, P)})


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["mamba2", "mlstm", "slstm"])
def test_decode_step_from_a_nonzero_state_matches_jax(name, dtype):
    jdt, tdt = DTYPES[dtype]
    jp, jstep, step, shapes = _step_case(name, 3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), jp)
    rng = np.random.default_rng(7)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, 1, D)), jdt))
    state = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    with jax.disable_jit(dtype == "bfloat16"):
        want, wstate = jstep(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, state), AXES)
    cache = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    got, gstate = step(_port(jp), _t(x), cache)
    # the state is written in place, into the tensors handed in
    assert gstate is cache and {k: v.data_ptr() for k, v in gstate.items()} == ptrs
    assert got.dtype == tdt and got.shape == (B, 1, D)
    _close(got.float(), want, dtype, f"{name} out")
    assert sorted(gstate) == sorted(wstate)
    for k, v in gstate.items():
        assert v.dtype == torch.float32, k
        _close(v.numpy(), wstate[k], dtype, f"{name} state {k}")
    assert all(not np.array_equal(v.numpy(), state[k]) for k, v in gstate.items())  # it moved


def test_mamba2_decode_conv_buffer_in_bf16_matches_jax():
    """A bf16 conv buffer (``init_mamba2_cache(dtype=bf16)``): the taps'
    products round to bf16 and their sum runs in float32 (``jnp.sum``'s
    upcast), then rounds to bf16; the new buffer stays bf16."""
    jp, jstep, step, shapes = _step_case("mamba2", 4)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    rng = np.random.default_rng(8)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, 1, D)), jnp.bfloat16))
    conv = np.asarray(jnp.asarray(rng.standard_normal(shapes["conv"]), jnp.bfloat16))
    h = rng.standard_normal(shapes["h"]).astype(np.float32)
    with jax.disable_jit():
        want, wstate = jstep(jp, jnp.asarray(x), {"conv": jnp.asarray(conv), "h": jnp.asarray(h)},
                             AXES)
    got, gstate = step(_port(jp), _t(x),
                       {"conv": _t(conv), "h": torch.from_numpy(h.copy())})
    assert gstate["conv"].dtype == torch.bfloat16
    _close(got.float(), want, "bfloat16", "out")
    _close(gstate["conv"].float().numpy(), wstate["conv"], "bfloat16", "conv")
    _close(gstate["h"].numpy(), wstate["h"], "bfloat16", "h")


# --------------------------------------------------------------------- 3.
def _cfgs(name):
    return jsmoke(jget_arch(name)), smoke_config(get_arch(name))


S = 16
START = np.array([0, 5, 12])  # the shared block's cache rows: empty, short, longer


def _random_lm_cache(jcfg, rng, jdt):
    """JAX's cache tree for B = 3 sequences of S, in JAX's types: random
    states and KV entries, ``kv_pos`` filled below START[b]."""
    tree = _np_tree(jdecode.init_lm_cache(jcfg, 1, 1, len(START), S, jdt))
    out = {}
    for group, leaves in tree.items():
        if group == "attn":
            shapes = {k: v.shape for k, v in leaves.items()}
            out[group] = _random_cache(rng, shapes, jdt, start=START)
        else:
            out[group] = jax.tree.map(
                lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape) * 0.5, a.dtype)),
                leaves)
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", RECURRENT_ARCHS)
def test_lm_decode_step_matches_jax(name, dtype):
    jcfg, cfg = _cfgs(name)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(13)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np_tree(jparams), "cpu")
    jcache = _random_lm_cache(jcfg, rng, jdt)
    jstep = partial(jdecode.lm_decode_step, axes=AXES, cfg=jcfg, dtype=jdt)
    if dtype == "float32":
        jstep = jax.jit(jstep)
    for i in range(3):
        tokens = rng.integers(0, jcfg.vocab, len(START)).astype(np.int32)
        pos = (START + i).astype(np.int32)
        cache = cache_from_jax(jcache, "cpu")
        got, cache = lm_decode_step(params, cache, torch.from_numpy(tokens).long(),
                                    torch.from_numpy(pos), cfg, dtype=tdt)
        with jax.disable_jit(dtype == "bfloat16"):
            want, jcache = jstep(jparams, jax.tree.map(jnp.asarray, jcache), jnp.asarray(tokens),
                                 jnp.asarray(pos))
        jcache = _np_tree(jcache)
        assert got.dtype == torch.float32 and got.shape == (len(START), cfg.vocab)
        _close(got, want, dtype, f"{name} step {i} logits")
        wflat = _flat(jcache)
        assert sorted(cache) == sorted(wflat)
        for k, v in cache_to_numpy(cache).items():
            _close(v, wflat[k], dtype, f"{name} step {i} cache {k}")


@pytest.mark.parametrize("name", RECURRENT_ARCHS)
def test_init_lm_cache_matches_jax(name):
    """The port's empty cache has JAX's leaves, shapes, types and values."""
    jcfg, cfg = _cfgs(name)
    want = _flat(_np_tree(jdecode.init_lm_cache(jcfg, 1, 1, 3, S, jnp.bfloat16)))
    got = init_lm_cache(cfg, 3, S, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == want[k].dtype.name, k
        np.testing.assert_array_equal(cache_to_numpy({k: v})[k], want[k].astype(
            np.float32 if want[k].dtype.name == "bfloat16" else want[k].dtype), err_msg=k)


# --------------------------------------------------------------------- 4.
@pytest.mark.parametrize("name", RECURRENT_ARCHS)
def test_arch_decode_step(name):
    cfg = smoke_config(get_arch(name))
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tok = torch.randint(0, cfg.vocab, (2,), generator=torch.Generator().manual_seed(1))
    cache = init_lm_cache(cfg, 2, 8, device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    logits, cache2 = lm_decode_step(params, cache, tok, torch.zeros(2, dtype=torch.long), cfg)
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    nxt = tp_greedy(logits)
    assert bool(((nxt >= 0) & (nxt < cfg.vocab)).all())
    assert any(not torch.equal(before[k], v) for k, v in cache2.items())  # the cache advanced


def test_hybrid_decode_needs_whole_blocks():
    """A hybrid depth that is not a multiple of attn_every is refused by
    name, as the params are."""
    cfg = dataclasses.replace(smoke_config(get_arch("zamba2-2.7b")), n_layers=3)
    with pytest.raises(ValueError, match="attn_every"):
        init_lm_cache(cfg, 1, 4, device="cpu")
