"""Port vs JAX: the encoder-decoder's decode half (``models/encdec.py``:
``init_encdec_cache``, ``encdec_prefill``, ``encdec_decode_step``) on the
seamless-m4t-medium smoke config (2 + 2 layers, d_model 64), from JAX's
weights (``params_from_jax``).

1. ``init_encdec_cache`` has JAX's leaves, shapes, types and values.
2. ``encdec_prefill`` from JAX's weights and the same frames (B = 3, 24
   frames): the cross-attention K, V and positions of every decoder layer,
   float32 and bf16.
3. Four ``encdec_decode_step`` calls against JAX's from a prefilled cache
   whose self-attention part is random and partly filled (one row empty),
   JAX's cache handed to the port before each step (``cache_from_jax``):
   the logits and the whole new cache, float32 and bf16.
4. A greedy loop of 8 tokens, each package on its own cache from the
   prefill (float32): the logits agree at every step, and the token
   streams are equal up to and including the first step at which a row's
   top-1 logit leads its top-2 by less than twice the tolerance (past it
   the picks may differ by rounding alone); with no such step, equal.
5. Decode == ``decode_states`` on the port (float32): stepping a token
   sequence gives the teacher-forced decoder's logits at every position.
6. The JAX package's ``test_arch_decode_step`` for seamless-m4t-medium on
   the port: finite logits, a greedy token in the vocabulary, the cache
   advanced.

Tolerances: ``test_torch_decode.py``'s. Float32 at rtol 1e-5 with atol
1e-5 of the largest |value|; bf16 within 2 bf16 ULPs of the largest
|value|, the JAX functions run un-jitted (jitted, XLA keeps fused bf16
intermediates in float32); integers bit for bit. Decode == decode_states
at 1e-5 of the largest |logit| (two float32 attention orders).
"""
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.decode import cache_from_jax, tp_greedy  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from test_torch_decode import (  # noqa: E402
    DTYPES, _close, _flat, _np_tree, _random_cache, cache_to_numpy,
)

ARCH = "seamless-m4t-medium"
AXES = Axes()
B, S, S_SRC = 3, 16, 24
START = np.array([0, 5, 12])  # the self-attention cache rows: empty, short, longer


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jsmoke(jget_arch(ARCH)), smoke_config(get_arch(ARCH))
    jparams = jencdec.init_encdec_params(jax.random.PRNGKey(0), jcfg)
    frames = np.random.default_rng(3).standard_normal((B, S_SRC, cfg.frontend_dim))
    return jcfg, cfg, jparams, params_from_jax(_np_tree(jparams), "cpu"), \
        frames.astype(np.float32)


def _jax_prefill(jcfg, jparams, frames, jdt):
    cache = jencdec.init_encdec_cache(jcfg, 1, 1, B, S, S_SRC, jdt)
    with jax.disable_jit(jdt == jnp.bfloat16):
        return _np_tree(jencdec.encdec_prefill(jparams, jnp.asarray(frames), cache, AXES, jcfg,
                                               jdt))


def _port_prefill(cfg, params, frames, tdt):
    cache = encdec.init_encdec_cache(cfg, B, S, S_SRC, device="cpu", dtype=tdt)
    return encdec.encdec_prefill(params, torch.from_numpy(frames), cache, cfg, tdt)


# --------------------------------------------------------------------- 1.
def test_init_encdec_cache_matches_jax(model):
    jcfg, cfg, _, _, _ = model
    want = _flat(_np_tree(jencdec.init_encdec_cache(jcfg, 1, 1, B, S, S_SRC, jnp.bfloat16)))
    got = encdec.init_encdec_cache(cfg, B, S, S_SRC, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == want[k].dtype.name, k
        np.testing.assert_array_equal(cache_to_numpy({k: v})[k], want[k].astype(
            np.float32 if want[k].dtype.name == "bfloat16" else want[k].dtype), err_msg=k)


# --------------------------------------------------------------------- 2.
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encdec_prefill_matches_jax(model, dtype):
    jcfg, cfg, jparams, params, frames = model
    jdt, tdt = DTYPES[dtype]
    want = _flat(_jax_prefill(jcfg, jparams, frames, jdt))
    got = cache_to_numpy(_port_prefill(cfg, params, frames, tdt))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k.startswith("self/"):  # kept empty
            np.testing.assert_array_equal(v, want[k].astype(v.dtype), err_msg=k)
        else:
            _close(v, want[k], dtype, k)


# --------------------------------------------------------------------- 3.
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encdec_decode_step_matches_jax(model, dtype):
    jcfg, cfg, jparams, params, frames = model
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(17)
    jcache = _jax_prefill(jcfg, jparams, frames, jdt)
    shapes = {k: v.shape for k, v in jcache["self"].items()}
    jcache["self"] = _random_cache(rng, shapes, jdt, start=START)
    jstep = partial(jencdec.encdec_decode_step, axes=AXES, cfg=jcfg, dtype=jdt)
    if dtype == "float32":
        jstep = jax.jit(jstep)
    for i in range(4):
        tokens = rng.integers(0, jcfg.vocab, B).astype(np.int32)
        pos = (START + i).astype(np.int32)
        cache = cache_from_jax(jcache, "cpu")
        got, cache = encdec.encdec_decode_step(params, cache, torch.from_numpy(tokens).long(),
                                               torch.from_numpy(pos), cfg, dtype=tdt)
        with jax.disable_jit(dtype == "bfloat16"):
            want, jcache = jstep(jparams, jax.tree.map(jnp.asarray, jcache), jnp.asarray(tokens),
                                 jnp.asarray(pos))
        jcache = _np_tree(jcache)
        assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
        _close(got, want, dtype, f"step {i} logits")
        wflat = _flat(jcache)
        assert sorted(cache) == sorted(wflat)
        for k, v in cache_to_numpy(cache).items():
            _close(v, wflat[k], dtype, f"step {i} cache {k}")


# --------------------------------------------------------------------- 4.
def test_greedy_loop_matches_jax(model):
    jcfg, cfg, jparams, params, frames = model
    jcache = _jax_prefill(jcfg, jparams, frames, jnp.float32)
    cache = _port_prefill(cfg, params, frames, torch.float32)
    jstep = jax.jit(partial(jencdec.encdec_decode_step, axes=AXES, cfg=jcfg, dtype=jnp.float32))
    jtok = tok = np.array([1, 2, 3], np.int32)
    jtoks, toks, first_tie = [], [], None
    for t in range(8):
        pos = np.full(B, t, np.int32)
        want, jcache = jstep(jparams, jcache, jnp.asarray(jtok), jnp.asarray(pos))
        got, cache = encdec.encdec_decode_step(params, cache, torch.from_numpy(tok).long(),
                                               torch.from_numpy(pos), cfg, dtype=torch.float32)
        want = np.asarray(want)
        if first_tie is None:  # the same inputs so far: the same logits
            _close(got, want, "float32", f"step {t}")
        tol = 1e-5 * float(np.abs(want).max())
        top2 = np.sort(want, axis=-1)[:, -2:]
        if first_tie is None and (top2[:, 1] - top2[:, 0]).min() < 2 * tol:
            first_tie = t
        jtok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        tok = tp_greedy(got).numpy().astype(np.int32)
        jtoks.append(jtok.tolist())
        toks.append(tok.tolist())
    last = 7 if first_tie is None else first_tie
    assert toks[:last + 1] == jtoks[:last + 1]


# --------------------------------------------------------------------- 5.
def test_decode_equals_decode_states(model):
    _, cfg, _, params, frames = model
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        enc_out = encdec.encode(params, torch.from_numpy(frames), cfg, torch.float32)
        h = encdec.decode_states(params, enc_out, tokens, cfg, torch.float32)
        want = (h @ params["lm_head"]).numpy()
        cache = _port_prefill(cfg, params, frames, torch.float32)
        got = []
        for t in range(S):
            logits, cache = encdec.encdec_decode_step(params, cache, tokens[:, t],
                                                      torch.full((B,), t), cfg,
                                                      dtype=torch.float32)
            got.append(logits)
    _close(torch.stack(got, 1).numpy(), want, "float32", "decode vs decode_states")


# --------------------------------------------------------------------- 6.
def test_arch_decode_step(model):
    _, cfg, _, params, _ = model
    frames = torch.randn(2, 16, cfg.frontend_dim, generator=torch.Generator().manual_seed(0))
    cache = encdec.init_encdec_cache(cfg, 2, 8, 16, device="cpu")
    cache = encdec.encdec_prefill(params, frames, cache, cfg)
    before = {k: v.clone() for k, v in cache.items()}
    tok = torch.randint(0, cfg.vocab, (2,), generator=torch.Generator().manual_seed(1))
    logits, cache2 = encdec.encdec_decode_step(params, cache, tok,
                                               torch.zeros(2, dtype=torch.long), cfg)
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    nxt = tp_greedy(logits)
    assert bool(((nxt >= 0) & (nxt < cfg.vocab)).all())
    assert any(not torch.equal(before[k], v) for k, v in cache2.items())  # the cache advanced
