"""Port vs JAX: the Mamba2 (SSD) block of ``repro_torch/models/ssm.py``
against ``repro/models/ssm.py`` on the same numpy-seeded inputs.

``_causal_conv`` in float32 and bf16; one ``_ssd_chunk`` from a nonzero
incoming state; ``mamba2_train`` at chunk 8 over T = 32 (four chunks, so
the state carries across three chunk boundaries) and at T <= chunk (one
chunk), its output and the gradients for x and every leaf. Cumulative sums
and softplus differ from XLA's by an ULP here and there, so the floats are
held to rtol 1e-4, atol 1e-5, as the model tests hold them; the gradients
of a random cotangent reach |g| ~ 50, so their atol is 1e-5 of the leaf's
largest |g| (a sum of such terms that cancels to near zero keeps their
rounding). Non-default ``dt_bias``, ``a_log`` and ``d_skip`` come from the
seed (the defaults would leave A = -1 and D = 1 for every head).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
D, H, P, N = 64, 2, 64, 16  # the hybrid smoke config's widths


def _params(seed, dt_bias=-4.0):
    """``init_mamba2_params`` from ``seed``, with per-head dt_bias around
    ``dt_bias``, a_log and d_skip drawn from the seed too."""
    rng = np.random.default_rng(seed + 1000)
    p = jssm.init_mamba2_params(jax.random.PRNGKey(seed), D, H, P, N)
    return dict(
        p,
        dt_bias=jnp.asarray(dt_bias + rng.uniform(-1, 1, (H,)), jnp.float32),
        a_log=jnp.asarray(rng.normal(size=(H,)) * 0.5, jnp.float32),
        d_skip=jnp.asarray(rng.normal(size=(H,)), jnp.float32),
    )


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a, np.float32))
    return out if dtype is None else out.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 40)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (ssm.CONV_K, 40)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jssm._causal_conv(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd))
    got = ssm._causal_conv(_t(x, td), _t(w, td))
    assert got.dtype == td and got.shape == want.shape
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:  # products and sums rounded to bf16 in the same order: bit-equal
        np.testing.assert_array_equal(got.float().numpy(), want)
    # causal: the first output reads only x[0] (the padding is zeros); the
    # SiLU of a short row may take another vector path, hence the tolerance
    first = ssm._causal_conv(_t(x[:, :1]), _t(w))
    np.testing.assert_allclose(first.numpy(), ssm._causal_conv(_t(x), _t(w))[:, :1].numpy(),
                               **TOL)


def test_ssd_chunk_from_a_nonzero_state_matches_jax():
    rng = np.random.default_rng(5)
    b, q = 2, 16
    x = rng.standard_normal((b, q, H, P)).astype(np.float32)
    dt = rng.uniform(0.005, 0.1, (b, q, H)).astype(np.float32)
    bc = rng.standard_normal((b, q, 2 * N)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    h_in = rng.standard_normal((b, H, N, P)).astype(np.float32)
    jh, jy = jssm._ssd_chunk(jnp.asarray(h_in), tuple(jnp.asarray(v) for v in (x, dt, bc, a)))
    h, y = ssm._ssd_chunk(_t(h_in), (_t(x), _t(dt), _t(bc), _t(a)))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    # the incoming state reaches both outputs
    h0, y0 = ssm._ssd_chunk(torch.zeros_like(_t(h_in)), (_t(x), _t(dt), _t(bc), _t(a)))
    assert not torch.allclose(h0, h) and not torch.allclose(y0, y)


@functools.lru_cache(maxsize=None)
def _jax_mamba(chunk):
    """JAX's output and its gradients for (params, x) under cotangent
    ``cot``, jitted once per chunk size (and input shape)."""

    def f(p, xx, cot):
        y = jssm.mamba2_train(p, xx, Axes(), n_heads_local=H, head_dim=P, d_state=N,
                              chunk=chunk)
        return jnp.sum(y * cot), y

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def _close_grad(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(scale, 1.0),
                               err_msg=name)


def _mamba_vs_jax(seed, t, chunk, dt_bias=-4.0):
    jp = _params(seed, dt_bias)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    cot = rng.standard_normal((2, t, D)).astype(np.float32)
    (_, jy), (jgp, jgx) = _jax_mamba(chunk)(jp, jnp.asarray(x), jnp.asarray(cot))
    p = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    xx = _t(x).requires_grad_(True)
    y = ssm.mamba2_train(p, xx, n_heads=H, head_dim=P, d_state=N, chunk=chunk)
    grads = torch.autograd.grad((y * _t(cot)).sum(), [xx, *p.values()])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    _close_grad(grads[0].numpy(), np.asarray(jgx), "x")
    assert set(p) == set(jgp)
    for k, g in zip(p, grads[1:]):
        _close_grad(g.numpy(), np.asarray(jgp[k]), k)
        assert bool(g.abs().max() > 0), k


@pytest.mark.parametrize("t,chunk", [(32, 8), (16, 256), (8, 8)])
def test_mamba2_train_and_its_gradients_match_jax(t, chunk):
    _mamba_vs_jax(0, t, chunk)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), t=st.sampled_from([8, 16, 32]),
       dt_bias=st.floats(-6.0, -2.0))
def test_mamba2_train_matches_jax_over_seeds_lengths_and_dt_bias(seed, t, dt_bias):
    _mamba_vs_jax(seed, t, 8, dt_bias)


def test_mamba2_train_asserts_whole_chunks():
    p = {k: _t(v) for k, v in _params(0).items()}
    with pytest.raises(AssertionError):
        ssm.mamba2_train(p, torch.zeros(1, 12, D), n_heads=H, head_dim=P, d_state=N, chunk=8)


def test_chunking_does_not_change_the_output():
    """The same sequence in chunks of 8, 16 and 32 (one): the carried state
    stands in for the earlier chunks."""
    p = {k: _t(v) for k, v in _params(2).items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 32, D)).astype(np.float32))
    outs = [ssm.mamba2_train(p, x, n_heads=H, head_dim=P, d_state=N, chunk=c)
            for c in (8, 16, 32)]
    for o in outs[:2]:
        torch.testing.assert_close(o, outs[2], rtol=1e-4, atol=1e-5)
