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

The gradients of ``dt_bias``, ``a_log`` and ``d_skip`` are one number a
head, each a float32 sum over the B·T·P = 2·32·64 = 4,096 (b, t, p) terms
of that head (``d_skip``'s is Σ ∂y·xh; the other two reach the sum through
the SSD). Summed in float32, such a sum carries a rounding of order
2^-24·√n·Σ|term|, which is set by the terms' magnitude, not by the
value's: where the terms cancel to a value small next to Σ|term|, the two
packages' float32 sums may differ by more than rtol 1e-4 of the value
while both are right. The seed 36623, T = 32, dt_bias -5.2985 is such a
draw: head 0's ``d_skip`` gradient is -0.13386509 in the port and
-0.13383579 in JAX (2.93e-5 apart, 1.3e-5 allowed), and the float64
evaluation below gives -0.13385682, 8.3e-6 from the port and 2.1e-5 from
JAX. So each of these three leaves is held, head by head, either to JAX
within the tolerance above or, where the two packages differ by more, to
the float64 value: the port no farther from it than JAX is, plus two
float32 ULPs of that value (:func:`_close_sum_grad`). The float64 value
comes from :func:`_mamba_f64`, the block written out as its sequential
recurrence h_t = exp(A·dt_t) h_{t-1} + dt_t B_t ⊗ x_t, y_t = C_t·h_t
(no chunks), independent of both packages' chunked forms. Every other
leaf, x and the output keep the tolerance above.

The hypothesis tests here run derandomized: every run draws the same
cases, so the count of passes does not swing from run to run.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from hypothesis import example, given, settings, strategies as st  # noqa: E402

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


# the per-head leaves whose gradient is a float32 sum over B·T·P terms
SUM_LEAVES = ("a_log", "d_skip", "dt_bias")


def _close_sum_grad(got, want, exact, name):
    """A per-head sum leaf (the module docstring): each head within
    :func:`_close_grad`'s tolerance of JAX, or else the port no farther
    from the float64 value ``exact`` than JAX is, plus two float32 ULPs
    of it."""
    scale = float(np.abs(want).max())
    near_jax = np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 * max(scale, 1.0)
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    closer = np.abs(got - exact) <= np.abs(want.astype(np.float64) - exact) + 2 * ulp
    assert bool(np.all(near_jax | closer)), (
        f"{name}: port {got}, JAX {want}, float64 {exact}")


def _mamba_f64(p, x):
    """``mamba2_train``'s arithmetic in float64 as the sequential
    recurrence (no chunks): p and x float64 tensors, x (B, T, D)."""
    b, t, _ = x.shape
    xin, z = torch.chunk(x @ p["w_xz"], 2, dim=-1)
    bc = x @ p["w_bc"]
    dt = torch.logaddexp(x @ p["w_dt"] + p["dt_bias"], torch.zeros((), dtype=x.dtype))
    k = p["conv_w"].shape[0]
    xp = F.pad(xin, (0, 0, k - 1, 0))
    xh = F.silu(sum(xp[:, i:i + t] * p["conv_w"][i] for i in range(k))).reshape(b, t, H, P)
    a = -torch.exp(p["a_log"])
    h, ys = x.new_zeros(b, H, N, P), []
    for i in range(t):
        h = (torch.exp(a * dt[:, i])[..., None, None] * h
             + torch.einsum("bh,bn,bhp->bhnp", dt[:, i], bc[:, i, :N], xh[:, i]))
        ys.append(torch.einsum("bn,bhnp->bhp", bc[:, i, N:], h))
    y = torch.stack(ys, 1) + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(b, t, H * P) * F.silu(z)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6) * p["norm_w"]
    return y @ p["w_out"]


def _exact_sum_grads(jp, x, cot):
    """The float64 gradients of the :data:`SUM_LEAVES` under ``cot``."""
    p = {k: torch.from_numpy(np.array(v, np.float64)).requires_grad_(k in SUM_LEAVES)
         for k, v in jp.items()}
    y = _mamba_f64(p, torch.from_numpy(x.astype(np.float64)))
    grads = torch.autograd.grad((y * torch.from_numpy(cot.astype(np.float64))).sum(),
                                [p[k] for k in SUM_LEAVES])
    return {k: g.numpy() for k, g in zip(SUM_LEAVES, grads)}


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
    exact = _exact_sum_grads(jp, x, cot)
    for k, g in zip(p, grads[1:]):
        if k in SUM_LEAVES:
            _close_sum_grad(g.numpy(), np.asarray(jgp[k]), exact[k], k)
        else:
            _close_grad(g.numpy(), np.asarray(jgp[k]), k)
        assert bool(g.abs().max() > 0), k


@pytest.mark.parametrize("t,chunk", [(32, 8), (16, 256), (8, 8)])
def test_mamba2_train_and_its_gradients_match_jax(t, chunk):
    _mamba_vs_jax(0, t, chunk)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**16), t=st.sampled_from([8, 16, 32]),
       dt_bias=st.floats(-6.0, -2.0))
@example(seed=36623, t=32, dt_bias=-5.298459043802353)  # a cancelling d_skip sum
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
