"""Port vs JAX: the Int operator and the scalar-lane encode/decode
(``core/rounding.py``).

``deterministic_round``, ``clip_for_wire``, ``encode(stochastic=False)``
and ``decode`` are bit-equal to the JAX package's on the same inputs.
``stochastic_round`` draws from a ``torch.Generator``, whose bits are not
``jax.random``'s, so it is held to Lemma 1 as ``tests/test_rounding.py``
holds JAX's: unbiased, |Int(t) − t| < 1, variance frac·(1 − frac) ≤ 1/4,
integers fixed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rounding as jr  # noqa: E402
from repro_torch.core import rounding  # noqa: E402


def _x(seed, n=5000, scale=300.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    x[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, 0.49, 0.51, -2.5]
    return x


def test_deterministic_round_matches_jax():
    x = _x(0)
    got = rounding.deterministic_round(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jr.deterministic_round(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:8].numpy(), [0.0, 2.0, 2.0, -0.0, -2.0, 0.0, 1.0, -2.0])


@pytest.mark.parametrize("bits,n", [(8, 16), (16, 64), (32, 1000), (32, 1), (4, 3)])
def test_clip_for_wire_matches_jax(bits, n):
    lim = rounding.INT_LIM[bits] // n
    x = np.concatenate([_x(bits, 2000, scale=3.0 * lim), [10.0 * lim, -10.0 * lim]]).astype(np.float32)
    got = rounding.clip_for_wire(torch.from_numpy(x), n_workers=n, bits=bits)
    want = jr.clip_for_wire(jnp.asarray(x), n_workers=n, bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.abs().max()) * n <= rounding.INT_LIM[bits] or (bits, n) == (32, 1)
    with pytest.raises(rounding.WireRangeError):
        rounding.clip_for_wire(torch.from_numpy(x), n_workers=256, bits=8)


@pytest.mark.parametrize("bits,n", [(8, 4), (16, 8), (32, 4), (32, 1), (4, 2)])
@pytest.mark.parametrize("alpha", [0.37, 23.7, 1e6])
def test_encode_decode_deterministic_match_jax(bits, n, alpha):
    x = _x([bits, n], scale=1.0)
    got = rounding.encode(torch.from_numpy(x), torch.tensor(np.float32(alpha)), None,
                          n_workers=n, bits=bits, stochastic=False)
    want = jr.encode(jnp.asarray(x), jnp.float32(alpha), None, n_workers=n, bits=bits,
                     stochastic=False)
    assert got.dtype == rounding.wire_dtype(bits)
    assert str(got.dtype).split(".")[1] == str(np.asarray(want).dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    summed = (got.to(torch.int64) * n).to(torch.int32)
    back = rounding.decode(summed, torch.tensor(np.float32(alpha)), n_workers=n)
    jback = jr.decode(jnp.asarray(summed.numpy()), jnp.float32(alpha), n_workers=n)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_stochastic_round_needs_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        rounding.int_round(torch.zeros(3), None, stochastic=True)


@pytest.mark.parametrize("t", [-1e5 + 0.3, -2.75, -0.5, 0.1, 0.5, 3.9, 12345.625])
def test_stochastic_round_unbiased_and_bounded(t):
    n = 20000
    x = torch.full((n,), t, dtype=torch.float32)
    r = rounding.stochastic_round(x, torch.Generator().manual_seed(7))
    assert r.dtype == torch.float32
    assert bool(((r - x).abs() < 1.0).all()) and bool((r == torch.round(r)).all())
    tf = float(np.float32(t))
    frac = tf - np.floor(tf)
    se = np.sqrt(max(frac * (1 - frac), 1e-12) / n)
    assert abs(float(r.double().mean()) - tf) <= max(6 * se, 1e-3 * max(abs(tf), 1.0))


def test_stochastic_round_variance_bound():
    gen = torch.Generator().manual_seed(0)
    for frac in [0.1, 0.25, 0.5, 0.75, 0.9]:
        x = torch.full((20000,), 3.0 + frac, dtype=torch.float32)
        var = float(torch.mean(torch.square(rounding.stochastic_round(x, gen) - x)))
        assert var <= 0.25 + 0.02, (frac, var)
        assert abs(var - frac * (1 - frac)) < 0.02
    ints = torch.arange(-50, 50, dtype=torch.float32)
    assert torch.equal(rounding.stochastic_round(ints, gen), ints)
