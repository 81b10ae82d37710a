"""Port vs JAX: the counter PRNG and the encode kernel's plain version.

The same inputs, made with numpy, go through the JAX package's Pallas
kernel (interpret mode on the CPU, via ``kernels.ops.int_compress``) and the
port's kernel wrapper, which runs its plain PyTorch version for CPU
tensors. Integer outputs must be bit-equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as kops  # noqa: E402
from repro.kernels import prng as jprng  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402
from repro_torch.kernels.int_compress import clip_limit  # noqa: E402

SHAPES = [(7,), (128,), (1000,), (8, 128), (300, 700), (3, 5, 7), (2, 3, 4, 5)]


@pytest.mark.parametrize("n", [1, 4097, 2**16])
def test_uniform_from_counter_matches_jax(n):
    rng = np.random.default_rng(n)
    counter = rng.integers(0, 2**32, n, dtype=np.uint32)
    seed = np.int32(rng.integers(-(2**31), 2**31))
    want = np.asarray(jprng.uniform_from_counter(jnp.asarray(counter), jnp.int32(seed)))
    got = prng.uniform_from_counter(
        torch.from_numpy(counter.astype(np.int64)), torch.tensor(seed)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    fm = np.asarray(jprng.fmix32(jnp.asarray(counter)))
    np.testing.assert_array_equal(
        prng.fmix32(torch.from_numpy(counter.astype(np.int64))).numpy(),
        fm.astype(np.int64),
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("stochastic", [True, False])
def test_int_compress_matches_jax(shape, bits, n, stochastic):
    rng = np.random.default_rng([*shape, bits, n])
    x = (rng.standard_normal(shape) * 5.0).astype(np.float32)
    alpha = np.float32(23.7)
    key = jax.random.PRNGKey(int(rng.integers(0, 2**31)))
    want = kops.int_compress(
        jnp.asarray(x), jnp.float32(alpha), key, n_workers=n, bits=bits,
        stochastic=stochastic,
    )
    seed = np.asarray(kops.seed_from_key(key))
    got = ops.int_compress(
        torch.from_numpy(x), torch.tensor(alpha), torch.tensor(seed),
        n_workers=n, bits=bits, stochastic=stochastic,
    )
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy()).max() <= clip_limit(bits, n)


@pytest.mark.parametrize("stochastic", [True, False])
def test_int_compress_int32_edge_pinned_to_jax(stochastic):
    # bits=32, n=1: lim = 2^31-1 rounds up to 2^31 in the f32 clip; XLA's
    # f32 -> s32 convert saturates it to 2^31-1 and maps NaN to 0
    x = np.array([3e9, -3e9, 2147483647.0, 1e10, np.nan, 2.5, -0.5, -2.5],
                 np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(kops.int_compress(
        jnp.asarray(x), jnp.float32(1.0), key, n_workers=1, bits=32,
        stochastic=stochastic,
    ))
    assert want[:5].tolist() == [2147483647, -2147483648, 2147483647, 2147483647, 0]
    got = ops.int_compress(
        torch.from_numpy(x), torch.tensor(1.0),
        torch.tensor(np.asarray(kops.seed_from_key(key))),
        n_workers=1, bits=32, stochastic=stochastic,
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_compress_cpu_runs_the_plain_version_and_counts_nothing():
    before = ops.int_compress.launches
    ops.int_compress(torch.ones(5), torch.tensor(1.0), torch.tensor(0, dtype=torch.int32),
                     n_workers=1, bits=8)
    assert ops.int_compress.launches == before


def test_clip_limit_degenerate_raises():
    with pytest.raises(ValueError, match="degenerates"):
        clip_limit(4, 8)


@pytest.mark.parametrize("bits,n", [(8, 4), (32, 1), (4, 2)])
def test_int_compress_amax_is_the_image_abs_max_and_accumulates(bits, n):
    """``amax`` is raised to the image's largest |value| (as float32), the
    max_local_int the JAX package takes as ``tree_abs_max`` of the image;
    a second call raises it only if its image goes higher."""
    rng = np.random.default_rng([bits, n, 3])
    x = torch.from_numpy((rng.standard_normal(5000) * 5.0).astype(np.float32))
    alpha, seed = torch.tensor(np.float32(23.7)), torch.tensor(-5, dtype=torch.int32)
    amax = torch.zeros(())
    out = ops.int_compress(x, alpha, seed, n_workers=n, bits=bits, amax=amax)
    assert amax.dtype == torch.float32 and amax.item() == out.abs().max().item() > 0
    small = ops.int_compress(x * 1e-3, alpha, seed, n_workers=n, bits=bits, amax=amax)
    assert amax.item() == out.abs().max().item() > small.abs().max().item()
    with pytest.raises(ValueError, match="amax"):
        ops.int_compress(x, alpha, seed, n_workers=n, bits=bits,
                         amax=torch.zeros((), dtype=torch.int32))
