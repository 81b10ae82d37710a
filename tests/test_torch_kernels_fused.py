"""Port vs JAX: the fused unpack + momentum-SGD kernel's plain version.

JAX side: ``kernels.ops.fused_unpack_apply(kernel="sgd")`` (Pallas,
interpret mode) on the same summed words, params, momentum and scalar
vector. Tolerance rtol=1e-6, atol=1e-7: the port rounds every product
(as its CUDA kernel, built with --fmad=false, does), while XLA may contract
a product and a sum into one FMA.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as kops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.int_compress import clip_limit  # noqa: E402

SHAPES = [(7,), (128,), (1000,), (8, 128), (300, 700), (3, 5, 7), (2, 3, 4, 5)]
TOL = dict(rtol=1e-6, atol=1e-7)


def _inputs(shape, bits, n):
    lim = clip_limit(bits, n)
    rng = np.random.default_rng([*shape, bits, n, 7])
    words = np.zeros(-(-int(np.prod(shape)) // (32 // bits)), np.int32)
    for _ in range(n):
        img = rng.integers(-lim, lim + 1, shape).astype(np.int32)
        words = words + np.asarray(kops.pack_words(jnp.asarray(img), bits=bits, n_workers=n))
    # the train path's magnitudes: weights ~0.02, momentum ~1e-3, decoded
    # gradients within ±0.02 (α ≈ lim / |g|), so one FMA contraction moves
    # a result by far less than the tolerance
    p = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    m = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    alpha = np.float32(lim * rng.uniform(50.0, 200.0))
    sc = np.array([1.0 / (n * alpha), 0.43, 0.3, 0.9, 1e-4], np.float32)
    return words, p, m, sc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 4])
def test_fused_unpack_sgd_matches_jax(shape, bits, n):
    words, p, m, sc = _inputs(shape, bits, n)
    wp, (wm,), _ = kops.fused_unpack_apply(
        jnp.asarray(words), jnp.asarray(p), (jnp.asarray(m),), jnp.asarray(sc),
        kernel="sgd", bits=bits, n_summed=n,
    )
    gp, gm = ops.fused_unpack_sgd(
        torch.from_numpy(words), torch.from_numpy(p), torch.from_numpy(m),
        torch.from_numpy(sc), bits=bits, n_summed=n,
    )
    assert tuple(gp.shape) == shape and gp.dtype == torch.float32
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), **TOL)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_unpack_update_oracle_matches_jax(shape):
    words, p, m, sc = _inputs(shape, 8, 4)
    kw = dict(inv_nalpha=sc[0], lr=sc[2], mu=sc[3], wd=sc[4])
    wp, wm = jref.fused_unpack_update_ref(
        jnp.asarray(words), jnp.asarray(p), jnp.asarray(m), bits=8, n_summed=4,
        **{k: jnp.float32(v) for k, v in kw.items()},
    )
    gp, gm = ref.fused_unpack_update_ref(
        torch.from_numpy(words), torch.from_numpy(p), torch.from_numpy(m),
        bits=8, n_summed=4, **{k: torch.tensor(v) for k, v in kw.items()},
    )
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), **TOL)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **TOL)


def test_fused_unpack_sgd_rejects_what_the_kernel_does_not_take():
    w = torch.zeros(2, dtype=torch.int32)
    p = torch.zeros(8)
    sc = torch.zeros(5)
    with pytest.raises(ValueError, match="bits"):
        ops.fused_unpack_sgd(w, p, p, sc, bits=32, n_summed=1)
    with pytest.raises(ValueError, match="words"):
        ops.fused_unpack_sgd(torch.zeros(3, dtype=torch.int32), p, p, sc, bits=8, n_summed=1)
    with pytest.raises(ValueError, match="scalars"):
        ops.fused_unpack_sgd(w, p, p, torch.zeros(4), bits=8, n_summed=1)
