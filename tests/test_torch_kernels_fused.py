"""Port vs JAX: the packed fused decode + update kernels' plain versions —
the SGD and AdamW bodies, each with and without the IntDIANA shift.

JAX side: ``kernels.ops.fused_unpack_apply(kernel=...)`` (Pallas,
interpret mode) on the same summed words, params, optimizer state, shift
and scalar vector. Tolerance rtol=1e-6 (atol=1e-7 for SGD, 1e-9 for AdamW's
smaller moments), the shift output included: the port rounds every product
(as its CUDA kernel, built with --fmad=false, does), while XLA may contract
a product and a sum into one FMA. The dense-lane kernels are in
``test_torch_kernels_fused_dense.py``.
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


TOL_ADAMW = dict(rtol=1e-6, atol=1e-9)


def adamw_scalars(inv_nalpha, rng, t=3):
    """[inv_nalpha, clip, lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2] as the
    train path builds them (omb pre-rounded from the Python floats)."""
    b1, b2 = 0.9, 0.95
    return np.array(
        [inv_nalpha, rng.uniform(0.3, 1.0), 3e-4, b1, 1.0 - b1, b2, 1.0 - b2,
         1e-8, 1e-4, 1.0 - b1**t, 1.0 - b2**t], np.float32,
    )


def optimizer_state(kernel, shape, rng):
    """Train-path magnitudes: momentum / first moment ~1e-3, second moment
    ~1e-5 (non-negative)."""
    m = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    if kernel == "sgd":
        return (m,)
    return m, (np.abs(rng.standard_normal(shape)) * 1e-5).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("kernel,shift", [("adamw", False), ("adamw", True), ("sgd", True)])
def test_fused_unpack_family_matches_jax(shape, bits, kernel, shift):
    n = 4
    words, p, m, sc = _inputs(shape, bits, n)
    rng = np.random.default_rng([*shape, bits, 11])
    if kernel == "adamw":
        sc = adamw_scalars(sc[0], rng)
    opt = optimizer_state(kernel, shape, rng)
    h = (rng.standard_normal(shape) * 0.01).astype(np.float32) if shift else None
    wp, wopt, wh = kops.fused_unpack_apply(
        jnp.asarray(words), jnp.asarray(p), tuple(jnp.asarray(o) for o in opt),
        jnp.asarray(sc), None if h is None else jnp.asarray(h),
        kernel=kernel, bits=bits, n_summed=n,
    )
    op = ops.fused_unpack_sgd if kernel == "sgd" else ops.fused_unpack_adamw
    got = op(
        torch.from_numpy(words), torch.from_numpy(p),
        *(torch.from_numpy(o) for o in opt), torch.from_numpy(sc),
        shift=None if h is None else torch.from_numpy(h), bits=bits, n_summed=n,
    )
    want = (wp, *wopt) + ((wh,) if shift else ())
    assert len(got) == len(want) and all(tuple(g.shape) == shape for g in got)
    tol = TOL if kernel == "sgd" else TOL_ADAMW
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("shift", [False, True])
def test_fused_adamw_oracle_matches_jax(shape, shift):
    """The port's ``fused_unpack_adamw_ref`` against the JAX package's
    ``ref.fused_unpack_adamw_ref(shift=...)``, given the JAX oracle's own
    omb = 1 − b computed in f32."""
    words, p, _, sc = _inputs(shape, 8, 4)
    rng = np.random.default_rng([*shape, 13])
    mu, nu = optimizer_state("adamw", shape, rng)
    h = (rng.standard_normal(shape) * 0.01).astype(np.float32) if shift else None
    s = adamw_scalars(sc[0], rng)
    f = {k: np.float32(v) for k, v in zip(
        ("inv_nalpha", "clip", "lr", "b1", "omb1", "b2", "omb2", "eps", "wd", "bc1", "bc2"), s)}
    jkw = {k: jnp.float32(f[k]) for k in ("inv_nalpha", "lr", "b1", "b2", "eps", "wd", "bc1", "bc2", "clip")}
    jout = jref.fused_unpack_adamw_ref(
        jnp.asarray(words), jnp.asarray(p), jnp.asarray(mu), jnp.asarray(nu),
        bits=8, n_summed=4, shift=None if h is None else jnp.asarray(h), **jkw,
    )
    tkw = {k: torch.tensor(v) for k, v in f.items()}
    tkw["omb1"] = torch.tensor(np.float32(1) - f["b1"])
    tkw["omb2"] = torch.tensor(np.float32(1) - f["b2"])
    got = ref.fused_unpack_adamw_ref(
        torch.from_numpy(words), torch.from_numpy(p), torch.from_numpy(mu),
        torch.from_numpy(nu), bits=8, n_summed=4,
        shift=None if h is None else torch.from_numpy(h), **tkw,
    )
    want = jout if shift else jout[:3]  # the JAX oracle always returns g_agg
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_ADAMW)


def test_fused_unpack_adamw_rejects_what_the_kernel_does_not_take():
    w = torch.zeros(2, dtype=torch.int32)
    p = torch.zeros(8)
    sc = torch.zeros(11)
    with pytest.raises(ValueError, match="scalars"):
        ops.fused_unpack_adamw(w, p, p, p, torch.zeros(5), bits=8, n_summed=1)
    with pytest.raises(ValueError, match="shift"):
        ops.fused_unpack_adamw(w, p, p, p, sc, shift=torch.zeros(7), bits=8, n_summed=1)
    with pytest.raises(ValueError, match="state"):
        ops.fused_unpack_adamw(w, p, p, torch.zeros(9), sc, bits=8, n_summed=1)
