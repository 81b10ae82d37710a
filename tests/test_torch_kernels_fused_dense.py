"""Port vs JAX: the dense-lane fused decode + update kernels' plain
versions (``fused_apply_sgd`` / ``fused_apply_adamw``), on int8, int16 and
int32 lanes, each with and without the IntDIANA shift.

JAX side: ``kernels.ops.fused_apply(kernel=...)`` (Pallas ``fused_apply_2d``,
interpret mode) on the same summed lanes, params, optimizer state, shift and
scalar vector. Tolerances as in ``test_torch_kernels_fused.py``: rtol=1e-6
(atol=1e-7 for SGD, 1e-9 for AdamW), the shift output included — XLA may
contract a product and a sum into one FMA, the port never does.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int_compress import clip_limit  # noqa: E402

SHAPES = [(7,), (128,), (1000,), (8, 128), (300, 700), (3, 5, 7), (2, 3, 4, 5)]
TOL = dict(rtol=1e-6, atol=1e-7)
TOL_ADAMW = dict(rtol=1e-6, atol=1e-9)
N = 4
LANES = {8: (np.int8, torch.int8), 16: (np.int16, torch.int16), 32: (np.int32, torch.int32)}


def adamw_scalars(inv_nalpha, rng, t=3):
    """[inv_nalpha, clip, lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2] as the
    train path builds them (omb pre-rounded from the Python floats)."""
    b1, b2 = 0.9, 0.95
    return np.array(
        [inv_nalpha, rng.uniform(0.3, 1.0), 3e-4, b1, 1.0 - b1, b2, 1.0 - b2,
         1e-8, 1e-4, 1.0 - b1**t, 1.0 - b2**t], np.float32,
    )


def optimizer_state(kernel, shape, rng):
    """Momentum / first moment ~1e-3, second moment ~1e-5 (non-negative)."""
    m = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    if kernel == "sgd":
        return (m,)
    return m, (np.abs(rng.standard_normal(shape)) * 1e-5).astype(np.float32)


def _dense_inputs(shape, bits, kernel, shift):
    """n = 4 summed images in the lane type, with the extremes ±n·lim
    present, and the train path's magnitudes for the rest."""
    lim = clip_limit(bits, N)
    rng = np.random.default_rng([*shape, bits, 17])
    total = sum(rng.integers(-lim, lim + 1, shape).astype(np.int64) for _ in range(N))
    flat = total.reshape(-1)
    flat[0] = N * lim
    flat[-1] = -N * lim
    ints = total.astype(LANES[bits][0])
    p = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    alpha = np.float32(lim * rng.uniform(50.0, 200.0))
    inv_nalpha = np.float32(1.0 / (N * alpha))
    if kernel == "sgd":
        sc = np.array([inv_nalpha, 0.43, 0.3, 0.9, 1e-4], np.float32)
    else:
        sc = adamw_scalars(inv_nalpha, rng)
    opt = optimizer_state(kernel, shape, rng)
    h = (rng.standard_normal(shape) * 0.01).astype(np.float32) if shift else None
    return ints, p, opt, sc, h


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("kernel", ["sgd", "adamw"])
@pytest.mark.parametrize("shift", [False, True])
def test_fused_apply_matches_jax(shape, bits, kernel, shift):
    ints, p, opt, sc, h = _dense_inputs(shape, bits, kernel, shift)
    wp, wopt, wh = kops.fused_apply(
        jnp.asarray(ints), jnp.asarray(p), tuple(jnp.asarray(o) for o in opt),
        jnp.asarray(sc), None if h is None else jnp.asarray(h), kernel=kernel,
    )
    op = ops.fused_apply_sgd if kernel == "sgd" else ops.fused_apply_adamw
    t_ints = torch.from_numpy(ints)
    assert t_ints.dtype == LANES[bits][1]
    got = op(
        t_ints, torch.from_numpy(p), *(torch.from_numpy(o) for o in opt),
        torch.from_numpy(sc), shift=None if h is None else torch.from_numpy(h),
    )
    want = (wp, *wopt) + ((wh,) if shift else ())
    assert len(got) == len(want) and all(tuple(g.shape) == shape for g in got)
    tol = TOL if kernel == "sgd" else TOL_ADAMW
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_fused_apply_rejects_what_the_kernel_does_not_take():
    p = torch.zeros(8)
    sc5 = torch.zeros(5)
    with pytest.raises(ValueError, match="int8, int16 or int32"):
        ops.fused_apply_sgd(torch.zeros(8, dtype=torch.int64), p, p, sc5)
    with pytest.raises(ValueError, match="lanes"):
        ops.fused_apply_sgd(torch.zeros(7, dtype=torch.int8), p, p, sc5)
    with pytest.raises(ValueError, match="scalars"):
        ops.fused_apply_adamw(torch.zeros(8, dtype=torch.int8), p, p, p, sc5)
