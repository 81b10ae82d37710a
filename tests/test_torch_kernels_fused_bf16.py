"""Port vs JAX: the fused decode + update kernels with a bf16 param (the
JAX step's default ``param_dtype``), and the encode kernel on a bf16
gradient.

JAX side: ``kernels.ops.fused_unpack_apply`` / ``fused_apply`` (Pallas,
interpret mode), which cast the bf16 param to float32 before the kernel and
the result back to bf16 after it (round to nearest even); the state and the
shift stay float32. Port side: the kernels' plain versions (the same op
order in float32, ``.to(torch.bfloat16)`` at the end), which the CUDA
kernels' ``_bf16`` entry points are held to on the card.

Tolerances: the state and shift agree at rtol 1e-6 (atol 1e-7 for SGD,
1e-9 for AdamW), as in ``test_torch_kernels_fused.py``: XLA contracts a
product and a sum into one FMA in the interpreted kernel, which the port
never does, and its CPU sqrt is not correctly rounded. So p' is within one
bf16 ULP — the float32 values can straddle a bf16 rounding boundary — and
bit-equal at all but a few in a thousand elements.

NaN: a NaN param gives NaN at the same places in both packages, compared
as NaN, not by its bits: NaN patterns differ between XLA's convert, the
CPU's vectorised cast and the card's cvt.rn.bf16.f32, which the CUDA kernel
uses as torch's own cast on the card does. The encode on a
bf16 gradient is bit-equal to JAX's, which casts to float32 outside its
kernel.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int_compress import clip_limit  # noqa: E402
from repro_torch.kernels.wire_pack import pack_words_plain  # noqa: E402

N = 4
SHAPES = [(7,), (1000,), (300, 70), (3, 5, 7)]
TOL_SGD = dict(rtol=1e-6, atol=1e-7)
TOL_ADAMW = dict(rtol=1e-6, atol=1e-9)


def _bf16_bits(t):
    """A bf16 array (torch, or JAX/ml_dtypes) as its int16 bit patterns."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _scalars(kernel, inv_nalpha, rng):
    if kernel == "sgd":
        return np.array([inv_nalpha, 0.43, 0.3, 0.9, 1e-4], np.float32)
    b1, b2, t = 0.9, 0.95, 3
    return np.array([inv_nalpha, rng.uniform(0.3, 1.0), 3e-4, b1, 1.0 - b1, b2, 1.0 - b2,
                     1e-8, 1e-4, 1.0 - b1**t, 1.0 - b2**t], np.float32)


def _inputs(shape, kernel, shift, codec, nan=False):
    """A summed n = 4 payload (packed8 words or int8 lanes, the extremes
    present), a bf16 param (as exact float32 values too), float32 state,
    scalars and shift at the train path's magnitudes."""
    rng = np.random.default_rng([*shape, len(kernel), shift, len(codec), nan])
    lim = clip_limit(8, N)
    images = [rng.integers(-lim, lim + 1, shape).astype(np.int32) for _ in range(N)]
    for img in images:
        img.reshape(-1)[0], img.reshape(-1)[-1] = lim, -lim
    total = sum(img.astype(np.int64) for img in images)
    if codec == "packed8":
        words = sum(pack_words_plain(torch.from_numpy(img), bits=8, n_workers=N).to(torch.int64)
                    for img in images)
        payload = ((words + 2**31) % 2**32 - 2**31).to(torch.int32).numpy()
    else:
        payload = total.astype(np.int8)
    p = torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))
    if nan:
        p.view(-1)[1::3] = float("nan")
    p16 = p.to(torch.bfloat16)
    alpha = np.float32(lim * rng.uniform(50.0, 200.0))
    sc = _scalars(kernel, np.float32(1.0 / (N * alpha)), rng)
    opt = [(rng.standard_normal(shape) * 1e-3).astype(np.float32)]
    if kernel == "adamw":
        opt.append((np.abs(rng.standard_normal(shape)) * 1e-5).astype(np.float32))
    h = (rng.standard_normal(shape) * 0.01).astype(np.float32) if shift else None
    return payload, p16, opt, sc, h


def _run_both(shape, kernel, shift, codec, nan=False):
    payload, p16, opt, sc, h = _inputs(shape, kernel, shift, codec, nan)
    jp = jnp.asarray(p16.to(torch.float32).numpy()).astype(jnp.bfloat16)  # exact
    jargs = (jnp.asarray(payload), jp, tuple(jnp.asarray(o) for o in opt), jnp.asarray(sc),
             None if h is None else jnp.asarray(h))
    targs = (torch.from_numpy(payload), p16, *(torch.from_numpy(o) for o in opt),
             torch.from_numpy(sc))
    tshift = None if h is None else torch.from_numpy(h)
    if codec == "packed8":
        wp, wopt, wh = kops.fused_unpack_apply(*jargs, kernel=kernel, bits=8, n_summed=N)
        op = ops.fused_unpack_sgd if kernel == "sgd" else ops.fused_unpack_adamw
        got = op(*targs, shift=tshift, bits=8, n_summed=N)
    else:
        wp, wopt, wh = kops.fused_apply(*jargs, kernel=kernel)
        op = ops.fused_apply_sgd if kernel == "sgd" else ops.fused_apply_adamw
        got = op(*targs, shift=tshift)
    assert wp.dtype == jnp.bfloat16
    return got, (wp, *wopt) + ((wh,) if shift else ())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("codec", ["packed8", "dense8"])
@pytest.mark.parametrize("kernel", ["sgd", "adamw"])
@pytest.mark.parametrize("shift", [False, True])
def test_fused_bf16_param_matches_jax(shape, codec, kernel, shift):
    got, want = _run_both(shape, kernel, shift, codec)
    assert len(got) == len(want)
    assert got[0].dtype == torch.bfloat16 and tuple(got[0].shape) == shape
    assert all(g.dtype == torch.float32 for g in got[1:])
    ulps = np.abs(_bf16_bits(got[0]).astype(np.int32) - _bf16_bits(want[0]).astype(np.int32))
    assert ulps.max() <= 1 and (ulps > 0).mean() < 5e-3, (ulps.max(), (ulps > 0).mean())
    tol = TOL_SGD if kernel == "sgd" else TOL_ADAMW
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("codec", ["packed8", "dense8"])
@pytest.mark.parametrize("kernel", ["sgd", "adamw"])
def test_fused_bf16_nan_param_is_nan_in_both(codec, kernel):
    got, want = _run_both((300, 7), kernel, True, codec, nan=True)
    gp = got[0].to(torch.float32).numpy()
    wp = np.asarray(want[0]).astype(np.float32)
    nan = np.isnan(gp)
    assert nan.sum() == 700 and np.array_equal(nan, np.isnan(wp))
    ulps = np.abs(_bf16_bits(got[0]).astype(np.int32) - _bf16_bits(want[0]).astype(np.int32))
    assert ulps[~nan].max() <= 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stochastic", [True, False])
def test_int_compress_bf16_input_matches_jax(shape, stochastic):
    rng = np.random.default_rng([*shape, stochastic, 16])
    x16 = torch.from_numpy((rng.standard_normal(shape) * 5.0).astype(np.float32)).to(torch.bfloat16)
    alpha = np.float32(23.7)
    key = jax.random.PRNGKey(int(rng.integers(0, 2**31)))
    jx = jnp.asarray(x16.to(torch.float32).numpy()).astype(jnp.bfloat16)
    want = kops.int_compress(jx, jnp.float32(alpha), key, n_workers=N, bits=8,
                             stochastic=stochastic)
    seed = torch.tensor(np.asarray(kops.seed_from_key(key)))
    got = ops.int_compress(x16, torch.tensor(alpha), seed, n_workers=N, bits=8,
                           stochastic=stochastic)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the image is the float32 encode's on x.float(): the widening is exact
    same = ops.int_compress(x16.to(torch.float32), torch.tensor(alpha), seed, n_workers=N,
                            bits=8, stochastic=stochastic)
    assert torch.equal(got, same)


def test_fused_kernels_refuse_other_param_and_state_types():
    sc5 = torch.zeros(5)
    ints = torch.zeros(8, dtype=torch.int8)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16 params"):
            ops.fused_apply_sgd(ints, torch.zeros(8, dtype=bad), torch.zeros(8), sc5)
    with pytest.raises(ValueError, match="state and shift are float32"):
        ops.fused_apply_sgd(ints, torch.zeros(8, dtype=torch.bfloat16),
                            torch.zeros(8, dtype=torch.bfloat16), sc5)
    with pytest.raises(ValueError, match="state and shift are float32"):
        ops.fused_apply_sgd(ints, torch.zeros(8), torch.zeros(8), sc5,
                            shift=torch.zeros(8, dtype=torch.bfloat16))
