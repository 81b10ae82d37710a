"""Port vs JAX: the block-norms kernel's plain version and the norms built
on it.

The same inputs, made with numpy, go through the JAX package's Pallas
kernel (interpret mode on the CPU, via ``kernels.ops.sq_norm`` and
``block_sq_norms``) or its oracle ``ref.block_norms_ref``, and through the
port's wrappers, which run the plain PyTorch version for CPU tensors. Both
sum float32 squares in float32, in different orders: rtol 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import ops as kops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import block_norms as bn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SHAPES = [(1,), (7,), (1000,), (8, 128), (300, 700), (3, 5, 7), (2, 3, 4, 5)]
RTOL = 1e-5


def _input(rng, shape, dtype):
    if dtype == "int32":
        # a few values past 2^24, where the cast to float32 rounds
        x = rng.integers(-(2**20), 2**20, shape).astype(np.int32)
        x.reshape(-1)[::97] = rng.integers(-(3 * 10**8), 3 * 10**8, x.reshape(-1)[::97].shape)
        return x
    return (rng.standard_normal(shape) * 3.0).astype(np.float32)


def _np_chunk_norms(x, nblocks, per):
    """Σx² of chunk b = flat[b·per, (b+1)·per), in float64."""
    flat = x.reshape(-1).astype(np.float32).astype(np.float64)
    return np.array([np.sum(flat[b * per:(b + 1) * per] ** 2) for b in range(nblocks)])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("nblocks", [1, 3, 8])
def test_block_sq_norms_match_jax(shape, dtype, nblocks):
    rng = np.random.default_rng([*shape, nblocks, len(dtype)])
    x = _input(rng, shape, dtype)
    want = np.asarray(kops.block_sq_norms(jnp.asarray(x), nblocks, interpret=True))
    t = torch.from_numpy(x)
    before = ops.block_norms.launches
    got = ops.block_sq_norms(t, nblocks)
    assert ops.block_norms.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (nblocks,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    torch.testing.assert_close(bn.block_norms_plain(t, nblocks), got, rtol=0, atol=0)
    # and against the JAX oracle on the JAX wrapper's padded (rows, 128) view
    per = bn.chunk_len(x.size, nblocks)
    flat = np.pad(x.reshape(-1).astype(np.float32), (0, per * nblocks - x.size))
    oracle = np.asarray(jref.block_norms_ref(jnp.asarray(flat.reshape(-1, 128)), per // 128))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_sq_norm_matches_jax(shape, dtype):
    rng = np.random.default_rng([*shape, 11, len(dtype)])
    x = _input(rng, shape, dtype)
    want = np.asarray(kops.sq_norm(jnp.asarray(x), interpret=True))
    got = ops.sq_norm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(
        got.numpy(), np.sum(x.astype(np.float32).astype(np.float64) ** 2), rtol=RTOL
    )


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float64])
def test_plain_version_casts_any_dtype_like_jax(dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(5000) * 20).to(dtype)
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(
        {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8, torch.float64: jnp.float32}[dtype]
    )
    want = np.asarray(kops.block_sq_norms(xj, 3, interpret=True))
    np.testing.assert_allclose(ops.block_sq_norms(x, 3).numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("rows,cols,block_rows", [(16, 128, 8), (13, 128, 4), (5, 3, 2), (1, 1, 1)])
def test_block_norms_ref_matches_jax(rows, cols, block_rows):
    x = np.random.default_rng([rows, cols, block_rows]).standard_normal((rows, cols)).astype(np.float32)
    want = np.asarray(jref.block_norms_ref(jnp.asarray(x), block_rows))
    got = ref.block_norms_ref(torch.from_numpy(x), block_rows)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("size,nblocks,per,nonzero", [
    (5000, 8, 1024, 5),  # ceil(5000/8) = 625 rounds up to one tile: blocks 5-7 empty
    (5000, 3, 2048, 3),
    (1, 8, 1024, 1),
    (1024, 2, 1024, 1),
    (4097, 4, 2048, 3),
])
def test_chunk_rule_pins_jax(size, nblocks, per, nonzero):
    assert bn.chunk_len(size, nblocks) == per
    x = np.random.default_rng(size).standard_normal(size).astype(np.float32) + 0.5
    got = ops.block_sq_norms(torch.from_numpy(x), nblocks).numpy()
    want = np.asarray(kops.block_sq_norms(jnp.asarray(x), nblocks, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert (got[:nonzero] > 0).all() and (got[nonzero:] == 0).all()
    assert (want[nonzero:] == 0).all()


@settings(max_examples=30, deadline=None)
@given(size=st.integers(1, 5000), nblocks=st.integers(1, 8), seed=st.integers(0, 2**31 - 1),
       integer=st.booleans())
def test_chunk_rule_sweep_matches_jax(size, nblocks, seed, integer):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-1000, 1000, size).astype(np.int32) if integer
         else rng.standard_normal(size).astype(np.float32))
    got = ops.block_sq_norms(torch.from_numpy(x), nblocks).numpy()
    want = np.asarray(kops.block_sq_norms(jnp.asarray(x), nblocks, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    per = -(-(-(-size // nblocks)) // 1024) * 1024
    assert bn.chunk_len(size, nblocks) == per
    np.testing.assert_allclose(got, _np_chunk_norms(x, nblocks, per), rtol=RTOL)
    # chunks that start past the end are exactly zero, in both packages
    empty = np.arange(nblocks) * per >= size
    assert (got[empty] == 0).all() and (want[empty] == 0).all()


@pytest.mark.parametrize("numel", [0, 1, 4, 1000, 1_000_003, 234_881_024])
@pytest.mark.parametrize("nblocks", [1, 4, 12, 5000, 65535])
def test_kernel_partition_depends_only_on_size(numel, nblocks):
    """The CUDA kernel's grid: chunks of chunk_len, at least one CTA per
    chunk, MAX_CTAS (a constant that fits one wave of an H100: 8 CTAs of
    256 threads on each of 132 SMs) in all at the largest chunks, and none
    that would find no group of four to read."""
    chunk = bn.chunk_len(numel, nblocks)
    ctas = bn.stage_one_ctas(numel, nblocks)
    assert chunk % bn.TILE_ELEMS == 0 and chunk * nblocks >= numel
    assert bn.MAX_CTAS == 1024 and bn.MAX_CTAS <= 8 * 132
    assert 1 <= ctas <= bn.MAX_CTAS
    assert ctas * nblocks <= max(bn.MAX_CTAS + nblocks, nblocks)
    groups = -(-chunk // 4)
    assert ctas == 1 or (ctas - 1) * bn.THREADS < groups
    assert ctas == bn.stage_one_ctas(numel, nblocks)
    if numel == 234_881_024 and nblocks in (1, 4):  # the full grid
        assert ctas * nblocks == bn.MAX_CTAS


def test_ticket_counters_are_one_cached_zero_tensor_per_device():
    """The wrapper's allocation helper, run on the CPU and the meta device:
    MAX_BLOCKS int32 zeros, allocated once per device."""
    devices = (torch.device("cpu"), torch.device("meta"))
    for d in devices:
        bn._counters.pop(d, None)
    first = bn.ticket_counters(torch.device("cpu"))
    assert first.dtype == torch.int32 and tuple(first.shape) == (bn.MAX_BLOCKS,)
    assert first.device.type == "cpu" and not first.any()
    assert bn.ticket_counters("cpu") is first
    other = bn.ticket_counters("meta")
    assert other is not first and other.device.type == "meta"
    assert bn.ticket_counters(torch.device("meta")) is other
    for d in devices:
        bn._counters.pop(d)


def test_cuda_wrapper_rejects_other_dtypes_before_building():
    with pytest.raises(TypeError, match="float32 or int32"):
        bn.block_norms_cuda(torch.zeros(8, dtype=torch.bfloat16), 1)
    with pytest.raises(TypeError, match="float32 or int32"):
        bn.block_norms_cuda(torch.zeros(8, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="contiguous"):
        bn.block_norms_cuda(torch.zeros(4, 8).t(), 1)
    with pytest.raises(ValueError, match="at least 1"):
        bn.chunk_len(10, 0)


def test_empty_and_one_element_inputs():
    assert ops.block_sq_norms(torch.zeros(0), 3).tolist() == [0.0, 0.0, 0.0]
    assert ops.sq_norm(torch.tensor([-3.0])).item() == 9.0
    assert ops.sq_norm(torch.tensor([7], dtype=torch.int32)).item() == 49.0
