"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (a CUDA kernel has no CPU
mode) and run on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

No JAX here: the machine with the card has none. The CPU tests
(``test_torch_kernels_*.py``) hold the plain versions against the JAX
package; these close the chain kernel == plain version == JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int_compress import clip_limit  # noqa: E402
from repro_torch.parallel.collectives import psum_wire_words  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(7,), (128,), (1000,), (8, 128), (300, 700), (3, 5, 7), (2, 3, 4, 5)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _ints(rng, shape, lim):
    return torch.from_numpy(rng.integers(-lim, lim + 1, shape).astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("stochastic", [True, False])
def test_int_compress_kernel_matches_plain(dev, shape, bits, stochastic):
    rng = np.random.default_rng(abs(hash((shape, bits))) % 2**31)
    x = torch.from_numpy((rng.standard_normal(shape) * 5).astype(np.float32)).to(dev)
    alpha = torch.tensor(23.7, device=dev)
    seed = torch.tensor(-987654321, dtype=torch.int32, device=dev)
    before = ops.int_compress.launches
    got = ops.int_compress(x, alpha, seed, n_workers=4, bits=bits, stochastic=stochastic)
    assert ops.int_compress.launches == before + 1
    want = ops.int_compress.plain(x, alpha, seed, n_workers=4, bits=bits,
                                  stochastic=stochastic)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int_compress_kernel_saturates_at_int32_edge(dev):
    x = torch.tensor([3e9, -3e9, 2147483647.0, 2.5, -0.5, float("nan")], device=dev)
    one = torch.tensor(1.0, device=dev)
    seed = torch.tensor(0, dtype=torch.int32, device=dev)
    got = ops.int_compress(x, one, seed, n_workers=1, bits=32, stochastic=False)
    assert got.tolist() == [2147483647, -2147483648, 2147483647, 2, 0, 0]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 4])
def test_pack_unpack_kernels_match_plain(dev, shape, bits, n):
    try:
        lim = clip_limit(bits, n)
    except ValueError:
        pytest.skip("degenerate clip")
    rng = np.random.default_rng(abs(hash((shape, bits, n))) % 2**31)
    images = [_ints(rng, shape, lim).to(dev) for _ in range(n)]
    images[0].view(-1)[0] = lim
    words = []
    for img in images:
        got = ops.pack_words(img, bits=bits, n_workers=n)
        torch.testing.assert_close(
            got, ops.pack_words.plain(img, bits=bits, n_workers=n), rtol=0, atol=0
        )
        words.append(got)
    wsum = psum_wire_words({"w": w} for w in words)["w"]
    got = ops.unpack_words(wsum, shape, bits=bits, n_summed=n)
    want = ops.unpack_words.plain(wsum, shape, bits=bits, n_summed=n)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    total = sum(img.to(torch.int64) for img in images)
    assert torch.equal(got.to(torch.int64), total)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_fused_unpack_sgd_kernel_matches_plain(dev, shape, bits):
    n = 4
    lim = clip_limit(bits, n)
    rng = np.random.default_rng(abs(hash((shape, bits))) % 2**31)
    words = psum_wire_words(
        {"w": ops.pack_words(_ints(rng, shape, lim).to(dev), bits=bits, n_workers=n)}
        for _ in range(n)
    )["w"]
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    sc = torch.tensor([1 / (n * 37.0), 0.61, 0.3, 0.9, 1e-4], device=dev)
    before = ops.fused_unpack_sgd.launches
    gp, gm = ops.fused_unpack_sgd(words, p, m, sc, bits=bits, n_summed=n)
    assert ops.fused_unpack_sgd.launches == before + 1
    wp, wm = ops.fused_unpack_sgd.plain(words, p, m, sc, bits=bits, n_summed=n)
    # built with --fmad=false: bit for bit
    torch.testing.assert_close(gp, wp, rtol=0, atol=0)
    torch.testing.assert_close(gm, wm, rtol=0, atol=0)


def _family_inputs(dev, kernel, d, shift, seed):
    """p, optimizer state, scalar vector and shift at the train path's
    magnitudes, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randn(d, generator=g, device=dev) * 0.02
    m = torch.randn(d, generator=g, device=dev) * 1e-3
    if kernel == "sgd":
        state = (m,)
        sc = torch.tensor([1 / (4 * 37.0), 0.61, 0.3, 0.9, 1e-4], device=dev)
    else:
        state = (m, torch.randn(d, generator=g, device=dev).abs() * 1e-5)
        t = 3
        sc = torch.tensor([1 / (4 * 37.0), 0.61, 3e-4, 0.9, 1.0 - 0.9, 0.95, 1.0 - 0.95,
                           1e-8, 1e-4, 1.0 - 0.9**t, 1.0 - 0.95**t], device=dev)
    h = torch.randn(d, generator=g, device=dev) * 0.01 if shift else None
    return p, state, sc, h


def _bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("kernel,shift", [("sgd", True), ("adamw", False), ("adamw", True)])
def test_fused_unpack_family_kernel_matches_plain(dev, bits, kernel, shift):
    n, d = 4, 1_000_003
    lim = clip_limit(bits, n)
    rng = np.random.default_rng([bits, len(kernel), int(shift)])
    words = psum_wire_words(
        {"w": ops.pack_words(_ints(rng, (d,), lim).to(dev), bits=bits, n_workers=n)}
        for _ in range(n)
    )["w"]
    p, state, sc, h = _family_inputs(dev, kernel, d, shift, bits)
    op = ops.fused_unpack_sgd if kernel == "sgd" else ops.fused_unpack_adamw
    before, before_shift = op.launches, op.shift_launches
    got = op(words, p, *state, sc, shift=h, bits=bits, n_summed=n)
    assert op.launches == before + 1 and op.shift_launches == before_shift + int(shift)
    # built with --fmad=false, IEEE sqrt and division: bit for bit
    _bit_equal(got, op.plain(words, p, *state, sc, shift=h, bits=bits, n_summed=n))


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("kernel", ["sgd", "adamw"])
@pytest.mark.parametrize("shift", [False, True])
def test_fused_apply_kernel_matches_plain_at_the_lane_extremes(dev, bits, kernel, shift):
    from repro_torch.wire import DenseInt

    n, d = 4, 1_000_003
    wf = DenseInt(bits)
    lim = wf.clip_limit(n)
    rng = np.random.default_rng([bits, len(kernel), int(shift), 5])
    images = [_ints(rng, (d,), lim).to(dev) for _ in range(n)]
    for img in images:  # sums at the lane's extremes ±n·lim
        img[:1000] = lim
        img[1000:2000] = -lim
    lanes = psum_wire_words({"w": wf.pack(img, n_workers=n)} for img in images)["w"]
    assert lanes.dtype == wf.lane_dtype
    assert int(lanes[:1000].min()) == n * lim and int(lanes[1000:2000].max()) == -n * lim
    p, state, sc, h = _family_inputs(dev, kernel, d, shift, bits + 1)
    op = ops.fused_apply_sgd if kernel == "sgd" else ops.fused_apply_adamw
    before = op.launches
    got = op(lanes, p, *state, sc, shift=h)
    assert op.launches == before + 1
    _bit_equal(got, op.plain(lanes, p, *state, sc, shift=h))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 8, device=dev).t()  # not contiguous
    one = torch.tensor(1.0, device=dev)
    seed = torch.tensor(0, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.int_compress(x, one, seed, n_workers=1, bits=8)
    with pytest.raises(ValueError, match="int32"):
        ops.pack_words(torch.zeros(8, device=dev), bits=8, n_workers=1)
    with pytest.raises(ValueError):  # alpha on the host
        ops.int_compress(torch.zeros(8, device=dev), torch.tensor(1.0), seed,
                         n_workers=1, bits=8)
    p = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="int8, int16 or int32"):
        ops.fused_apply_sgd(torch.zeros(8, dtype=torch.int64, device=dev), p, p,
                            torch.zeros(5, device=dev))
    with pytest.raises(ValueError, match="shift"):  # shift on the host
        ops.fused_apply_adamw(torch.zeros(8, dtype=torch.int8, device=dev), p, p, p,
                              torch.zeros(11, device=dev), shift=torch.zeros(8))


@pytest.mark.parametrize("shape", SHAPES + [(1,), (1_000_003,), (5000,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("nblocks", [1, 4, 8])
def test_block_norms_kernel_matches_plain_and_float64(dev, shape, dtype, nblocks):
    rng = np.random.default_rng([*shape, nblocks, dtype.itemsize])
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-(2**20), 2**20, shape).astype(np.int32)).to(dev)
    else:
        x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(dev)
    before = ops.block_norms.launches
    got = ops.block_sq_norms(x, nblocks)
    assert ops.block_norms.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (nblocks,)
    # the two sum in different orders (float64 partials in the kernel)
    torch.testing.assert_close(got, ops.block_norms.plain(x, nblocks), rtol=1e-5, atol=0)
    from repro_torch.kernels.block_norms import chunk_len

    per = chunk_len(x.numel(), nblocks)
    flat = x.reshape(-1).to(torch.float32).double()
    f64 = torch.stack([torch.sum(flat[b * per:(b + 1) * per] ** 2) for b in range(nblocks)])
    torch.testing.assert_close(got.double(), f64, rtol=1e-5, atol=0)
    # no atomics, a partition fixed by (numel, nblocks): bit-identical again
    assert torch.equal(ops.block_sq_norms(x, nblocks), got)


def test_block_norms_kernel_order_does_not_depend_on_alignment(dev):
    x = torch.randn(1_000_004, device=dev)
    view = x[1:]  # 4-byte aligned: four scalar loads per group, same order
    assert view.data_ptr() % 16 != 0
    for nblocks in (1, 4):
        assert torch.equal(ops.block_sq_norms(view, nblocks),
                           ops.block_sq_norms(view.clone(), nblocks))
    assert ops.sq_norm(view).shape == ()


def test_block_norms_kernel_at_the_most_blocks(dev):
    from repro_torch.kernels.block_norms import MAX_BLOCKS, chunk_len

    x = torch.randn(1_000_003, device=dev)
    got = ops.block_sq_norms(x, MAX_BLOCKS)
    per = chunk_len(x.numel(), MAX_BLOCKS)
    flat = torch.nn.functional.pad(x.double(), (0, per * MAX_BLOCKS - x.numel()))
    torch.testing.assert_close(got.double(), flat.view(MAX_BLOCKS, per).square().sum(1),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(got, ops.block_norms.plain(x, MAX_BLOCKS), rtol=1e-5, atol=0)
    assert torch.equal(ops.block_sq_norms(x, MAX_BLOCKS), got)


def test_block_norms_kernel_misaligned_view_at_several_block_counts(dev):
    x = torch.randn(16 * 4096 * 14 + 1, device=dev)
    view = x[1:]
    assert view.data_ptr() % 16 != 0
    for nblocks in (1, 4, 12):
        assert torch.equal(ops.block_sq_norms(view, nblocks),
                           ops.block_sq_norms(view.clone(), nblocks))


def test_block_norms_ticket_counters_return_to_zero(dev):
    """Launches of other sizes and block counts, interleaved and repeated:
    each bit-identical to its first result, and every counter 0 after."""
    from repro_torch.kernels.block_norms import ticket_counters

    gen = torch.Generator(device=dev).manual_seed(5)
    cases = [(4_000_037, 1), (1_000_003, 4), (2500, 4), (16_384, 1), (1_000_003, 65535),
             (3_000_000, 3), (1, 1)]
    firsts = []
    for d, nb in cases:
        x = torch.randn(d, generator=gen, device=dev)
        firsts.append((x, nb, ops.block_sq_norms(x, nb)))
        xi = torch.randint(-124, 125, (d,), generator=gen, device=dev, dtype=torch.int32)
        firsts.append((xi, nb, ops.block_sq_norms(xi, nb)))
    for _ in range(3):
        for x, nb, want in firsts[::-1] + firsts:
            assert torch.equal(ops.block_sq_norms(x, nb), want)
    assert not ticket_counters(dev).any()


def test_block_norms_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    with pytest.raises(TypeError, match="float32 or int32"):
        ops.sq_norm(torch.zeros(8, dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        ops.sq_norm(torch.zeros(4, 8, device=dev).t())
    with pytest.raises(ValueError, match="nblocks"):
        ops.block_sq_norms(torch.zeros(8, device=dev), 70000)
