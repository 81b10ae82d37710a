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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,n", [(8, 4), (32, 1)])
def test_int_compress_kernel_amax_matches_plain(dev, dtype, bits, n):
    """The kernel's |image| max (warp max, one atomicMax per warp) equals
    the plain version's, also accumulated over two launches and at the int32
    edge (|-2^31| as float32). The size takes the grid-stride loop round
    three times and more (the grid is capped at 132·32 blocks of 256), and
    the unsaturated int32 image has its peak in the last round, so each
    thread's running max across rounds is what is held."""
    rng = np.random.default_rng([bits, n, 4])
    size = 3 * 132 * 32 * 256 + 1_001
    x = rng.standard_normal(size) * 5
    x[size - 3] = -40.0  # |image| 948 or 949, past the N(0, 118) tail
    x = torch.from_numpy(x.astype(np.float32)).to(dev).to(dtype)
    alpha = torch.tensor(23.7, device=dev)
    seed = torch.tensor(11, dtype=torch.int32, device=dev)
    kw = dict(n_workers=n, bits=bits)
    got, want = torch.zeros((), device=dev), torch.zeros((), device=dev)
    for scale in (1e-3, 1.0):
        a = ops.int_compress(x * scale, alpha, seed, amax=got, **kw)
        b = ops.int_compress.plain(x * scale, alpha, seed, amax=want, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got.item() == want.item() == float(a.abs().max()) > 0
    if bits == 32:
        assert int(a.abs().argmax()) == size - 3 and got.item() >= 948
    edge = torch.tensor([-3e9, 5.0], device=dev)
    got = torch.zeros((), device=dev)
    ops.int_compress(edge, torch.tensor(1.0, device=dev), seed, n_workers=1, bits=32,
                     stochastic=False, amax=got)
    assert got.item() == 2.0**31


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


def _bit_equal_nan(got, want):
    """Bit for bit, a NaN compared as NaN (its pattern is not compared)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b))
        assert torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("codec", ["packed8", "dense8"])
@pytest.mark.parametrize("kernel", ["sgd", "adamw"])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("nan", [False, True])
def test_fused_kernels_bf16_param_match_plain(dev, codec, kernel, shift, nan):
    """The _bf16 entry points: p read and written as bf16 (rounded to
    nearest even), state and shift float32, bit-equal to the plain version;
    a NaN param stays NaN at the same places."""
    n, d = 4, 1_000_003
    lim = clip_limit(8, n)
    rng = np.random.default_rng([len(codec), len(kernel), int(shift), int(nan)])
    images = [_ints(rng, (d,), lim).to(dev) for _ in range(n)]
    if codec == "packed8":
        payload = psum_wire_words({"w": ops.pack_words(img, bits=8, n_workers=n)}
                                  for img in images)["w"]
        op = ops.fused_unpack_sgd if kernel == "sgd" else ops.fused_unpack_adamw
        kw = dict(bits=8, n_summed=n)
    else:
        payload = psum_wire_words({"w": img.to(torch.int8)} for img in images)["w"]
        op = ops.fused_apply_sgd if kernel == "sgd" else ops.fused_apply_adamw
        kw = {}
    p, state, sc, h = _family_inputs(dev, kernel, d, shift, 9)
    p = p.to(torch.bfloat16)
    if nan:
        p[1::1000] = float("nan")
    before, before16 = op.launches, op.bf16_launches
    got = op(payload, p, *state, sc, shift=h, **kw)
    assert op.launches == before + 1 and op.bf16_launches == before16 + 1
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    _bit_equal_nan(got, op.plain(payload, p, *state, sc, shift=h, **kw))
    if nan:
        assert int(torch.isnan(got[0]).sum()) == len(range(1, d, 1000))


@pytest.mark.parametrize("shape", SHAPES + [(1_000_003,)])
@pytest.mark.parametrize("stochastic", [True, False])
def test_int_compress_kernel_bf16_input_matches_plain(dev, shape, stochastic):
    rng = np.random.default_rng([len(shape), int(stochastic), 16])
    x = torch.from_numpy((rng.standard_normal(shape) * 5).astype(np.float32)).to(dev)
    x16 = x.to(torch.bfloat16)
    alpha = torch.tensor(23.7, device=dev)
    seed = torch.tensor(-987654321, dtype=torch.int32, device=dev)
    kw = dict(n_workers=4, bits=8, stochastic=stochastic)
    before16 = ops.int_compress.bf16_launches
    got = ops.int_compress(x16, alpha, seed, **kw)
    assert ops.int_compress.bf16_launches == before16 + 1
    torch.testing.assert_close(got, ops.int_compress.plain(x16, alpha, seed, **kw),
                               rtol=0, atol=0)
    # the widening is exact: the float32 kernel's image on x16.float()
    torch.testing.assert_close(got, ops.int_compress(x16.float(), alpha, seed, **kw),
                               rtol=0, atol=0)


def test_bf16_kernels_refuse_other_types(dev):
    one = torch.tensor(1.0, device=dev)
    seed = torch.tensor(0, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.int_compress(torch.zeros(8, dtype=torch.float16, device=dev), one, seed,
                         n_workers=1, bits=8)
    ints = torch.zeros(8, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16 params"):
        ops.fused_apply_sgd(ints, torch.zeros(8, dtype=torch.float16, device=dev),
                            torch.zeros(8, device=dev), torch.zeros(5, device=dev))


def test_bf16_fused_step_on_the_card_matches_the_cpu(dev):
    """One exact and one compressed step of granite-8b (smoke) with bf16
    params, the default, on the fused SGD / IntSGD / packed8 route at
    n = 4: losses within 2e-2 of the CPU's (the bf16 backward differs),
    params bf16 and finite, and every encode and fused update launched as
    its bf16 variant."""
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch.step import build_init_state, build_train_step
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.schedules import constant, warmup_wrap
    from repro_torch.optim.sgd import sgd

    cfg = smoke_config(get_arch("granite-8b"))
    n = 4
    shape = ShapeConfig("t", 32, n, "train")
    comp = make_compressor("intsgd8_packed")
    opt = sgd(momentum=0.9, weight_decay=1e-4)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    params0 = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                             dtype=torch.bfloat16)
    n_leaves = len(params0)
    gen = torch.Generator().manual_seed(0)
    seeds = [leaf_seeds(gen, n, n_leaves, "cpu") for _ in range(2)]
    runs = {}
    for device in (torch.device("cpu"), dev):
        art = build_train_step(cfg, shape, n_workers=n, compressor=comp, base_opt=opt,
                               lr_schedule=warmup_wrap(constant(0.3), 5), fused=True,
                               clip_norm=1.0, device=device)
        p = {k: v.to(device) for k, v in params0.items()}
        o, cs = build_init_state(p, n_workers=n, compressor=comp, base_opt=opt, fused=True)
        losses = []
        ops.reset_launch_counts()
        for i in range(2):
            fn = art.steps["exact" if i == 0 else "compressed"]
            p, o, cs, loss, met = fn(p, o, cs, i, data.batch(i, 0, device=device),
                                     seeds[i].to(device))
            losses.append(float(loss))
        assert all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all())
                   for v in p.values())
        assert 0 < float(met[3]) <= clip_limit(8, n) and float(met[0]) <= n * clip_limit(8, n)
        runs[device.type] = losses
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=2e-2)
    counts, counts16 = ops.launch_counts(), ops.bf16_launch_counts()
    assert counts["int_compress"] == counts16["int_compress"] == n * n_leaves
    assert counts["fused_unpack_sgd"] == counts16["fused_unpack_sgd"] == n_leaves


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


def test_zero1_pipelined_step_on_the_card_matches_the_cpu(dev):
    """The ZeRO-1 route with M = 2 pipelined microbatches at n = 4
    (granite-8b smoke, SGD, packed8), on the card against the CPU. Fed the
    same gradients (the CPU's backward), the pipelined round gives the same
    images, summed images and int32 accumulator bit for bit on both, and the
    same ĝ; the whole steps' losses agree at rtol 2e-2 (the bf16 backward
    differs), and the card's step launches each kernel as often as the path
    implies."""
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.core.comm import CommCtx
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.core.scaling import AlphaState
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch.step import (
        _forward_backward, _microbatch, build_init_state, build_train_step,
    )
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.schedules import constant, warmup_wrap
    from repro_torch.optim.sgd import sgd

    cfg = smoke_config(get_arch("granite-8b"))
    n, micro = 4, 2
    shape = ShapeConfig("t", 32, n * micro, "train")
    comp = make_compressor("intsgd8_packed")
    opt = sgd(momentum=0.9, weight_decay=1e-4)
    sched = warmup_wrap(constant(0.3), 5)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    params0 = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    n_leaves = len(params0)
    gen = torch.Generator().manual_seed(0)
    seeds = [leaf_seeds(gen, n, n_leaves, "cpu", micro) for _ in range(2)]
    runs = {}
    for device in (torch.device("cpu"), dev):
        art = build_train_step(cfg, shape, n_workers=n, compressor=comp, base_opt=opt,
                               lr_schedule=sched, clip_norm=1.0, microbatches=micro,
                               param_dtype=torch.float32, device=device)
        p = {k: v.to(device) for k, v in params0.items()}
        o, cs = build_init_state(p, n_workers=n, compressor=comp, base_opt=opt)
        losses, states = [], []
        for i in range(2):
            if i == 1:
                ops.reset_launch_counts()
            fn = art.steps["exact" if i == 0 else "compressed"]
            p, o, cs, loss, met = fn(p, o, cs, i, data.batch(i, 0, device=device),
                                     seeds[i].to(device))
            losses.append(float(loss))
            states.append(cs)
        runs[device.type] = (losses, states[0], ops.launch_counts(), art.layout)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=2e-2)
    counts = runs["cuda"][2]
    assert counts["int_compress"] == counts["pack_words"] == micro * n * n_leaves
    assert counts["unpack_words"] == micro * n_leaves
    assert counts["block_norms"] == 2 * n_leaves
    assert all(counts[k] == 0 for k in counts if k.startswith("fused_"))

    # the pipelined round of step 1 on fixed gradients (the CPU's backward)
    layout = runs["cpu"][3]
    batch = data.batch(1, 0, device="cpu")
    grads = [[_forward_backward(layout, params0, _microbatch(_microbatch(batch, w, n), m, micro))[1]
              for w in range(n)] for m in range(micro)]
    alpha_cpu = runs["cpu"][1]
    rounds = {}
    for device in (torch.device("cpu"), dev):
        ctx = CommCtx(n_workers=n)
        st = AlphaState(r=alpha_cpu.r.to(device), step=alpha_cpu.step.to(device))
        eta = sched(1, device)
        images, sums, acc, alphas = [], [], None, {}
        for m in range(micro):
            def gen_images():
                for w in range(n):
                    ints, a = comp.encode_ints(
                        st, {k: g.to(device) for k, g in grads[m][w].items()},
                        seeds=seeds[1][m].to(device), eta=eta, ctx=ctx.at_worker(w),
                        dims=layout.dims, n_accum=micro)
                    alphas.update(a)
                    images.append({k: v.cpu() for k, v in ints.items()})
                    yield ints

            _, int_sum = ctx.psum_wire(gen_images(), comp.wire_format)
            sums.append({k: v.cpu() for k, v in int_sum.items()})
            acc = int_sum if acc is None else {k: acc[k] + v for k, v in int_sum.items()}
        ghat, _ = comp.finish_pipelined(st, acc, None, alphas, ctx=ctx, n_accum=micro)
        rounds[device.type] = (images, sums, {k: v.cpu() for k, v in acc.items()},
                               {k: v.cpu() for k, v in ghat.items()})
    for got, want in zip(rounds["cuda"][:2], rounds["cpu"][:2]):
        for g_tree, w_tree in zip(got, want):
            assert all(torch.equal(g_tree[k], w_tree[k]) for k in w_tree)
    acc_gpu, acc_cpu = rounds["cuda"][2], rounds["cpu"][2]
    assert all(torch.equal(acc_gpu[k], acc_cpu[k]) for k in acc_cpu)
    assert any(bool(v.any()) for v in acc_cpu.values())
    assert all(torch.equal(rounds["cuda"][3][k], rounds["cpu"][3][k]) for k in acc_cpu)


def _cuda_ranks_drive(group, rank, corner):
    """Three steps of a smoke corner on ``group`` (gloo ranks sharing
    cuda:0, or the local backend with ``group`` None); per step the loss
    and the params, and the rank's kernel launch counts."""
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.launch.train import train_loop

    opt, compressor, wire, fused, micro, overlap = corner
    cfg = smoke_config(get_arch("granite-8b"))
    ops.reset_launch_counts()
    params_by_step = []
    _, history = train_loop(
        cfg, ShapeConfig("t", 32, 2 * micro, "train"), n_workers=2, compressor=compressor,
        wire=wire, steps=3, lr=0.3 if opt == "sgd" else 3e-4, log_every=100, seed=1,
        fused=fused, microbatches=micro, opt=opt, device="cuda:0", group=group,
        overlap=overlap, bucket_words=1000,
        on_step=lambda i, p: params_by_step.append({k: v.cpu() for k, v in p.items()}),
    )
    return [r["loss"] for r in history], params_by_step, ops.launch_counts()


@pytest.mark.parametrize("corner", [
    ("adamw", "intdiana", "dense8", False, 2, "off"),
    ("sgd", "intsgd8_packed", "packed8", True, 1, "ring"),
])
def test_two_gloo_ranks_on_the_card_agree_bit_for_bit(dev, corner):
    """Two gloo ranks sharing the card: the same params on both after every
    step (int8 lanes and int32 words through gloo's CUDA path), losses
    within 1e-2 of the local backend at n = 2 on the card (its bf16
    backward is not bit-reproducible), and each rank launching one worker's
    share of the encode kernel."""
    from repro_torch.parallel.spawn import run_ranks

    ranks = run_ranks(_cuda_ranks_drive, 2, args=(corner,))
    local_losses, _, local_counts = _cuda_ranks_drive(None, 0, corner)
    for step in range(3):
        a, b = ranks[0][1][step], ranks[1][1][step]
        assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_allclose(ranks[0][0], local_losses, rtol=1e-2)
    for _, _, counts in ranks:
        assert 2 * counts["int_compress"] == local_counts["int_compress"] > 0
        assert counts["block_norms"] == local_counts["block_norms"] > 0


def _nccl_one_rank(group, rank):
    from repro_torch.parallel.collectives import group_backend

    dev = torch.device("cuda", 0)
    words = torch.tensor([2**31 - 1, -(2**31), 7], dtype=torch.int32, device=dev)
    lanes = torch.tensor([127, -127, 3], dtype=torch.int8, device=dev)
    got = psum_wire_words([{"words": words, "lanes": lanes}], group)
    return group_backend(group), got["words"], got["lanes"], words, lanes


def test_one_rank_nccl_group_passes_int32_and_int8_payloads(dev):
    from repro_torch.parallel.spawn import run_ranks

    ((backend, words_sum, lanes_sum, words, lanes),) = run_ranks(
        _nccl_one_rank, 1, backend="nccl", device="cuda:0")
    assert backend == "nccl"
    assert torch.equal(words_sum, words) and torch.equal(lanes_sum, lanes)


# ---------------------------------------------------------------------------
# the sparse wire: deterministic top-k and TopKInt on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 1 << 20, (1 << 24) - 3])
def test_select_topk_on_a_tied_image_matches_the_cpu(dev, k):
    """Values in -3..3 over 2^24 + 5 elements: the ties decide the
    selection, which must be the CPU's (lowest indices first), bit for bit
    and in the same order."""
    from repro_torch.wire.topk import select_topk

    rng = np.random.default_rng(k)
    v = torch.from_numpy(rng.integers(-3, 4, (1 << 24) + 5).astype(np.int32)).abs()
    got = select_topk(v.to(dev), k)
    want = select_topk(v, k)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    # the kept ties are the lowest-indexed ones
    t = int(v[want[-1]])
    tied = (v == t).nonzero().reshape(-1)
    kept = want[v[want] == t]
    torch.testing.assert_close(torch.sort(kept).values, tied[:kept.numel()], rtol=0, atol=0)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("stochastic", [True, False])
def test_topkint_encode_and_planes_match_plain(dev, bits, stochastic):
    """TopKInt's encode launches the encode kernel with n_workers=1 (the
    full range), equal to the plain version; pack, unpack and local_image
    on the card equal the CPU's."""
    from repro_torch.wire import TopKInt

    wf = TopKInt(bits=bits, k=777)
    rng = np.random.default_rng(bits)
    x = torch.from_numpy((rng.standard_normal((300, 701)) * 3).astype(np.float32))
    alpha, seed = torch.tensor(11.5), torch.tensor(-42, dtype=torch.int32)
    before = ops.int_compress.launches
    got = wf.encode(x.to(dev), alpha.to(dev), seed.to(dev), n_workers=4, stochastic=stochastic)
    assert ops.int_compress.launches == before + 1
    want = wf.encode(x, alpha, seed, n_workers=4, stochastic=stochastic)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    payload, cpu_payload = wf.pack(got, n_workers=4), wf.pack(want, n_workers=4)
    for plane in ("idx", "vals"):
        torch.testing.assert_close(payload[plane].cpu(), cpu_payload[plane], rtol=0, atol=0)
    stacked = {p: torch.stack([payload[p]] * 4) for p in payload}
    torch.testing.assert_close(
        wf.unpack(stacked, tuple(x.shape), n_summed=4).cpu(),
        4 * wf.local_image(want, n_workers=4), rtol=0, atol=0)


# the rest of the dense family at smoke widths, 2 layers, n = 2: config ->
# (fused, optimizer, param dtype, sequence length)
DENSE_PATHS = {
    "qwen2.5-32b": (True, "sgd", torch.bfloat16, 32),
    "minitron-4b": (False, "adamw", torch.float32, 32),
    "h2o-danube-3-4b": (False, "sgd", torch.float32, 160),
    "internvl2-2b": (False, "sgd", torch.float32, 32),
}


@pytest.mark.parametrize("name", list(DENSE_PATHS))
def test_dense_config_steps_on_the_card_match_the_cpu(dev, name):
    """Two steps (exact, compressed; IntSGD on packed8) on the card and on
    the CPU from the same weights, batches and seeds: losses within rtol
    2e-2 (the bf16 backward differs), and the compressed step's launches
    on the card as the route implies (one encode and pack per worker and
    leaf, one unpack per leaf; the fused update per leaf on the fused
    route, block_norms twice per leaf)."""
    _config_steps_card_vs_cpu(dev, name, *DENSE_PATHS[name])


# the moe family the same way: mixtral fused with bf16 params (its router
# stays float32), deepseek (MLA, shared experts) on ZeRO-1 AdamW
MOE_PATHS = {
    "mixtral-8x22b": (True, "sgd", torch.bfloat16, 80),
    "deepseek-v2-lite-16b": (False, "adamw", torch.float32, 32),
}


@pytest.mark.parametrize("name", list(MOE_PATHS))
def test_moe_config_steps_on_the_card_match_the_cpu(dev, name):
    """As the dense configs' two steps; the card's and the CPU's bf16
    activations may route a near-tie apart, which the loss tolerance
    absorbs."""
    _config_steps_card_vs_cpu(dev, name, *MOE_PATHS[name])


# the hybrid family (zamba2 smoke: 4 Mamba2 layers in two blocks, the shared
# attention block after each): route -> (fused, optimizer, param dtype,
# sequence length); at T = 512 the SSD runs two chunks of 256
HYBRID_PATHS = {
    "fused-sgd-bf16": (True, "sgd", torch.bfloat16, 32),
    "zero1-adamw-t512": (False, "adamw", torch.float32, 512),
}


@pytest.mark.parametrize("route", list(HYBRID_PATHS))
def test_hybrid_steps_on_the_card_match_the_cpu(dev, route):
    """zamba2's smoke config the same way as the dense configs' two
    steps, at its full smoke depth (n_layers 4, attn_every 2)."""
    _config_steps_card_vs_cpu(dev, "zamba2-2.7b", *HYBRID_PATHS[route], layers=4)


@pytest.mark.parametrize("t,chunk", [(32, 8), (64, 256)])
def test_mamba2_on_the_card_matches_the_cpu(dev, t, chunk):
    """One Mamba2 layer at the smoke widths (2 heads of 64, state 16) in
    float32, forward and backward, chunk 8 over T = 32 (the state carried
    across four chunks) and one chunk of 64, on the card against the CPU
    (TF32 off, as the train step sets it)."""
    from repro_torch.models import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(8)
    d, h, hd, n = 64, 2, 64, 16
    shapes = {"w_xz": (d, 2 * h * hd), "w_bc": (d, 2 * n), "w_dt": (d, h),
              "conv_w": (ssm.CONV_K, h * hd), "w_out": (h * hd, d)}
    p = {k: torch.randn(s, generator=g) / s[0] ** 0.5 for k, s in shapes.items()}
    p.update(dt_bias=-4.0 + torch.rand(h, generator=g), a_log=torch.randn(h, generator=g) / 2,
             d_skip=torch.randn(h, generator=g), norm_w=torch.ones(h * hd))
    x = torch.randn(2, t, d, generator=g)
    cot = torch.randn(2, t, d, generator=g)
    outs = {}
    for device in ("cpu", dev):
        pp = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
        xx = x.to(device).requires_grad_(True)
        out = ssm.mamba2_train(pp, xx, n_heads=h, head_dim=hd, d_state=n, chunk=chunk)
        grads = torch.autograd.grad((out * cot.to(device)).sum(), [xx, *pp.values()])
        outs[str(device)] = (out.detach().cpu(), [gr.cpu() for gr in grads])
    (o_c, g_c), (o_g, g_g) = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(o_g, o_c, rtol=1e-4, atol=1e-5)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


# the ssm family (xlstm smoke: one (m, m, s) block, tied embeddings) the same
# way; at T = 512 the mLSTM runs two chunks of 256
XLSTM_PATHS = {
    "fused-sgd-bf16": (True, "sgd", torch.bfloat16, 32),
    "zero1-adamw-t512": (False, "adamw", torch.float32, 512),
}


@pytest.mark.parametrize("route", list(XLSTM_PATHS))
def test_xlstm_steps_on_the_card_match_the_cpu(dev, route):
    """xlstm-125m's smoke config the same way as the dense configs' two
    steps, at its smoke depth (n_layers 3: 24 leaves, no lm_head)."""
    _config_steps_card_vs_cpu(dev, "xlstm-125m", *XLSTM_PATHS[route], layers=3)


def _xlstm_cell_card_vs_cpu(dev, cell, t, **kw):
    """One mLSTM or sLSTM cell at the smoke widths (4 heads of 16, d_model
    64) in float32, forward and backward under a random cotangent, on the
    card against the CPU (TF32 off, as the train step sets it): the output
    to rtol 1e-4, atol 1e-5, each gradient to atol 1e-5 of its largest
    |g|."""
    from repro_torch.models import xlstm

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(9)
    d, h, hd = 64, 4, 16
    dk = h * hd
    if cell == "mlstm":
        shapes = {"w_q": (d, dk), "w_k": (d, dk), "w_v": (d, dk), "w_if": (d, 2 * h),
                  "w_out": (dk, d)}
        extra = dict(if_bias=torch.tensor([-2.0] * h + [3.0] * h) + torch.rand(2 * h, generator=g))
        fn = xlstm.mlstm_train
    else:
        shapes = {"w_in": (d, 4 * dk), "r_h": (h, hd, 4 * hd), "w_out": (dk, d)}
        extra = dict(b=torch.randn(4 * dk, generator=g) / 2)
        fn = xlstm.slstm_train
    p = {k: (torch.rand(s, generator=g) * 2 - 1) / s[-2] ** 0.5 for k, s in shapes.items()}
    p.update(extra, norm_w=1.0 + torch.randn(dk, generator=g) / 5)
    x = torch.randn(2, t, d, generator=g)
    cot = torch.randn(2, t, d, generator=g)
    outs = {}
    for device in ("cpu", dev):
        pp = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
        xx = x.to(device).requires_grad_(True)
        out = fn(pp, xx, n_heads=h, head_dim=hd, **kw)
        grads = torch.autograd.grad((out * cot.to(device)).sum(), [xx, *pp.values()])
        outs[str(device)] = (out.detach().cpu(), [gr.cpu() for gr in grads])
    (o_c, g_c), (o_g, g_g) = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(o_g, o_c, rtol=1e-4, atol=1e-5)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.parametrize("t,chunk", [(64, 16), (512, 256)])
def test_mlstm_on_the_card_matches_the_cpu(dev, t, chunk):
    """mlstm_train in chunks of 16 over T = 64 (C and n carried across four
    chunks) and two chunks of 256."""
    _xlstm_cell_card_vs_cpu(dev, "mlstm", t, chunk=chunk)


@pytest.mark.parametrize("t", [32, 200])
def test_slstm_on_the_card_matches_the_cpu(dev, t):
    """slstm_train over 32 and 200 time steps."""
    _xlstm_cell_card_vs_cpu(dev, "slstm", t)


def test_sqrt_on_the_card_is_correctly_rounded(dev):
    """``kernels.ref.sqrt_rn`` takes the plain AdamW passes' root through
    float64 on the CPU only: on the card ``torch.sqrt`` of float32 must be
    the correctly rounded root already (the fused kernels' ``sqrtf`` is),
    bit-equal to the float64 root rounded to float32."""
    from repro_torch.kernels.ref import sqrt_rn

    g = torch.Generator().manual_seed(11)
    x = torch.cat([10.0 ** (torch.rand(1 << 20, generator=g) * 60 - 30),
                   torch.rand(1 << 20, generator=g) * 1e-10]).to(dev)
    got = sqrt_rn(x)
    torch.testing.assert_close(got, torch.sqrt(x.double()).float(), rtol=0, atol=0)


# the encdec family (seamless-m4t smoke: 2 encoder and 2 decoder layers, 37
# leaves, the frames bf16) the same way
ENCDEC_PATHS = {
    "fused-sgd-bf16": (True, "sgd", torch.bfloat16, 32),
    "zero1-adamw-t200": (False, "adamw", torch.float32, 200),
}


@pytest.mark.parametrize("route", list(ENCDEC_PATHS))
def test_encdec_steps_on_the_card_match_the_cpu(dev, route):
    """seamless-m4t-medium's smoke config the same way as the dense
    configs' two steps (frames, tokens and labels from
    ``materialize_batch``)."""
    _config_steps_card_vs_cpu(dev, "seamless-m4t-medium", *ENCDEC_PATHS[route])


@pytest.mark.parametrize("tq,tk", [(64, 200), (200, 64), (33, 33)])
def test_unmasked_attention_on_the_card_matches_the_cpu(dev, tq, tk):
    """``gqa_attend(causal=False)`` (the encoder's and the cross attention's
    case, Tq != Tk) in float32 through the pinned memory-efficient SDPA on
    the card against the CPU, forward and backward, 4 query heads on 2 KV
    heads."""
    from repro_torch.models.attention import gqa_attend

    g = torch.Generator().manual_seed(10)
    q = torch.randn(2, tq, 4, 64, generator=g)
    k, v = (torch.randn(2, tk, 2, 64, generator=g) for _ in range(2))
    cot = torch.randn(2, tq, 256, generator=g)
    outs = {}
    for device in ("cpu", dev):
        args = [a.to(device).requires_grad_(True) for a in (q, k, v)]
        out = gqa_attend(*args, causal=False)
        grads = torch.autograd.grad((out * cot.to(device)).sum(), args)
        outs[str(device)] = (out.detach().cpu(), [gr.cpu() for gr in grads])
    (o_c, g_c), (o_g, g_g) = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(o_g, o_c, rtol=1e-4, atol=1e-5)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(float(b.abs().max()), 1.0))


@pytest.mark.parametrize("seq", [24, 200])
def test_encdec_loss_on_the_card_matches_the_cpu(dev, seq):
    """seamless-m4t-medium's smoke model in float32 (TF32 off): the encoder
    states within 1e-4 of their largest |h|, the loss within 1e-5
    relative, and every gradient leaf within 1e-4 of its largest |g|, on
    the card against the CPU."""
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.launch.inputs import materialize_batch
    from repro_torch.models import encdec

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(get_arch("seamless-m4t-medium"))
    params = encdec.init_encdec_params(cfg, generator=torch.Generator().manual_seed(0),
                                       device="cpu")
    batch = materialize_batch(cfg, ShapeConfig("t", seq, 2, "train"),
                              torch.Generator().manual_seed(1), "cpu")
    outs = {}
    for device in ("cpu", dev):
        p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        b = {k: v.to(device) for k, v in batch.items()}
        h = encdec.encode(p, b["frames"], cfg, torch.float32)
        loss = encdec.encdec_loss(p, b, cfg, torch.float32)
        grads = torch.autograd.grad(loss, list(p.values()))
        outs[str(device)] = (h.detach().cpu(), loss.item(), [gr.cpu() for gr in grads])
    (h_c, l_c, g_c), (h_g, l_g, g_g) = outs["cpu"], outs[str(dev)]
    assert float((h_g - h_c).abs().max()) < 1e-4 * float(h_c.abs().max())
    np.testing.assert_allclose(l_g, l_c, rtol=1e-5)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * max(float(b.abs().max()), 1e-6))


def _config_steps_card_vs_cpu(dev, name, fused, opt_name, dtype, seq, layers=2):
    import dataclasses

    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.launch.inputs import materialize_batch
    from repro_torch.launch.step import build_init_state, build_train_step
    from repro_torch.models.encdec import init_encdec_params
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.adamw import adamw
    from repro_torch.optim.sgd import sgd

    cfg = dataclasses.replace(smoke_config(get_arch(name)), n_layers=layers)
    n = 2
    shape = ShapeConfig("t", seq, 2 * n, "train")
    comp = make_compressor("intsgd8_packed")
    opt = sgd(momentum=0.9, weight_decay=1e-4) if opt_name == "sgd" else adamw(weight_decay=1e-4)
    init = init_encdec_params if cfg.family == "encdec" else init_lm_params
    params0 = init(cfg, generator=torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    n_leaves = len(params0)
    batches = [materialize_batch(cfg, shape, torch.Generator().manual_seed(i), "cpu")
               for i in range(2)]
    gen = torch.Generator().manual_seed(0)
    seeds = [leaf_seeds(gen, n, n_leaves, "cpu") for _ in range(2)]
    runs = {}
    for device in (torch.device("cpu"), dev):
        art = build_train_step(cfg, shape, n_workers=n, compressor=comp, base_opt=opt,
                               lr_schedule=lambda i, d: torch.full((), 0.1, device=d),
                               clip_norm=1.0, param_dtype=dtype, fused=fused, device=device)
        p = {k: v.to(device) for k, v in params0.items()}
        o, cs = build_init_state(p, n_workers=n, compressor=comp, base_opt=opt, fused=fused)
        losses = []
        for i in range(2):
            if i == 1:
                ops.reset_launch_counts()
            fn = art.steps["exact" if i == 0 else "compressed"]
            p, o, cs, loss, met = fn(p, o, cs, i, {k: v.to(device) for k, v in batches[i].items()},
                                     seeds[i].to(device))
            losses.append(float(loss))
        assert all(torch.isfinite(v).all() for v in p.values())
        runs[device.type] = (losses, ops.launch_counts())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=2e-2)
    counts = runs["cuda"][1]
    assert counts["int_compress"] == counts["pack_words"] == n * n_leaves
    assert counts["unpack_words"] == n_leaves
    kern = f"fused_unpack_{opt_name}"
    assert counts[kern] == (n_leaves if fused else 0)
    assert counts["block_norms"] == 2 * n_leaves


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("skew", [False, True])
def test_smoke_moe_block_on_the_card_matches_the_cpu(dev, name, skew):
    """The smoke config's MoE block (deepseek with its shared expert) in
    float32, forward and backward, on the card against the CPU. Inputs and
    router are k/4 and k/8 for small integers k, so the float32 logits are
    exact on both and the same experts are chosen; with ``skew`` expert 0
    draws every token and tokens past its capacity are dropped (the same
    ones on both)."""
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_lm_params

    cfg = smoke_config(get_arch(name))
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    p = {k[len("layers/moe/"):]: v[0] for k, v in params.items() if "/moe/" in k}
    g = torch.Generator().manual_seed(2)
    p["router"] = torch.randint(-8, 9, p["router"].shape, generator=g).float() / 8
    x = torch.randint(-8, 9, (2, 48, cfg.d_model), generator=g).float() / 4
    if skew:
        x, p["router"][:, 0] = x.abs(), 1.0
    cot = torch.randn(x.shape, generator=g)
    runs = {}
    for device in ("cpu", dev):
        pp = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
        xx = x.to(device).requires_grad_(True)
        out = moe.moe_tp(pp, xx, n_experts=cfg.n_experts, top_k=cfg.top_k)
        grads = torch.autograd.grad((out * cot.to(device)).sum(), [xx, *pp.values()])
        _, ids = moe.route(pp["router"], xx.reshape(-1, cfg.d_model), cfg.top_k)
        _, slot, keep = moe.dispatch_indices(ids, cfg.n_experts,
                                             moe.capacity(96, cfg.top_k, cfg.n_experts))
        runs[str(device)] = [t.detach().cpu() for t in (out, *grads, ids, slot, keep)]
    cpu, card = runs["cpu"], runs[str(dev)]
    for a, b in zip(card[-3:], cpu[-3:]):
        assert torch.equal(a, b)
    assert bool(cpu[-1].all()) != skew
    for a, b in zip(card[:-3], cpu[:-3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", [64, 200])
def test_mla_on_the_card_matches_the_cpu(dev, t):
    """deepseek's MLA head shape (128 content + 64 rotary dims: q and k of
    192, v of 128) with 4 heads, float32, forward and backward through the
    pinned memory-efficient backend, against the CPU."""
    from repro_torch.models.mla import DH_ROPE, mla_train

    g = torch.Generator().manual_seed(6)
    d, h, hd, lora = 96, 4, 128, 64
    shapes = {"w_dkv": (d, lora), "w_kr": (d, DH_ROPE), "w_q": (d, h * (hd + DH_ROPE)),
              "w_uk": (lora, h * hd), "w_uv": (lora, h * hd), "wo": (h * hd, d)}
    p = {k: torch.randn(s, generator=g) / s[0] ** 0.5 for k, s in shapes.items()}
    x = torch.randn(2, t, d, generator=g)
    outs = {}
    for device in ("cpu", dev):
        pp = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
        out = mla_train(pp, x.to(device), torch.arange(t, device=device).expand(2, t),
                        n_heads=h, head_dim=hd)
        grads = torch.autograd.grad(out.square().sum(), list(pp.values()))
        outs[str(device)] = (out.detach().cpu(), [gr.cpu() for gr in grads])
    (o_c, g_c), (o_g, g_g) = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(o_g, o_c, rtol=1e-4, atol=1e-4)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("window", [None, 64])
def test_windowed_attention_on_the_card_matches_the_cpu(dev, window):
    """h2o-danube's attention shape (head_dim 120, GQA 32/8, shrunk to 8/2
    heads) at T = 256 in float32, forward and backward, through the pinned
    memory-efficient backend on the card, against the CPU."""
    from repro_torch.models.attention import attention_train

    g = torch.Generator().manual_seed(5)
    d, hq, hkv, dh, t = 96, 8, 2, 120, 256
    p = {"wq": torch.randn(d, hq * dh, generator=g) / d ** 0.5,
         "wk": torch.randn(d, hkv * dh, generator=g) / d ** 0.5,
         "wv": torch.randn(d, hkv * dh, generator=g) / d ** 0.5,
         "wo": torch.randn(hq * dh, d, generator=g) / (hq * dh) ** 0.5,
         "bq": torch.randn(hq * dh, generator=g) * 0.1,
         "bk": torch.randn(hkv * dh, generator=g) * 0.1,
         "bv": torch.randn(hkv * dh, generator=g) * 0.1}
    x = torch.randn(2, t, d, generator=g)
    outs = {}
    for device in ("cpu", dev):
        pp = {k: v.clone().to(device).requires_grad_(True) for k, v in p.items()}
        xx = x.to(device)
        out = attention_train(pp, xx, torch.arange(t, device=device).expand(2, t),
                              n_heads=hq, n_kv_heads=hkv, head_dim=dh, rope_theta=1e6,
                              window=window)
        grads = torch.autograd.grad(out.square().sum(), list(pp.values()))
        outs[str(device)] = (out.detach().cpu(), [gr.cpu() for gr in grads])
    (o_c, g_c), (o_g, g_g) = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(o_g, o_c, rtol=1e-4, atol=1e-4)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def test_checkpoint_of_card_state_round_trips(dev, tmp_path):
    """bf16 params, f32 optimizer rows and an AlphaState on the card: saved
    (async), restored onto the card bit for bit."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.scaling import AlphaState

    g = torch.Generator(device=dev).manual_seed(3)
    tree = {"params": {"w": torch.randn(1000, 33, generator=g, device=dev).to(torch.bfloat16)},
            "opt": {"master": {"w": torch.randn(4, 8250, generator=g, device=dev)}},
            "comp": AlphaState(r=torch.tensor(2.5, device=dev),
                               step=torch.tensor(7, dtype=torch.int32, device=dev))}
    store = CheckpointStore(str(tmp_path))
    store.save(3, tree)
    store.wait()
    like = {"params": {"w": torch.zeros(1000, 33, dtype=torch.bfloat16, device=dev)},
            "opt": {"master": {"w": torch.zeros(4, 8250, device=dev)}},
            "comp": AlphaState(r=torch.zeros((), device=dev),
                               step=torch.zeros((), dtype=torch.int32, device=dev))}
    got, _, step = store.restore(like)
    store.close()
    assert step == 3 and got["params"]["w"].device.type == "cuda"
    assert torch.equal(got["params"]["w"].view(torch.int16), tree["params"]["w"].view(torch.int16))
    assert torch.equal(got["opt"]["master"]["w"], tree["opt"]["master"]["w"])
    assert torch.equal(got["comp"].r, tree["comp"].r) and int(got["comp"].step) == 7


@pytest.mark.parametrize("name", ["granite-8b", "h2o-danube-3-4b", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_decode_on_the_card_matches_the_cpu(dev, name):
    """``lm_decode_step`` (smoke widths, float32) for 6 steps of 3
    sequences on the card and on the CPU from the same weights: logits
    within 1e-5 of the largest |logit|, the caches within 1e-5 of their
    largest |value|, kv_pos equal, the greedy tokens equal."""
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.models.decode import init_lm_cache, lm_decode_step, tp_greedy
    from repro_torch.models.transformer import init_lm_params

    cfg = smoke_config(get_arch(name))
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (6, 3), generator=torch.Generator().manual_seed(3))
    runs = {}
    for device in ("cpu", dev):
        p = {k: v.to(device) for k, v in params.items()}
        cache = init_lm_cache(cfg, 3, 16, device=device, dtype=torch.float32)
        logits = []
        for t in range(6):
            out, cache = lm_decode_step(p, cache, tokens[t].to(device),
                                        torch.full((3,), t, device=device), cfg,
                                        dtype=torch.float32)
            logits.append(out.cpu())
        runs[str(device)] = torch.stack(logits), {k: v.cpu() for k, v in cache.items()}
    (l_c, c_c), (l_g, c_g) = runs["cpu"], runs[str(dev)]
    big = l_c.abs().max().item()
    torch.testing.assert_close(l_g, l_c, rtol=0, atol=1e-5 * big)
    assert torch.equal(tp_greedy(l_g), tp_greedy(l_c))
    for k in c_c:
        if k.endswith("kv_pos"):
            assert torch.equal(c_g[k], c_c[k]), k
        else:
            torch.testing.assert_close(c_g[k], c_c[k], rtol=0,
                                       atol=1e-5 * c_c[k].abs().max().item())


def _recurrent_step_case(name):
    """(port step, weights, random nonzero state) of one recurrent decode
    step at the smoke widths (d 64, 4 heads; Mamba2 2 heads of 64, N 16)."""
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.common import dense_init

    g = torch.Generator().manual_seed(6)
    d, h, dh = 64, 4, 16
    w = lambda *shape: dense_init(shape, shape[-2], generator=g, device="cpu")
    if name == "mamba2":
        hm, pm, n = 2, 64, 16
        di = hm * pm
        p = {"w_xz": w(d, 2 * di), "w_bc": w(d, 2 * n), "w_dt": w(d, hm),
             "dt_bias": torch.full((hm,), -4.0), "conv_w": w(ssm.CONV_K, di),
             "a_log": torch.zeros(hm), "d_skip": torch.ones(hm), "norm_w": torch.ones(di),
             "w_out": w(di, d)}
        state = {"conv": torch.randn(3, ssm.CONV_K - 1, di, generator=g),
                 "h": torch.randn(3, hm, n, pm, generator=g)}
        return lambda *a: ssm.mamba2_decode(*a, n_heads=hm, head_dim=pm, d_state=n), p, state
    dk = h * dh
    if name == "mlstm":
        p = {"w_q": w(d, dk), "w_k": w(d, dk), "w_v": w(d, dk), "w_if": w(d, 2 * h),
             "if_bias": torch.cat([torch.full((h,), -2.0), torch.full((h,), 3.0)]),
             "norm_w": torch.ones(dk), "w_out": w(dk, d)}
        state = {"C": torch.randn(3, h, dh, dh, generator=g),
                 "n": torch.randn(3, h, dh, generator=g)}
        return lambda *a: xlstm.mlstm_decode(*a, n_heads=h, head_dim=dh), p, state
    p = {"w_in": w(d, 4 * dk), "r_h": w(h, dh, 4 * dh), "b": torch.zeros(4 * dk),
         "norm_w": torch.ones(dk), "w_out": w(dk, d)}
    state = {"h": torch.randn(3, h, dh, generator=g), "c": torch.randn(3, h, dh, generator=g)}
    return lambda *a: xlstm.slstm_decode(*a, n_heads=h, head_dim=dh), p, state


@pytest.mark.parametrize("name", ["mamba2", "mlstm", "slstm"])
def test_recurrent_decode_step_on_the_card_matches_the_cpu(dev, name):
    """One float32 step of ``mamba2_decode``, ``mlstm_decode`` or
    ``slstm_decode`` from a random nonzero state, on the card and on the
    CPU: the output and the new state within 1e-5 of their largest |value|,
    the state written in place."""
    step, p, state = _recurrent_step_case(name)
    x = torch.randn(3, 1, 64, generator=torch.Generator().manual_seed(7))
    runs = {}
    for device in ("cpu", dev):
        cache = {k: v.to(device, copy=True) for k, v in state.items()}  # each run's own
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        out, new = step({k: v.to(device) for k, v in p.items()}, x.to(device), cache)
        assert new is cache and {k: v.data_ptr() for k, v in new.items()} == ptrs
        runs[str(device)] = out.cpu(), {k: v.cpu() for k, v in new.items()}
    (o_c, s_c), (o_g, s_g) = runs["cpu"], runs[str(dev)]
    torch.testing.assert_close(o_g, o_c, rtol=0, atol=1e-5 * o_c.abs().max().item())
    for k in s_c:
        torch.testing.assert_close(s_g[k], s_c[k], rtol=0, atol=1e-5 * s_c[k].abs().max().item())


def test_served_zamba2_step_on_the_card(dev):
    """The engine serves the zamba2-2.7b smoke model on the card (bf16
    activations and cache, float32 Mamba2 states): one step's logits
    finite, every token of two requests in the vocabulary."""
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.models.decode import lm_decode_step
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = smoke_config(get_arch("zamba2-2.7b"))
    params = init_lm_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    eng = ServeEngine(cfg, params, slots=2, max_seq=32, device=dev)
    with torch.no_grad():
        logits, _ = lm_decode_step(eng.params, eng.cache, torch.tensor([5, 6], device=dev),
                                   torch.zeros(2, dtype=torch.long, device=dev), cfg)
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    reqs = [Request(rid=i, prompt=[3 + i, 4, 5], max_new=4) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and all(0 <= t < cfg.vocab for t in r.out) for r in reqs)
    assert eng.cache["mamba/h"].dtype == torch.float32 and eng.cache["attn/k"].is_cuda


def test_encdec_decode_on_the_card_matches_the_cpu(dev):
    """seamless-m4t's smoke decode (float32): prefill from 24 frames and 6
    greedy steps of 3 sequences on the card and on the CPU, logits within
    1e-5 of the largest |logit|, the same greedy tokens."""
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.models import encdec
    from repro_torch.models.decode import tp_greedy

    cfg = smoke_config(get_arch("seamless-m4t-medium"))
    params = encdec.init_encdec_params(cfg, generator=torch.Generator().manual_seed(2),
                                       device="cpu")
    frames = torch.randn(3, 24, cfg.frontend_dim, generator=torch.Generator().manual_seed(3))
    runs = {}
    for device in ("cpu", dev):
        p = {k: v.to(device) for k, v in params.items()}
        cache = encdec.init_encdec_cache(cfg, 3, 8, 24, device=device, dtype=torch.float32)
        cache = encdec.encdec_prefill(p, frames.to(device), cache, cfg, torch.float32)
        tok, logits = torch.tensor([1, 2, 3], device=device), []
        for t in range(6):
            out, cache = encdec.encdec_decode_step(p, cache, tok, torch.full((3,), t,
                                                                              device=device),
                                                   cfg, dtype=torch.float32)
            tok = tp_greedy(out)
            logits.append(out.cpu())
        runs[str(device)] = torch.stack(logits)
    l_c, l_g = runs["cpu"], runs[str(dev)]
    torch.testing.assert_close(l_g, l_c, rtol=0, atol=1e-5 * l_c.abs().max().item())
    assert torch.equal(tp_greedy(l_g), tp_greedy(l_c))


def test_wire_delta_on_a_leaf_past_2_to_30_matches_plain(dev):
    """``ServeEngine.apply_wire_delta`` on one bf16 leaf of 2^30 + 4,099
    elements (the int64 index arithmetic of ``csrc/wire_pack.cu``): the
    ``unpack_words`` kernel path bit-equal to the plain path on the same
    packed8 words, one launch."""
    import types

    from repro_torch.serving.engine import ServeEngine
    from repro_torch.wire import PackedInt

    d = 2**30 + 4099
    wf = PackedInt(bits=8)
    g = torch.Generator(device=dev).manual_seed(1)
    p = torch.randn(d, generator=g, device=dev).to(torch.bfloat16)
    ints = torch.randint(-127, 128, (d,), generator=g, device=dev, dtype=torch.int32)
    words = ops.pack_words(ints, bits=8, n_workers=1)
    del ints
    alpha = torch.tensor(1000.0, device=dev)
    want = (p.float() + ops.unpack_words.plain(words, (d,), bits=8, n_summed=1).float()
            / (1 * alpha)).to(torch.bfloat16)
    eng = types.SimpleNamespace(params={"w": p})
    before = ops.unpack_words.launches
    ServeEngine.apply_wire_delta(eng, {"w": words}, alpha, wf)
    assert ops.unpack_words.launches == before + 1
    assert torch.equal(eng.params["w"].view(torch.int16), want.view(torch.int16))


def test_straggler_sum_launch_counts_on_the_card(dev):
    """packed8, 4 workers, 3 leaves, worker 2 late: 4 x 3 pack_words
    launches, 3 unpack_words launches, the sum equal to the alive images'
    sum, and dense8 (no pack or unpack kernel) equal to it."""
    from repro_torch.core.comm import CommCtx
    from repro_torch.runtime.straggler import straggler_tolerant_sum
    from repro_torch.wire import DenseInt, PackedInt

    g = torch.Generator(device=dev).manual_seed(4)
    shapes = {"a": (1000, 33), "b": (7,), "c": (4096,)}
    images = [{k: torch.randint(-31, 32, s, generator=g, device=dev, dtype=torch.int32)
               for k, s in shapes.items()} for _ in range(4)]
    alive = [True, True, False, True]
    ops.reset_launch_counts()
    s, n_live = straggler_tolerant_sum(images, alive, CommCtx(n_workers=4), PackedInt(bits=8))
    assert ops.pack_words.launches == 12 and ops.unpack_words.launches == 3
    assert int(n_live) == 3
    d, _ = straggler_tolerant_sum(images, alive, CommCtx(n_workers=4), DenseInt(bits=8))
    for k in shapes:
        want = sum(im[k] for im, a in zip(images, alive) if a)
        assert torch.equal(s[k], want) and torch.equal(d[k], want), k


# ---------------------------------------------------------------------------
# the model axis: psum_tp and all_to_all_tp on gloo ranks sharing the card
# ---------------------------------------------------------------------------
def _tp_primitives(group, rank, device):
    """psum_tp's forward and backward (each an all-reduce over the group)
    and all_to_all_tp's exchange and inverse, in float32 and bf16, on
    ``device``; everything returned on the CPU."""
    from repro_torch.parallel import collectives as coll

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(100 + rank)
        x = torch.randn(2, 3, 5, generator=g).to(device, dtype).requires_grad_(True)
        w = torch.randn(2, 3, 5, generator=g).to(device, dtype)
        y = coll.psum_tp(x, group)
        (gx,) = torch.autograd.grad(torch.sum(y * w), x)
        a = torch.randn(2, 4, 3, generator=g).to(device, dtype).requires_grad_(True)
        b = coll.all_to_all_tp(a, group)
        (ga,) = torch.autograd.grad(torch.sum(b * w[:, :1, :3]), a)
        out[str(dtype)] = [t.detach().cpu() for t in (y, gx, b, ga)]
    out["counts"] = coll.tp_counts()
    return out


def test_tp_primitives_on_two_gloo_ranks_sharing_the_card_match_the_cpu(dev):
    """psum_tp (its backward an all-reduce too) and all_to_all_tp (its
    backward the inverse exchange) on two gloo ranks with CUDA tensors,
    bit-equal to the same two ranks on the CPU (a sum of two addends is
    exact in either order), in float32 and bf16."""
    from repro_torch.parallel.spawn import run_ranks

    card = run_ranks(_tp_primitives, 2, args=("cuda:0",))
    cpu = run_ranks(_tp_primitives, 2, args=("cpu",))
    for c, h in zip(card, cpu):
        for dtype in ("torch.float32", "torch.bfloat16"):
            for got, want in zip(c[dtype], h[dtype]):
                assert got.dtype == want.dtype and torch.equal(got, want), dtype
        assert c["counts"] == h["counts"] == {"psum_tp": 2, "psum_tp_backward": 2,
                                              "all_to_all_tp": 2, "all_to_all_tp_backward": 2}
    # the sum is the same on both ranks
    assert torch.equal(cpu[0]["torch.float32"][0], cpu[1]["torch.float32"][0])


# ---------------------------------------------------------------------------
# tensor parallelism for the hybrid and ssm families on a 2 x 2 grid
# ---------------------------------------------------------------------------
# (arch, param type, fused, optimizer, lr, tolerance of the card-CPU loss gap)
TP_SMOKE = (("zamba2-2.7b", torch.bfloat16, True, "sgd", 0.3, 1e-2),
            ("xlstm-125m", torch.float32, False, "adamw", 3e-4, 1e-3))


def _tp_smoke_exact_step(group, rank, device):
    """This rank's exact-step loss of each ``TP_SMOKE`` smoke config on a
    2 x 2 grid, on the card and on the CPU (the same gloo groups), from
    the same params (the global draw on the CPU, the rank's shard), batch
    and seeds."""
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.step import build_init_state, build_train_step
    from repro_torch.launch.train import OPTIMIZERS
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.schedules import constant, warmup_wrap

    torch.cuda.set_device(device)
    grid = make_debug_mesh(2, 2)
    out = {}
    for arch, dtype, fused, opt, lr, _ in TP_SMOKE:
        cfg = smoke_config(get_arch(arch))
        shape = ShapeConfig("tp-smoke", 64, 2 * grid.n_dp, "train")
        params0 = specs.tp_shard(cfg, grid.tp, grid.tp_index).tree(init_lm_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu", dtype=dtype,
            tp=grid.tp))
        batch0 = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0).batch(0, 0)
        losses = []
        for d in (torch.device(device), torch.device("cpu")):
            comp, base_opt = make_compressor("intsgd8_packed"), OPTIMIZERS[opt]()
            art = build_train_step(
                cfg, shape, n_workers=grid.n_dp, compressor=comp, base_opt=base_opt,
                lr_schedule=warmup_wrap(constant(lr), 5), param_dtype=dtype, fused=fused,
                clip_norm=1.0, device=d, grid=grid)
            params = {k: v.to(d) for k, v in params0.items()}
            opt_state, comp_state = build_init_state(params, n_workers=grid.n_dp,
                                                     compressor=comp, base_opt=base_opt,
                                                     fused=fused, grid=grid)
            seeds = leaf_seeds(torch.Generator().manual_seed(0), grid.n_dp,
                               len(art.layout.names), d, 1)
            losses.append(float(art.steps["exact"](
                params, opt_state, comp_state, 0, {k: v.to(d) for k, v in batch0.items()},
                seeds)[3]))
        out[arch] = losses
    return out


def test_tp_hybrid_and_ssm_smoke_grids_card_against_cpu(dev):
    """zamba2's (bf16 params, fused SGD) and xlstm's (float32, ZeRO-1 AdamW)
    smoke configs on a 2 x 2 grid of gloo ranks: the exact step's loss on
    the card within 1e-2 (bf16) and 1e-3 (float32) of the same ranks' on
    the CPU. Tier-1 holds the CPU grid to JAX's TP step
    (``tests/test_torch_slice_tp_recurrent.py``)."""
    from repro_torch.parallel.spawn import run_ranks

    ranks = run_ranks(_tp_smoke_exact_step, 4, args=("cuda:0",))
    for arch, _, _, _, _, tol in TP_SMOKE:
        for r in ranks:
            card, cpu = r[arch]
            assert np.isfinite(card) and abs(card - cpu) / abs(cpu) < tol, (arch, card, cpu)
        # the dp replicas see their own halves of the batch: one model group's
        # members agree on the loss
        assert ranks[0][arch] == ranks[1][arch] and ranks[2][arch] == ranks[3][arch]


TP_DECODE_ARCHS = ("granite-8b", "deepseek-v2-lite-16b", "zamba2-2.7b", "xlstm-125m",
                   "seamless-m4t-medium")


def _tp_decode_card_cpu(group, rank, device):
    """One rank of a 2 x 2 grid: 6 teacher-forced decode steps of each
    ``TP_DECODE_ARCHS`` smoke config at tp = 2 (float32 activations and
    cache; seamless's cross cache prefilled from 16 frames a sequence) on
    the card and on the CPU, from the same shard of the same global params:
    {arch: (card logits, CPU logits, card tokens, CPU tokens)}."""
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import encdec
    from repro_torch.models.common import Axes
    from repro_torch.models.decode import init_lm_cache, lm_decode_step, tp_greedy
    from repro_torch.models.transformer import init_lm_params

    torch.cuda.set_device(device)
    grid = make_debug_mesh(2, 2)
    axes = Axes(group=grid.model_group, tp_size=2, tp_index=grid.tp_index)
    tokens = torch.randint(0, 256, (6, 4), generator=torch.Generator().manual_seed(2))
    rows = slice(2 * grid.dp_index, 2 * grid.dp_index + 2)
    out = {}
    for arch in TP_DECODE_ARCHS:
        cfg = smoke_config(get_arch(arch))
        enc = cfg.family == "encdec"
        init = encdec.init_encdec_params if enc else init_lm_params
        shard = specs.tp_shard(cfg, 2, grid.tp_index).tree(init(
            cfg, generator=torch.Generator().manual_seed(4), device="cpu", tp=2))
        res = []
        for d in (torch.device(device), torch.device("cpu")):
            params = {k: v.to(d) for k, v in shard.items()}
            if enc:
                frames = torch.randn(4, 16, cfg.frontend_dim,
                                     generator=torch.Generator().manual_seed(3))[rows]
                cache = encdec.init_encdec_cache(cfg, 2, 8, 16, device=d, dtype=torch.float32,
                                                 tp=2, n_shards=2)
                with torch.no_grad():
                    cache = encdec.encdec_prefill(params, frames.to(d), cache, cfg,
                                                  torch.float32, axes)
                step = encdec.encdec_decode_step
            else:
                cache = init_lm_cache(cfg, 2, 8, device=d, dtype=torch.float32, tp=2,
                                      n_shards=2)
                step = lm_decode_step
            logits, toks = [], []
            for i in range(tokens.shape[0]):
                with torch.no_grad():
                    lg, cache = step(params, cache, tokens[i, rows].to(d),
                                     torch.full((2,), i, device=d), cfg, torch.float32, axes)
                logits.append(lg.cpu())
                toks.append(tp_greedy(lg, axes).cpu())
            res += [torch.stack(logits), torch.stack(toks)]
        out[arch] = (res[0], res[2], res[1], res[3])
    return out


def test_tp_decode_step_card_against_cpu(dev):
    """The decode step of every family at tp = 2 (``lm_decode_step``, and
    seamless's ``encdec_prefill`` + ``encdec_decode_step``) on a 2 x 2 grid
    of gloo ranks sharing the card, float32: the vocab-local logits on the
    card within 1e-5 of the largest |logit| of the same ranks' on the CPU,
    the greedy tokens equal. Tier-1 holds the CPU decode to JAX's
    (``tests/test_torch_tp_serve.py``, ``test_torch_tp_serve_recurrent.py``)."""
    from repro_torch.parallel.spawn import run_ranks

    ranks = run_ranks(_tp_decode_card_cpu, 4, args=("cuda:0",))
    for arch in TP_DECODE_ARCHS:
        for r in ranks:
            card, cpu, t_card, t_cpu = r[arch]
            assert (card - cpu).abs().max() <= 1e-5 * cpu.abs().max(), arch
            assert torch.equal(t_card, t_cpu), arch
        assert torch.equal(ranks[0][arch][2], ranks[1][arch][2])


def _tp_ckpt_round_trip(group, rank, device, directory):
    """One rank: granite's smoke config, fused SGD on packed8, float32, on a
    2 x 2 grid on the card: 3 steps saving after the second, then a store
    on a fresh grid restoring it into a fresh state, and the third step
    resumed from it. Returns (the state at the save, the restored state,
    the uninterrupted losses, the resumed ones), on the host."""
    from repro_torch.checkpoint import CheckpointStore, flatten_state
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.core.compressor import make_compressor, with_wire
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.step import build_init_state
    from repro_torch.launch.train import OPTIMIZERS, train_loop
    from repro_torch.models.transformer import init_lm_params

    torch.cuda.set_device(device)
    cfg = smoke_config(get_arch("granite-8b"))
    spec = specs.infer_param_specs(cfg, 2)[2]
    kw = dict(n_workers=2, compressor="intsgd8_packed", wire="packed8", fused=True, steps=3,
              device=device, ckpt_every=2, log_every=100)
    shape = ShapeConfig("tp-ckpt", 32, 4, "train")
    saved = {}

    class Keep(CheckpointStore):
        def save(self, step, tree, extra=None):
            saved.update({k: v.cpu().clone() for k, v in flatten_state(tree).items()})
            super().save(step, tree, extra)

    grid = make_debug_mesh(2, 2)
    _, straight = train_loop(cfg, shape, grid=grid, ckpt=Keep(directory, grid=grid, specs=spec),
                             **kw)
    fresh = make_debug_mesh(2, 2)
    params = specs.tp_shard(cfg, 2, fresh.tp_index).tree(init_lm_params(
        cfg, generator=torch.Generator().manual_seed(9), device="cpu", tp=2))
    params = {k: v.to(device) for k, v in params.items()}
    opt_state, comp_state = build_init_state(
        params, n_workers=2, compressor=with_wire(make_compressor("intsgd8_packed"), "packed8"),
        base_opt=OPTIMIZERS["sgd"](), fused=True, grid=fresh)
    store = CheckpointStore(directory, grid=fresh, specs=spec)
    state, _, _ = store.restore({"params": params, "opt": opt_state, "comp": comp_state}, step=2)
    restored = {k: v.cpu() for k, v in flatten_state(state).items()}
    _, resumed = train_loop(cfg, shape, grid=fresh, ckpt=store, resume=True, **kw)
    return (saved, restored, [h["loss"] for h in straight], [h["loss"] for h in resumed],
            str(next(iter(state["params"].values())).device))


def test_tp_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A tp = 2 checkpoint on the card (a 2 x 2 grid of gloo ranks): every
    rank's restored state bit-equal to the one it saved, on the card, and
    the resumed third step's loss the uninterrupted run's. Tier-1 holds the
    layout to JAX's both ways (``tests/test_torch_tp_ckpt.py``)."""
    from repro_torch.parallel.spawn import run_ranks

    ranks = run_ranks(_tp_ckpt_round_trip, 4, args=("cuda:0", str(tmp_path)))
    for saved, restored, straight, resumed, where in ranks:
        assert where.startswith("cuda") and saved.keys() == restored.keys()
        for k, v in saved.items():
            assert v.dtype == restored[k].dtype and torch.equal(v, restored[k]), k
        assert len(straight) == 3 and resumed == straight[2:]
