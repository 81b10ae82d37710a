"""Port vs JAX: the compressed stage at n = 4 workers, and the codec layer
(packed words and dense lanes, each summed in its own integer type).

JAX side: ``IntSGD(bits=8, wire=PackedInt(8, use_kernels=True),
use_kernels=True).aggregate_wire`` under ``coll.vmap_workers`` with a
4-worker ``CommCtx`` (as ``core/simulate.py`` drives it), then
``kops.fused_unpack_apply(kernel="sgd")`` per leaf. Port side: the same
gradients, α state and per-(worker, leaf) seeds — computed in JAX as
``seed_from_key`` of ``_leaf_keys(fold_in(key, worker), grads)``.

Summed words and images must be bit-equal; α, params and momentum agree to
rtol=1e-6 (α is the same float32 ops in the same order; the update may
differ by an FMA contraction in XLA).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.comm import CommCtx as JCommCtx  # noqa: E402
from repro.core.compressor import IntSGD as JIntSGD, _leaf_keys  # noqa: E402
from repro.core.scaling import AlphaState as JAlphaState  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro.wire import DenseInt as JDenseInt, PackedInt as JPackedInt  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import make_compressor, with_wire  # noqa: E402
from repro_torch.core.scaling import AlphaState  # noqa: E402
from repro_torch.parallel.collectives import psum_wire_words  # noqa: E402
from repro_torch.wire import (  # noqa: E402
    DenseInt, PackedInt, WireRangeError, make_wire_format, wire_format_names,
)

N = 4
SHAPES = {"a": (300, 70), "b": (1000,), "c": (3, 5, 7), "d": (8, 128)}


def _jax_seeds(key, grads):
    rows = []
    for w in range(N):
        keys = jax.tree.leaves(_leaf_keys(jax.random.fold_in(key, w), grads))
        rows.append([int(kops.seed_from_key(k)) for k in keys])
    return np.array(rows, np.int32)


@pytest.mark.parametrize("r,step", [(0.0, 0), (2e-4, 3), (5e-2, 17)])
def test_compressed_stage_matches_jax_n4(r, step):
    rng = np.random.default_rng([int(r * 1e6), step])
    grads = {k: (rng.standard_normal((N, *s)) * 1e-2).astype(np.float32)
             for k, s in SHAPES.items()}
    p = {k: (rng.standard_normal(s) * 0.02).astype(np.float32) for k, s in SHAPES.items()}
    m = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32) for k, s in SHAPES.items()}
    eta = np.float32(0.3 * (min(step, 4) + 1) / 5)
    clip, lr, mu, wd = np.float32(0.57), eta, np.float32(0.9), np.float32(1e-4)
    key = jax.random.PRNGKey(step + 11)

    # ---- JAX: per-worker aggregate_wire under the worker vmap, then the
    # fused kernel per leaf
    jcomp = JIntSGD(bits=8, wire=JPackedInt(8, use_kernels=True), use_kernels=True)
    jctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))
    jstate = JAlphaState(r=jnp.float32(r), step=jnp.int32(step))

    def worker(g, k):
        wa, alphas, _, met = jcomp.aggregate_wire(jstate, g, key=k, eta=jnp.float32(eta), ctx=jctx)
        return wa.words, wa.ints, alphas, met.max_int

    jwords, jints, jalphas, jmax = jcoll.vmap_workers(worker, in_axes=(0, None))(
        {k: jnp.asarray(v) for k, v in grads.items()}, key
    )
    jp, jm = {}, {}
    for k in SHAPES:
        a = jalphas[k][0]
        sc = jnp.stack([1.0 / (N * a), jnp.float32(clip), jnp.float32(lr), mu, wd])
        jp[k], (jm[k],), _ = kops.fused_unpack_apply(
            jwords[k][0], jnp.asarray(p[k]), (jnp.asarray(m[k]),), sc,
            kernel="sgd", bits=8, n_summed=N,
        )

    # ---- port: the same inputs and seeds
    seeds = torch.from_numpy(_jax_seeds(key, {k: v[0] for k, v in grads.items()}))
    comp = make_compressor("intsgd8_packed")
    state = AlphaState(r=torch.tensor(np.float32(r)), step=torch.tensor(step, dtype=torch.int32))
    wa, alphas, _, met = comp.aggregate_wire(
        state, ({k: torch.from_numpy(v[w]) for k, v in grads.items()} for w in range(N)),
        seeds=seeds, eta=torch.tensor(eta), ctx=CommCtx(n_workers=N),
    )
    for k in SHAPES:
        np.testing.assert_array_equal(wa.words[k].numpy(), np.asarray(jwords[k][0]))
        np.testing.assert_array_equal(wa.ints[k].numpy(), np.asarray(jints[k][0]))
        np.testing.assert_allclose(alphas[k].numpy(), np.asarray(jalphas[k][0]), rtol=1e-6)
        sc = torch.stack([1.0 / (N * alphas[k]), torch.tensor(clip), torch.tensor(lr),
                          torch.tensor(mu), torch.tensor(wd)])
        gp, (gm,), _ = comp.wire_format.fused_update(
            wa.words[k], torch.from_numpy(p[k]), (torch.from_numpy(m[k]),), sc,
            kernel="sgd", n_summed=N,
        )
        np.testing.assert_allclose(gp.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(gm.numpy(), np.asarray(jm[k]), rtol=1e-6, atol=1e-9)
    assert float(met.max_int) == float(jmax[0])
    assert float(met.max_int) <= N * PackedInt(8).clip_limit(N)
    # the decode-here wrapper: ĝ = Σints / (nα), on the same inputs
    ghat, _, _ = comp.aggregate(
        state, ({k: torch.from_numpy(v[w]) for k, v in grads.items()} for w in range(N)),
        seeds=seeds, eta=torch.tensor(eta), ctx=CommCtx(n_workers=N),
    )
    for k in SHAPES:
        torch.testing.assert_close(ghat[k], wa.ints[k].float() / (N * alphas[k]), rtol=0, atol=0)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 128, 256, 4096, 40000])
def test_wire_range_error_on_the_same_pairs_as_jax(bits, n):
    try:
        want = JPackedInt(bits).clip_limit(n)
    except Exception as e:  # noqa: BLE001 — the JAX raise is the reference
        assert type(e).__name__ == "WireRangeError"
        with pytest.raises(WireRangeError):
            PackedInt(bits).clip_limit(n)
    else:
        assert PackedInt(bits).clip_limit(n) == want


def test_codec_registry_has_packed_only_and_says_what_is_not_ported():
    # every codec name of the JAX package is ported: the same registry, the
    # same parsed codecs, the same refusals
    from repro.wire import make_wire_format as jmake_wire, wire_format_names as jnames
    from repro_torch.wire import Logged, TopKInt

    assert wire_format_names() == jnames()
    assert make_wire_format("packed8") == PackedInt(bits=8)
    assert make_wire_format("dense8") == DenseInt(bits=8)
    for name in ("topk8:64", "topk16:5"):
        wf, jwf = make_wire_format(name), jmake_wire(name)
        assert isinstance(wf, TopKInt) and (wf.bits, wf.k) == (jwf.bits, jwf.k)
    logged = make_wire_format("logged:packed8")
    assert isinstance(logged, Logged) and logged.inner == PackedInt(bits=8)
    for bad in ("topk8", "topk8:", "topk8:x", "topk8:0", "topk4:8", "nope", "logged:nope"):
        with pytest.raises(ValueError):
            jmake_wire(bad)
        with pytest.raises(ValueError):
            make_wire_format(bad)
    with pytest.raises(ValueError, match="bits"):
        PackedInt(bits=32)
    with pytest.raises(ValueError, match="bit values"):
        DenseInt(bits=12)


def test_compressor_registry_and_bits_consistency():
    from repro.core.compressor import make_compressor as jmake

    comp = with_wire(make_compressor("intsgd", bits=8), "packed8")
    assert comp.wire_format == PackedInt(bits=8) and comp.fused_capable
    with pytest.raises(ValueError, match="8-bit"):
        with_wire(make_compressor("intsgd"), "packed8")
    # all 16 of the JAX package's names build, each the same class
    names = ["none", "allgather_sgd", "intsgd", "intsgd_determ", "intsgd_block", "intsgd4",
             "intsgd8", "intsgd8_packed", "intsgd4_packed", "heuristic_intsgd", "qsgd",
             "natsgd", "powersgd", "signsgd", "topk", "intdiana"]
    for name in names:
        assert type(make_compressor(name)).__name__ == type(jmake(name)).__name__, name
    with pytest.raises(ValueError, match="unknown compressor"):
        make_compressor("nope")
    # the bits check applies only to a compressor with a bits field: QSGD
    # takes a codec as is, the heuristic keeps its own 8-bit check
    assert with_wire(make_compressor("qsgd"), "packed8").wire == PackedInt(bits=8)
    with pytest.raises(ValueError, match="bits=8"):
        with_wire(make_compressor("heuristic_intsgd"), "packed16")
    with pytest.raises(ValueError, match="no wire-codec seam"):
        with_wire(make_compressor("topk"), "packed8")
    # without a codec IntSGD rides one dense lane per coordinate, as in JAX
    assert make_compressor("intsgd").wire_format == DenseInt(bits=32)
    assert make_compressor("intsgd8").wire_format == DenseInt(bits=8)


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_dense_lanes_and_dtypes_match_jax(bits):
    jwf, wf = JDenseInt(bits), DenseInt(bits)
    assert str(wf.lane_dtype).split(".")[1] == jnp.dtype(jwf.lane_dtype).name
    for size in (1, 7, 1000):
        assert wf.wire_bytes(size) == jwf.wire_bytes(size)
    img = torch.arange(-5, 5, dtype=torch.int32).reshape(2, 5)
    lanes = wf.pack(img, n_workers=1)
    assert lanes.dtype == wf.lane_dtype
    back = wf.unpack(lanes, (2, 5), n_summed=1)
    assert back.dtype == torch.int32 and torch.equal(back, img)
    assert wf.clip_limit(N) == jwf.clip_limit(N)


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_dense_psum_law_in_lane_dtype_matches_jax(bits):
    """unpack(Σ pack) == Σ ints at n = 4 with every worker at +lim and at
    -lim (the sum at ±n·lim, the lane's edge), summed in the lane type."""
    lim = DenseInt(bits).clip_limit(N)
    rng = np.random.default_rng(bits)
    images = rng.integers(-lim, lim + 1, (N, 3, 100)).astype(np.int32)
    images[:, 0, :] = lim
    images[:, 1, :50] = -lim
    jctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))
    jwords, jints = jcoll.vmap_workers(
        lambda x: jctx.psum_wire({"a": x}, JDenseInt(bits)), in_axes=0,
    )(jnp.asarray(images))
    words, ints = CommCtx(n_workers=N).psum_wire(
        ({"a": torch.from_numpy(images[w])} for w in range(N)), DenseInt(bits)
    )
    assert words["a"].dtype == DenseInt(bits).lane_dtype
    assert str(np.asarray(jwords["a"]).dtype) == str(words["a"].dtype).split(".")[1]
    np.testing.assert_array_equal(words["a"].numpy(), np.asarray(jwords["a"][0]))
    np.testing.assert_array_equal(ints["a"].numpy(), np.asarray(jints["a"][0]))
    assert torch.equal(ints["a"].to(torch.int64), torch.from_numpy(images.astype(np.int64).sum(0)))
    assert int(ints["a"].max()) == N * lim and int(ints["a"].min()) == -N * lim


def test_dense_word_sum_wraps_in_the_lane_type_as_jax_psum_does():
    """Past the clip (which the codec never sends) the int8 lane sum wraps
    mod 2^8 as JAX's int8 psum does; it never widens."""
    x = np.array([[100, -100, 127], [100, -100, 1]], np.int8)
    jsum = jcoll.vmap_workers(lambda v: jcoll.psum(v, jcoll.WORKER_AXIS), in_axes=0)(
        jnp.asarray(x)
    )
    got = psum_wire_words({"a": torch.from_numpy(row)} for row in x)["a"]
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsum[0]))
    assert got.tolist() == [-56, 56, -128]
    with pytest.raises(TypeError, match="lanes"):
        psum_wire_words([{"a": torch.zeros(2, dtype=torch.int8)},
                         {"a": torch.zeros(2, dtype=torch.int16)}])


def test_psum_wire_counts_workers():
    ctx = CommCtx(n_workers=2)
    one = {"a": torch.zeros(5, dtype=torch.int32)}
    with pytest.raises(ValueError, match="expected 2"):
        ctx.psum_wire([one], PackedInt(bits=8))
    words, ints = ctx.psum_wire([one, one], PackedInt(bits=8))
    assert words["a"].shape == (2,) and torch.equal(ints["a"], one["a"])
