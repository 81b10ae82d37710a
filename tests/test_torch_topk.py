"""Port vs JAX: the sparse integer wire (``wire/topk.py``, ``wire/logged.py``,
the gather transport of ``core/comm.py`` and ``wire/bucketing.py``) and
IntSGD's EF21 residual on it — the ports of ``tests/test_topk.py``'s codec,
registry, byte-meter and residual tests, each also held against the JAX
package on the same integers.

Integer planes, images and indices are bit-equal to JAX's (the selection is
``lax.top_k``'s order: |value| descending, ties to the lower index). The
encode is the counter-PRNG kernel with ``n_workers=1`` (the full range),
held bit for bit against JAX's ``kops.int_compress`` in interpret mode;
IntSGD's decode and residual are held to JAX's deterministic-rounding run at
rtol 1e-6 (α is the same float32 arithmetic; a division may round apart).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.comm import CommCtx as JCommCtx  # noqa: E402
from repro.core.compressor import make_compressor as jmake  # noqa: E402
from repro.core.scaling import AlphaState as JAlphaState  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro.wire import TopKInt as JTopKInt  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.core.scaling import AlphaState  # noqa: E402
from repro_torch.wire import (  # noqa: E402
    Logged, TopKInt, make_wire_format, payload_nbytes, wire_format_names,
)
from repro_torch.wire.bucketing import plan_buckets  # noqa: E402
from repro_torch.wire.topk import select_topk  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

N = 4


def _rand_ints(wf, size, seed, n=1):
    lim = wf.clip_limit(n)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-lim, lim + 1, (n, size)).astype(np.int32))


def _planes_equal(payload, jpayload):
    assert set(payload) == set(jpayload) == {"idx", "vals"}
    for plane in ("idx", "vals"):
        assert payload[plane].dtype == torch.int32
        np.testing.assert_array_equal(payload[plane].numpy(), np.asarray(jpayload[plane]))


def _stack(payloads):
    return {p: torch.stack([pl[p] for pl in payloads]) for p in ("idx", "vals")}


# ---------------------------------------------------------------------------
# round trip, the gather-safety contract, JAX's planes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,k,size", [(8, 5, 37), (16, 7, 300), (8, 64, 40), (16, 1, 1)])
def test_single_worker_roundtrip_is_local_image(bits, k, size):
    wf, jwf = TopKInt(bits=bits, k=k), JTopKInt(bits=bits, k=k)
    ints = _rand_ints(wf, size, bits + k + size)[0]
    payload = wf.pack(ints, n_workers=1)
    _planes_equal(payload, jwf.pack(jnp.asarray(ints.numpy()), n_workers=1))
    back = wf.unpack(_stack([payload]), (size,), n_summed=1)
    local = wf.local_image(ints, n_workers=1)
    np.testing.assert_array_equal(back.numpy(), local.numpy())
    np.testing.assert_array_equal(
        local.numpy(), np.asarray(jwf.local_image(jnp.asarray(ints.numpy()), n_workers=1)))


if HAVE_HYPOTHESIS:

    @given(
        bits=st.sampled_from([8, 16]),
        k=st.integers(1, 40),
        n=st.integers(1, 6),
        size=st.integers(1, 300),
        seed=st.integers(0, 2**31 - 1),
    )
    @settings(max_examples=60, deadline=None, derandomize=True)
    def test_gather_aggregation_safety(bits, k, n, size, seed):
        """unpack of the n stacked payloads == the sum of the n workers'
        top-k-masked images, at the full-range boundary too and for k past
        the leaf size."""
        wf = TopKInt(bits=bits, k=k)
        lim = wf.clip_limit(n)
        ints = _rand_ints(wf, size, seed, n=n)
        ints[0] = lim
        ints[-1] = -lim
        got = wf.unpack(_stack([wf.pack(ints[i], n_workers=n) for i in range(n)]), (size,),
                        n_summed=n)
        want = sum(wf.local_image(ints[i], n_workers=n) for i in range(n))
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bits,k", [(8, 6), (16, 33)])
def test_gather_unpack_matches_jax(bits, k):
    wf, jwf = TopKInt(bits=bits, k=k), JTopKInt(bits=bits, k=k)
    ints = _rand_ints(wf, 211, bits * k, n=N)
    payloads = [wf.pack(ints[i], n_workers=N) for i in range(N)]
    jstack = jax.tree.map(lambda *p: jnp.stack(p), *[
        jwf.pack(jnp.asarray(ints[i].numpy()), n_workers=N) for i in range(N)])
    _planes_equal(_stack(payloads), jstack)
    np.testing.assert_array_equal(
        wf.unpack(_stack(payloads), (211,), n_summed=N).numpy(),
        np.asarray(jwf.unpack(jstack, (211,), n_summed=N)))


def test_tie_break_is_lowest_index():
    wf = TopKInt(bits=8, k=2)
    img = wf.local_image(torch.tensor([3, -5, 5, -5], dtype=torch.int32), n_workers=1)
    np.testing.assert_array_equal(img.numpy(), [0, -5, 5, 0])


@pytest.mark.parametrize("k", [1, 100, 4999, 5000, 5001, 20000])
def test_tie_break_on_a_tied_image_matches_lax_top_k(k):
    """Values in -3..3: ties decide almost the whole selection. The indices
    (and their order) are lax.top_k's."""
    rng = np.random.default_rng(k)
    v = rng.integers(-3, 4, 20000).astype(np.int32)
    got = select_topk(torch.from_numpy(np.abs(v)), k)
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(v)), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fv = rng.standard_normal(3000).astype(np.float32)
    fv[::3] = 0.0  # more zeros than survivors at large k
    kf = min(k, 3000)
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(fv)), kf)
    np.testing.assert_array_equal(select_topk(torch.from_numpy(np.abs(fv)), kf).numpy(),
                                  np.asarray(want))


def test_k_caps_at_leaf_size():
    wf = TopKInt(bits=8, k=64)
    assert wf.k_eff(3) == 3
    ints = torch.tensor([1, -2, 3], dtype=torch.int32)
    payload = wf.pack(ints, n_workers=1)
    assert tuple(payload["idx"].shape) == (3,)
    np.testing.assert_array_equal(
        wf.unpack(_stack([payload]), (3,), n_summed=1).numpy(), [1, -2, 3])


def test_full_range_clip_and_sign_extension():
    for bits, lim in ((8, 127), (16, 32767)):
        wf = TopKInt(bits=bits, k=4)
        assert wf.clip_limit(1) == lim == wf.clip_limit(4096) == JTopKInt(bits, 4).clip_limit(7)
        ints = torch.tensor([lim, -lim, 1, -1], dtype=torch.int32)
        np.testing.assert_array_equal(wf.local_image(ints, n_workers=1).numpy(), ints.numpy())
        back = wf.unpack(_stack([wf.pack(ints, n_workers=1)]), (4,), n_summed=1)
        np.testing.assert_array_equal(back.numpy(), ints.numpy())


def test_dead_worker_contributes_exact_zero():
    """An all-zero (masked) image selects zeros at indices 0..k-1 and adds
    exactly nothing."""
    wf = TopKInt(bits=8, k=6)
    ints = _rand_ints(wf, 40, 5, n=N)
    ints[2] = 0
    dead = wf.pack(ints[2], n_workers=N)
    np.testing.assert_array_equal(dead["idx"].numpy(), np.arange(6))
    assert not dead["vals"].any()
    got = wf.unpack(_stack([wf.pack(ints[i], n_workers=N) for i in range(N)]), (40,),
                    n_summed=N)
    want = sum(wf.local_image(ints[i], n_workers=N) for i in range(N) if i != 2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("overlap,bucket_words", [("off", None), ("ring", 7)])
def test_gather_safety_through_real_collective(overlap, bucket_words):
    """The same contract through CommCtx.psum_wire's gather transport (one
    bucket, or 7-word buckets), and equal to a dense int32 sum of the same
    masked images."""
    wf = TopKInt(bits=8, k=6)
    ints = _rand_ints(wf, 50, 3, n=N)
    kw = {} if bucket_words is None else dict(bucket_words=bucket_words)
    gathered, int_sum = CommCtx(n_workers=N, overlap=overlap, **kw).psum_wire(
        ({"w": ints[i], "b": ints[i, :9]} for i in range(N)), wf)
    assert tuple(gathered["w"]["idx"].shape) == (N, 6)
    for leaf, sl in (("w", slice(None)), ("b", slice(0, 9))):
        masked = [wf.local_image(ints[i, sl], n_workers=N) for i in range(N)]
        np.testing.assert_array_equal(int_sum[leaf].numpy(), sum(masked).numpy())
        np.testing.assert_array_equal(
            int_sum[leaf].numpy(), torch.stack(masked).sum(0, dtype=torch.int32).numpy())


def test_gather_wire_refuses_a_float_plane():
    """The integer-only guard holds on the gather transport too."""
    from repro_torch.parallel.collectives import allgather_wire_words

    with pytest.raises(TypeError, match="carries no floats"):
        allgather_wire_words([[torch.zeros(3)]] * N, N)
    got = allgather_wire_words([[torch.full((3,), w, dtype=torch.int32)] for w in range(N)], N)
    np.testing.assert_array_equal(got[0].numpy(), np.repeat(np.arange(N)[:, None], 3, 1))


def test_encode_is_the_full_range_kernel_stream_of_jax():
    """TopKInt's encode is the counter-PRNG kernel with n_workers=1: bit for
    bit JAX's ``kops.int_compress`` (interpret mode) on the same seed."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((37, 50)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    seed = torch.tensor(int(kops.seed_from_key(key)), dtype=torch.int32)
    for bits, stochastic in ((8, True), (8, False), (16, True)):
        alpha = np.float32(41.5 if bits == 8 else 4100.0)
        got = TopKInt(bits=bits, k=9).encode(torch.from_numpy(x), torch.tensor(alpha), seed,
                                             n_workers=N, stochastic=stochastic)
        want = kops.int_compress(jnp.asarray(x), jnp.float32(alpha), key, n_workers=1,
                                 bits=bits, stochastic=stochastic)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.abs().max()) == TopKInt(bits=bits).clip_limit(N)  # saturated


# ---------------------------------------------------------------------------
# registry and byte meters
# ---------------------------------------------------------------------------
def test_registry_parses_parametric_names():
    assert make_wire_format("topk8:64") == TopKInt(bits=8, k=64)
    assert make_wire_format("topk16:5") == TopKInt(bits=16, k=5)
    assert "topk8:<k>" in wire_format_names()
    for bad in ("topk8", "topk8:", "topk8:x", "topk8:0", "topk4:8"):
        with pytest.raises(ValueError):
            make_wire_format(bad)
    with pytest.raises(ValueError, match="unknown wire format"):
        make_wire_format("nope")


def test_byte_meters_agree_on_gather_route():
    wf, jwf = TopKInt(bits=8, k=16), JTopKInt(bits=8, k=16)
    sizes = (129, 64, 7)
    tree = {f"l{i}": torch.zeros(s, dtype=torch.int32) for i, s in enumerate(sizes)}
    logged = Logged(wf)
    payload = {k: logged.pack(v, n_workers=N) for k, v in tree.items()}
    declared = sum(wf.wire_bytes(s) for s in sizes)
    assert declared == sum(jwf.wire_bytes(s) for s in sizes)
    assert logged.pack_bytes == declared == payload_nbytes(payload)
    manifest = plan_buckets(payload)
    assert manifest.payload_bytes == declared
    assert set(manifest.leaf_planes) == {"idx", "vals"}
    stacked = {k: {p: torch.stack([v] * N) for p, v in pl.items()} for k, pl in payload.items()}
    for name, leaf in tree.items():
        logged.unpack(stacked[name], tuple(leaf.shape), n_summed=N)
    assert logged.unpack_bytes == N * declared
    assert logged.report()["calls"][("pack", (129,))] == 1
    logged.reset()
    assert (logged.pack_bytes, logged.unpack_bytes, dict(logged.calls)) == (0, 0, {})


def test_topk_beats_packed8_bytes_on_large_leaves():
    wf, packed = TopKInt(bits=8, k=64), make_wire_format("packed8")
    assert packed.wire_bytes(10_000) / wf.wire_bytes(10_000) > 4


# ---------------------------------------------------------------------------
# the EF21 residual through IntSGD, against JAX's
# ---------------------------------------------------------------------------
def _jax_round(name_wire, grads, r, eta=0.1):
    jcomp = jmake("intsgd", bits=8, wire=name_wire, stochastic=False)
    ctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))
    state = jcomp.init({"w": jnp.asarray(grads[0])})
    state = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + jnp.shape(x)), state)
    state["alpha"] = JAlphaState(r=jnp.full((N,), r, jnp.float32), step=jnp.ones((N,), jnp.int32))

    def worker(s, g):
        return jcomp.aggregate(s, {"w": g}, key=jax.random.PRNGKey(7), eta=jnp.float32(eta),
                               ctx=ctx)

    return jax.vmap(worker, in_axes=(0, 0), axis_name=jcoll.WORKER_AXIS)(
        state, jnp.asarray(grads))


def _port_round(name_wire, grads, r, eta=0.1, state=None):
    comp = make_compressor("intsgd", bits=8, wire=name_wire, stochastic=False)
    if state is None:
        state = comp.init({"w": torch.zeros(grads.shape[1:])}, N)
        state["alpha"] = AlphaState(r=torch.tensor(np.float32(r)),
                                    step=torch.tensor(1, dtype=torch.int32))
    seeds = torch.zeros((N, 1), dtype=torch.int32)  # unused: deterministic rounding
    return comp, comp.aggregate(state, ({"w": torch.from_numpy(grads[i])} for i in range(N)),
                                seeds=seeds, eta=torch.tensor(np.float32(eta)),
                                ctx=CommCtx(n_workers=N))


def test_intsgd_topk_state_carries_residual():
    comp = make_compressor("intsgd", bits=8, wire="topk8:4", stochastic=False)
    assert comp.fused_capable is False
    state0 = comp.init({"w": torch.zeros(32)}, N)
    assert set(state0) == {"alpha", "ef"}
    assert isinstance(state0["alpha"], AlphaState)
    assert tuple(state0["ef"]["w"].shape) == (N, 32) and not state0["ef"]["w"].any()
    # a psum codec keeps the bare AlphaState
    dense = make_compressor("intsgd", bits=8, wire="packed8")
    assert isinstance(dense.init({"w": torch.zeros(32)}, N), AlphaState)
    assert dense.fused_capable is True


def test_intsgd_topk_residual_is_what_the_wire_dropped():
    """After a round, ef == work − local_image/α per worker, and equal to
    JAX's residual; two rounds carried."""
    grads = (np.random.default_rng(1).standard_normal((N, 32))).astype(np.float32)
    comp, (ghat, state, m) = _port_round("topk8:4", grads, 1e-2)
    jghat, jstate, jm = _jax_round("topk8:4", grads, 1e-2)
    wf = comp.wire_format
    alpha = comp.alpha_rule.alpha(state["alpha"], torch.tensor(np.float32(0.1)), N, 32)
    for i in range(N):
        work = torch.from_numpy(grads[i])
        ints = wf.encode(work, alpha, torch.tensor(0, dtype=torch.int32), n_workers=N,
                         stochastic=False)
        want = work - wf.local_image(ints, n_workers=N).float() / alpha
        torch.testing.assert_close(state["ef"]["w"][i], want, rtol=0, atol=0)
    np.testing.assert_allclose(state["ef"]["w"].numpy(), np.asarray(jstate["ef"]["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ghat["w"].numpy(), np.asarray(jghat["w"][0]), rtol=1e-6)
    assert float(m.max_int) == float(jm.max_int[0])
    assert float(m.max_local_int) == float(jm.max_local_int[0])
    assert m.payload_bytes == jm.payload_bytes
    # a second round encodes g + r from the carried residual
    r1 = state["ef"]["w"].clone()
    comp, (_, state2, _) = _port_round("topk8:4", grads, 1e-2, state=state)
    for i in range(N):
        work = torch.from_numpy(grads[i]) + r1[i]
        ints = wf.encode(work, alpha, torch.tensor(0, dtype=torch.int32), n_workers=N,
                         stochastic=False)
        want = work - wf.local_image(ints, n_workers=N).float() / alpha
        torch.testing.assert_close(state2["ef"]["w"][i], want, rtol=0, atol=0)


def test_intsgd_topk_decode_is_sum_of_local_images():
    grads = (np.random.default_rng(2).standard_normal((N, 24))).astype(np.float32)
    comp, (ghat, _, _) = _port_round("topk8:8", grads, 1e-2)
    wf = comp.wire_format
    alpha = comp.alpha_rule.alpha(AlphaState(r=torch.tensor(np.float32(1e-2)),
                                             step=torch.tensor(1, dtype=torch.int32)),
                                  torch.tensor(np.float32(0.1)), N, 24)
    total = sum(wf.local_image(wf.encode(torch.from_numpy(grads[i]), alpha,
                                         torch.tensor(0, dtype=torch.int32), n_workers=N,
                                         stochastic=False), n_workers=N) for i in range(N))
    torch.testing.assert_close(ghat["w"], total.float() / (N * alpha), rtol=0, atol=0)
    jghat, _, _ = _jax_round("topk8:8", grads, 1e-2)
    np.testing.assert_allclose(ghat["w"].numpy(), np.asarray(jghat["w"][0]), rtol=1e-6)


def test_fused_route_is_gated_off():
    """The codec refuses the fused update, and build_train_step refuses IntSGD
    on topk with JAX's message; microbatches accumulate f32 gradients."""
    from repro.launch.step import _fused_plan as j_fused_plan
    from repro.optim import sgd as jsgd
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.launch.step import _fused_plan, build_train_step
    from repro_torch.optim.schedules import constant
    from repro_torch.optim.sgd import sgd

    wf = TopKInt(bits=8, k=4)
    assert wf.fused_capable is False
    with pytest.raises(NotImplementedError, match="fused_capable"):
        wf.fused_update(None, None, None, None, kernel=None, n_summed=N)
    comp = make_compressor("intsgd", bits=8, wire="topk8:4")
    with pytest.raises(ValueError) as port_err:
        _fused_plan(sgd(momentum=0.9), comp)
    with pytest.raises(ValueError) as jax_err:
        j_fused_plan(jsgd(momentum=0.9), jmake("intsgd", bits=8, wire="topk8:4"))
    assert str(port_err.value) == str(jax_err.value)
    cfg = smoke_config(get_arch("granite-8b"))
    with pytest.raises(ValueError, match="WireFormat.fused_capable"):
        build_train_step(cfg, ShapeConfig("t", 32, 4, "train"), n_workers=N, compressor=comp,
                         base_opt=sgd(momentum=0.9), lr_schedule=constant(0.1), fused=True,
                         device="cpu")
