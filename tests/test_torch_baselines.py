"""Port vs JAX: the paper's baseline compressors (``core/compressor.py``:
HeuristicIntSGD, QSGD, NatSGD, PowerSGD, SignSGD, TopK) at n = 4 workers,
each against the JAX package's under ``vmap`` with a 4-worker ``CommCtx``,
from the same gradients and state, for one round and (with error feedback)
a second from the carried state.

Tolerances, by what the arithmetic is:

- elementwise, bit for bit: Heuristic IntSGD (deterministic rounding; α from
  the same float32 ops), TopK (selection, the scatter-add in worker order),
  QSGD's levels given JAX's own norm and uniforms, NatSGD's exponents and
  signs given JAX's uniforms (also at zero, subnormal magnitudes, exact
  powers of two and their float neighbours), and every ``Metrics`` field;
- through reductions, rtol 1e-6: QSGD's norm and decoded mean, NatSGD's
  mean, SignSGD's scale ‖w‖₁/d (XLA and PyTorch sum in other orders);
- PowerSGD, rtol 1e-4 with an absolute floor of 1e-4 of the largest
  |value|: two matmuls over up to 2,000-long rows and a QR, each in
  another order, and the rank-2 truncation of a 3-row leaf passes the
  rounding of P on (the port's Q is JAX's own, copied through
  ``comp_state_from_jax``).

QSGD's and NatSGD's uniforms come from the counter PRNG in the port; for
the aggregate comparisons the test swaps ``counter_uniform`` for JAX's own
``jax.random.uniform`` draws of each (worker, leaf).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.comm import CommCtx as JCommCtx  # noqa: E402
from repro.core.compressor import make_compressor as jmake  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro_torch.core import compressor as tcomp  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.models.transformer import comp_state_from_jax  # noqa: E402

N = 4
SHAPES = {"b": (10,), "s": (3, 40, 50), "w": (64, 100)}  # flatten order
NAMES = list(SHAPES)
ETA = np.float32(0.1)
KEY = jax.random.PRNGKey(0)


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((N, *s)) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _seeds():
    """Port seeds: worker w, leaf j -> 100·w + j (keys of the uniform table
    the swapped ``counter_uniform`` reads)."""
    return torch.tensor([[100 * w + j for j in range(len(NAMES))] for w in range(N)],
                        dtype=torch.int32)


def _jax_uniforms(key=KEY):
    """JAX's uniforms of each (worker, leaf): ``fold_worker_key`` then one
    split per leaf, as QSGD's and NatSGD's aggregate draw them."""
    table = {}
    for w in range(N):
        keys = jax.random.split(jax.random.fold_in(key, w), len(NAMES))
        for j, k in enumerate(NAMES):
            table[100 * w + j] = np.asarray(
                jax.random.uniform(keys[j], SHAPES[k], dtype=jnp.float32))
    return table


def _jround(jcomp, grads, state=None, key=KEY):
    ctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    if state is None:
        state = jcomp.init({k: v[0] for k, v in g.items()})
        state = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + jnp.shape(x)), state)

    def worker(s, gw):
        return jcomp.aggregate(s, gw, key=key, eta=jnp.float32(ETA), ctx=ctx)

    return jax.vmap(worker, in_axes=(0, 0), axis_name=jcoll.WORKER_AXIS)(state, g)


def _pround(comp, grads, state):
    return comp.aggregate(
        state, ({k: torch.from_numpy(v[i]) for k, v in grads.items()} for i in range(N)),
        seeds=_seeds(), eta=torch.tensor(ETA), ctx=CommCtx(n_workers=N))


def _np_state(jstate):
    return jax.tree.map(np.asarray, jstate)


def _metrics_equal(m, jm):
    assert float(m.max_int) == float(np.asarray(jm.max_int)[0])
    assert float(m.bits_per_coord) == float(np.asarray(jm.bits_per_coord)[0])
    assert m.payload_bytes == jm.payload_bytes
    assert float(m.max_local_int) == float(np.asarray(jm.max_local_int)[0])


def _ghat_close(ghat, jghat, rtol, atol_frac=0.0):
    for k in NAMES:
        want = np.asarray(jghat[k][0])
        atol = atol_frac * np.abs(want).max()
        np.testing.assert_allclose(ghat[k].numpy(), want, rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture
def jax_uniforms(monkeypatch):
    table = _jax_uniforms()
    monkeypatch.setattr(tcomp, "counter_uniform",
                        lambda shape, seed, device: torch.from_numpy(table[int(seed)].copy()))
    return table


# ---------------------------------------------------------------------------
# Heuristic IntSGD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wire", [None, "packed8", "dense8"])
def test_heuristic_intsgd_matches_jax_bit_for_bit(wire):
    grads = _grads(1, 1e-2)
    jghat, _, jm = _jround(jmake("heuristic_intsgd", wire=wire), grads)
    comp = make_compressor("heuristic_intsgd", wire=wire)
    ghat, state, m = _pround(comp, grads, comp.init({}, N))
    assert state == ()
    for k in NAMES:
        np.testing.assert_array_equal(ghat[k].numpy(), np.asarray(jghat[k][0]), err_msg=k)
    _metrics_equal(m, jm)
    assert float(m.max_local_int) == 0.0  # as JAX reports it
    # α as the rule gives it, one for every leaf
    absmax = max(np.abs(v).max() for v in grads.values())
    want_alpha = np.float32(127.0) / (N * np.exp2(np.ceil(np.log2(np.float32(absmax)))))
    assert set(m.alphas) == set(NAMES)
    np.testing.assert_allclose(float(m.alphas["w"]), want_alpha, rtol=1e-7)


# ---------------------------------------------------------------------------
# QSGD
# ---------------------------------------------------------------------------
def test_qsgd_levels_given_jax_norm_and_uniforms():
    from repro.core.compressor import QSGD as JQSGD

    grads = _grads(2)
    jq = JQSGD()
    comp = make_compressor("qsgd")
    for k in NAMES:
        key = jax.random.PRNGKey(11)
        g = grads[k][1]
        q, norm = jq._quantize_leaf(jnp.asarray(g), key)
        u = np.asarray(jax.random.uniform(key, g.shape, dtype=jnp.float32))
        got = comp.quantize(torch.from_numpy(g), torch.tensor(np.asarray(norm)),
                            torch.from_numpy(u.copy()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(q), err_msg=k)
        np.testing.assert_allclose(float(tcomp.qsgd_norm(torch.from_numpy(g))), float(norm),
                                   rtol=1e-6)


def test_qsgd_norm_is_accurate_on_a_large_leaf():
    """The norm of 2^25 float32 values of 1e-3 within 1e-6 of a float64 sum
    (``torch.linalg.vector_norm`` on the CPU comes out 0.07 % low already at
    2^24, 1.2 % at 117M)."""
    x = torch.randn(1 << 25, generator=torch.Generator().manual_seed(0)) * 1e-3
    want = float(torch.sqrt(torch.sum(x.double() ** 2)))
    np.testing.assert_allclose(float(tcomp.qsgd_norm(x)), want, rtol=1e-6)


@pytest.mark.parametrize("wire", [None, "packed8", "dense8", "packed16"])
def test_qsgd_aggregate_matches_jax_given_its_uniforms(wire, jax_uniforms):
    """The levels are JAX's; each worker's norm is a reduction in another
    order, and the workers' ±level·norm/s terms cancel, so ĝ is held at
    rtol 1e-6 with an absolute floor of 1e-6 of its largest |value|."""
    grads = _grads(3)
    jghat, _, jm = _jround(jmake("qsgd", wire=wire), grads)
    comp = make_compressor("qsgd", wire=wire)
    ghat, state, m = _pround(comp, grads, comp.init({}, N))
    _ghat_close(ghat, jghat, rtol=1e-6, atol_frac=1e-6)
    _metrics_equal(m, jm)


def test_qsgd_refuses_what_jax_refuses():
    grads = _grads(4)
    for wire, match in (("topk8:4", "psum-shaped"), ("packed4", "too narrow")):
        with pytest.raises(ValueError, match=match):
            _jround(jmake("qsgd", wire=wire), grads)
        comp = make_compressor("qsgd", wire=wire)
        with pytest.raises(ValueError, match=match):
            _pround(comp, grads, ())
    assert not make_compressor("qsgd").supports_allreduce


# ---------------------------------------------------------------------------
# NatSGD
# ---------------------------------------------------------------------------
def _edge_magnitudes() -> np.ndarray:
    """Zero, subnormal magnitudes, the subnormal/normal boundary, exact
    powers of two across the range and their float neighbours on both
    sides, the top of the clip — with both signs."""
    tiny = [0.0, 1e-45, 1e-40, 1e-39, 1e-38, 1.1754942e-38, 2.0**-126]
    pows = [2.0**e for e in range(-126, 127, 5)] + [2.0**126, 2.0**127]
    vals = np.array(tiny + pows, dtype=np.float32)
    nbrs = np.concatenate([np.nextafter(vals, np.float32(0)), np.nextafter(vals, np.float32(np.inf))])
    mags = np.concatenate([vals, nbrs[np.isfinite(nbrs)]]).astype(np.float32)
    return np.concatenate([mags, -mags])


@pytest.mark.parametrize("which", ["random", "edges"])
def test_natural_exponents_given_jax_uniforms(which):
    """Bit for bit with JAX's ``_encode_leaf`` given its uniforms, but for
    two XLA CPU cases, pinned: XLA flushes subnormal inputs, so its sign of a
    subnormal |g| is 0 (the port's is ±1, and |g| < 2^-126 rounds to
    ±2^-126 as the clip says); and its exp2(-126) underflows, so every
    2^-126 <= |g| < 2^-125 rounds up to 2^-125 with probability 1, where
    the port rounds up with probability |g|/2^-126 − 1 (0 at 2^-126 itself:
    unbiased)."""
    from repro.core.compressor import NatSGD as JNatSGD

    g = _grads(5)["s"].reshape(-1) if which == "random" else _edge_magnitudes()
    comp, jn = make_compressor("natsgd"), JNatSGD()
    mag = np.abs(g).astype(np.float64)
    subnormal = (mag > 0) & (mag < 2.0**-126)
    bottom = (mag >= 2.0**-126) & (mag < 2.0**-125)
    for seed in range(8 if which == "edges" else 1):
        key = jax.random.PRNGKey(seed)
        je, js = (np.asarray(a) for a in jn._encode_leaf(jnp.asarray(g), key))
        u = np.asarray(jax.random.uniform(key, g.shape, dtype=jnp.float32))
        e, s = (a.numpy() for a in comp.natural(torch.from_numpy(g), torch.from_numpy(u.copy())))
        np.testing.assert_array_equal(s[~subnormal], js[~subnormal])
        np.testing.assert_array_equal(s[subnormal], np.sign(g[subnormal]))
        assert not js[subnormal].any()
        np.testing.assert_array_equal(e[~bottom], je[~bottom])
        assert np.all(je[bottom] == -125)
        p_up = mag[bottom] / 2.0**-126 - 1.0
        np.testing.assert_array_equal(e[bottom], -126 + (u[bottom] < p_up))
        assert np.all(e[subnormal] == -126)
    if which == "random":
        assert not subnormal.any() and not bottom.any()
    # the port's exponents are exact: with u = 0 (always round up where not
    # a power of two) 2^e brackets |g| for every normal g
    e, _ = comp.natural(torch.from_numpy(g), torch.zeros(g.shape))
    normal = (mag >= 2.0**-126) & (mag < 2.0**126)
    pe = 2.0 ** e.numpy().astype(np.float64)
    assert np.all(pe[normal] >= mag[normal]) and np.all(pe[normal] < 2 * mag[normal])
    assert np.all(e.numpy()[mag < 2.0**-126] == -126)


def test_natsgd_aggregate_matches_jax_given_its_uniforms(jax_uniforms):
    grads = _grads(6)
    jghat, _, jm = _jround(jmake("natsgd"), grads)
    comp = make_compressor("natsgd")
    ghat, _, m = _pround(comp, grads, comp.init({}, N))
    _ghat_close(ghat, jghat, rtol=1e-6)
    _metrics_equal(m, jm)
    assert not comp.supports_allreduce


# ---------------------------------------------------------------------------
# SignSGD, TopK (error feedback)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,rtol", [("signsgd", 1e-6), ("topk", 0.0)])
def test_ef_baselines_match_jax_over_two_rounds(name, rtol):
    """TopK bit for bit; SignSGD's scale ‖w‖₁/d is a reduction, and the
    workers' ±scale terms cancel in ĝ: rtol 1e-6 with an absolute floor of
    1e-6 of the largest |value| (10× both in the second round)."""
    grads, grads2 = _grads(7), _grads(8)
    jcomp = jmake(name, k_frac=0.05) if name == "topk" else jmake(name)
    comp = make_compressor(name, k_frac=0.05) if name == "topk" else make_compressor(name)
    state = comp.init({k: torch.zeros(s) for k, s in SHAPES.items()}, N)
    jghat, jstate, jm = _jround(jcomp, grads)
    ghat, state, m = _pround(comp, grads, state)
    _ghat_close(ghat, jghat, rtol=rtol, atol_frac=rtol)
    _metrics_equal(m, jm)
    want_state = comp_state_from_jax(_np_state(jstate), "cpu")
    for k in NAMES:
        np.testing.assert_allclose(state[k].numpy(), want_state[k].numpy(), rtol=rtol,
                                   atol=rtol * float(want_state[k].abs().max()), err_msg=k)
    jghat2, jstate2, _ = _jround(jcomp, grads2, state=jstate)
    ghat2, state2, _ = _pround(comp, grads2, state)
    _ghat_close(ghat2, jghat2, rtol=10 * rtol, atol_frac=10 * rtol)
    want_state = comp_state_from_jax(_np_state(jstate2), "cpu")
    for k in NAMES:
        np.testing.assert_allclose(state2[k].numpy(), want_state[k].numpy(), rtol=10 * rtol,
                                   atol=10 * rtol * float(want_state[k].abs().max()), err_msg=k)


def test_error_feedback_accumulates():
    """EF invariant: e' = (g + e) − C(g + e) for each worker."""
    grads = _grads(9)
    comp = make_compressor("signsgd")
    _, state, _ = _pround(comp, grads, comp.init({k: torch.zeros(s) for k, s in SHAPES.items()},
                                                 N))
    work = grads["w"].reshape(N, -1)
    local_c = np.mean(np.abs(work), axis=-1, keepdims=True) * np.sign(work)
    np.testing.assert_allclose(state["w"].numpy().reshape(N, -1), work - local_c, rtol=1e-5,
                               atol=1e-6)


def test_topk_ties_and_count():
    """k = max(1, int(k_frac·d)) survivors a leaf; on a leaf with more
    zeros than survivors the tied zeros go to the lowest indices."""
    comp = make_compressor("topk", k_frac=0.3)
    w = torch.tensor([0.0, 2.0, 0.0, -2.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    idx, vals = comp.select(w)
    assert idx.tolist() == [1, 3, 6]
    comp = make_compressor("topk", k_frac=0.5)
    idx, vals = comp.select(w)
    assert idx.tolist() == [1, 3, 6, 0, 2]
    assert make_compressor("topk", k_frac=1e-9).select(w)[0].tolist() == [1]


# ---------------------------------------------------------------------------
# PowerSGD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("min_compress_size", [4096, 100])
def test_powersgd_matches_jax_given_its_q(min_compress_size):
    """From JAX's initial Q (copied through ``comp_state_from_jax``): ĝ, the
    new Q and the error feedback over two rounds. At 4096 the stacked leaf
    ``s`` (3 rows) is compressed at rank 2 and ``b`` sent as a float mean;
    at 100 every matrix is."""
    grads, grads2 = _grads(10), _grads(11)
    jcomp = jmake("powersgd", min_compress_size=min_compress_size)
    comp = make_compressor("powersgd", min_compress_size=min_compress_size)
    jinit = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + jnp.shape(x)),
                         jcomp.init({k: jnp.zeros(s) for k, s in SHAPES.items()}))
    state = comp_state_from_jax(_np_state(jinit), "cpu")
    assert set(state["q"]) == {k for k, s in SHAPES.items() if len(s) >= 2}
    assert tuple(state["err"]["w"].shape) == (N, 64, 100)
    for rnd, g in enumerate((grads, grads2)):
        jghat, jinit, jm = _jround(jcomp, g, state=jinit)
        ghat, state, m = _pround(comp, g, state)
        _ghat_close(ghat, jghat, rtol=1e-4, atol_frac=1e-4)
        _metrics_equal(m, jm)
        want = comp_state_from_jax(_np_state(jinit), "cpu")
        for k in state["q"]:
            np.testing.assert_allclose(state["q"][k].numpy(), want["q"][k].numpy(), rtol=1e-4,
                                       atol=1e-4 * float(want["q"][k].abs().max()))
        for k in NAMES:
            np.testing.assert_allclose(state["err"][k].numpy(), want["err"][k].numpy(),
                                       rtol=1e-4, atol=1e-4 * float(want["err"][k].abs().max()
                                                                    + 1e-30), err_msg=k)


def test_powersgd_initial_q_is_stable():
    """The port's Q comes from a stable hash of the shape (the JAX package
    salts it per process): the same in every process and call."""
    a = make_compressor("powersgd").init({"w": torch.zeros(64, 100)}, 1)["q"]["w"]
    b = tcomp.initial_q((64, 100), 2)
    assert tuple(a.shape) == (100, 2) and torch.equal(a, b)


# ---------------------------------------------------------------------------
# flags, unbiasedness, convergence, the fused route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qsgd", "natsgd"])
def test_unbiased_compressors(name):
    """E[ĝ] == mean(grads) over the counter PRNG's seeds (300 trials)."""
    rng = np.random.default_rng(2)
    grads = rng.standard_normal((N, 32)).astype(np.float32)
    target = grads.mean(0)
    comp = make_compressor(name)
    gen = torch.Generator().manual_seed(0)
    acc = np.zeros(32)
    trials = 300
    for _ in range(trials):
        ghat, _, _ = comp.aggregate(
            (), ({"w": torch.from_numpy(grads[i])} for i in range(N)),
            seeds=tcomp.leaf_seeds(gen, N, 1, "cpu"), eta=torch.tensor(ETA),
            ctx=CommCtx(n_workers=N))
        acc += ghat["w"].numpy()
    assert np.abs(acc / trials - target).max() < 0.05


def test_fused_capability_flags():
    from repro_torch.core.compressor import (
        HeuristicIntSGD, IntDIANA, IntSGD, NatSGD, PowerSGD, QSGD, SignSGD, TopK,
    )

    assert IntSGD.fused_capable and IntDIANA.fused_capable
    assert IntDIANA.fused_local_state and not IntSGD.fused_local_state
    for c in (QSGD, NatSGD, PowerSGD, SignSGD, TopK, HeuristicIntSGD):
        assert not c.fused_capable, c


def test_allreduce_vs_allgather_flag():
    from repro_torch.core.compressor import IntSGD, NatSGD, PowerSGD, QSGD, TopK

    assert IntSGD.supports_allreduce and PowerSGD.supports_allreduce
    assert not QSGD.supports_allreduce
    assert not NatSGD.supports_allreduce
    assert not TopK.supports_allreduce


def test_powersgd_converges_low_rank():
    """PowerSGD+EF drives a low-rank-target quadratic to the optimum, on the
    port's SimTrainer."""
    from repro_torch.core.simulate import SimTrainer
    from repro_torch.optim.schedules import constant
    from repro_torch.optim.sgd import sgd

    gen = torch.Generator().manual_seed(0)
    u = torch.randn(N, 40, 2, generator=gen)
    v = torch.randn(N, 2, 40, generator=gen)
    W = torch.einsum("nik,nkj->nij", u, v)
    tr = SimTrainer(lambda p, b: 0.5 * torch.sum((p["W"] - b) ** 2), N,
                    make_compressor("powersgd", min_compress_size=100), sgd(), constant(0.1),
                    device="cpu")
    st = tr.init({"W": torch.zeros(40, 40)})
    for _ in range(300):
        st, _ = tr.step(st, W)
    err = float(torch.linalg.norm(st.params["W"] - W.mean(0)))
    assert err < 1e-2, err


@pytest.mark.parametrize("name", ["heuristic_intsgd", "qsgd", "natsgd", "powersgd", "signsgd",
                                  "topk"])
def test_fused_route_refuses_each_baseline(name):
    """build_train_step(fused=True) names fused_capable and the compressor,
    not IntSGD, as JAX's does."""
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.launch.step import build_train_step
    from repro_torch.optim.schedules import constant
    from repro_torch.optim.sgd import sgd

    with pytest.raises(ValueError, match="fused_capable") as ei:
        build_train_step(smoke_config(get_arch("granite-8b")), ShapeConfig("t", 32, 4, "train"),
                         n_workers=N, compressor=make_compressor(name),
                         base_opt=sgd(momentum=0.9), lr_schedule=constant(0.1), fused=True,
                         device="cpu")
    assert name in str(ei.value) and "IntSGD" not in str(ei.value)


def test_comp_state_from_jax_baselines():
    """Each baseline's JAX state (stacked over workers) becomes the port's,
    and a rank's row alone with ``rank``."""
    for name in ("heuristic_intsgd", "qsgd", "natsgd"):
        assert comp_state_from_jax(_np_state(jmake(name).init({"w": jnp.zeros(5)})), "cpu") == ()
    for name in ("signsgd", "topk"):
        j = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + jnp.shape(x)),
                         jmake(name).init({"w": jnp.zeros((3, 4))}))
        got = comp_state_from_jax(_np_state(j), "cpu", rank=2)
        want = make_compressor(name).init({"w": torch.zeros(3, 4)}, 1)
        assert got.keys() == want.keys() and got["w"].shape == want["w"].shape
    j = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + jnp.shape(x)),
                     jmake("intsgd", bits=8, wire="topk8:3").init({"w": jnp.zeros(7)}))
    got = comp_state_from_jax(_np_state(j), "cpu")
    assert set(got) == {"alpha", "ef"} and tuple(got["ef"]["w"].shape) == (N, 7)
