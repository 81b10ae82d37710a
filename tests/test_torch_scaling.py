"""Port vs JAX: the five α rules, the ||Δx||² statistics that feed them and
the blockwise and deterministic IntSGD registry entries.

The same ||Δx||² values, made with numpy, update each rule's state in both
packages; the α each then derives is compared bit for bit (every float32
operation runs in JAX's order, and the Python constants JAX rounds to
float32 as weak scalars are rounded the same way). The one exception is the
heuristic rule's power of two, which XLA computes inexactly (see its test).
The Prop. 3 and Prop. 4
identities of ``tests/test_scaling.py`` are checked on the port.
``local_dx_stats`` sums through the block-norms kernel's plain version, in
another order than XLA: rtol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import scaling as js  # noqa: E402
from repro.core.compressor import make_compressor as jmake  # noqa: E402
from repro.core.stats import DxStats as JDxStats, local_dx_stats as jlocal_dx_stats  # noqa: E402
from repro_torch.core import scaling as ts  # noqa: E402
from repro_torch.core.compressor import IntSGD, make_compressor  # noqa: E402
from repro_torch.core.stats import DxStats, local_dx_stats, local_tree_dims  # noqa: E402
from repro_torch.wire import PackedInt  # noqa: E402

LEAVES = {"a": (32, 16), "b": (100,), "c/w": (3, 5, 7)}
D = sum(int(np.prod(s)) for s in LEAVES.values())
ETAS = [0.3, 0.05, 3e-4, 1.7]


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _assert_bit_equal(got: torch.Tensor, want):
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))


def _leaf_sq_sequence(seed, steps=4):
    """Per-leaf ||Δx_l||² for a few steps, spanning several decades."""
    rng = np.random.default_rng(seed)
    return [
        {k: np.float32(rng.uniform(0.1, 10.0) * 10.0 ** rng.integers(-8, 3)) for k in LEAVES}
        for _ in range(steps)
    ]


def _stats(leaf_sq):
    jleaf = {k: jnp.float32(v) for k, v in leaf_sq.items()}
    jsq = jnp.sum(jnp.stack(list(jleaf.values())))
    tleaf = {k: torch.tensor(v) for k, v in leaf_sq.items()}
    tsq = torch.tensor(np.asarray(jsq))
    return JDxStats(sq=jsq, leaf_sq=jleaf), DxStats(sq=tsq, leaf_sq=tleaf)


def _params():
    return ({k: jnp.zeros(s, jnp.float32) for k, s in LEAVES.items()},
            {k: torch.zeros(s) for k, s in LEAVES.items()})


@pytest.mark.parametrize("name", ["moving_avg", "last_step", "diana"])
@pytest.mark.parametrize("n", [1, 4, 16])
def test_global_rules_match_jax_bit_for_bit(name, n):
    kw = {"moving_avg": dict(beta=0.9, eps=1e-8)}.get(name, {})
    jrule, trule = js.make_alpha_rule(name, **kw), ts.make_alpha_rule(name, **kw)
    jp, tp = _params()
    jst, tst = jrule.init(jp), trule.init(tp)
    assert tst.r.dtype == torch.float32 and tst.step.dtype == torch.int32
    for step, leaf_sq in enumerate(_leaf_sq_sequence([n, len(name)])):
        jd, td = _stats(leaf_sq)
        jst, tst = jrule.update(jst, jd), trule.update(tst, td)
        _assert_bit_equal(tst.r, jst.r)
        assert int(tst.step) == int(jst.step) == step + 1
        for eta in ETAS:
            want = jrule.alpha(jst, jnp.float32(eta), n, D)
            _assert_bit_equal(trule.alpha(tst, torch.tensor(eta, dtype=torch.float32), n, D), want)


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("beta,eps", [(0.9, 1e-8), (0.0, 0.0), (0.5, 1e-3)])
def test_blockwise_alpha_tree_matches_jax_bit_for_bit(n, beta, eps):
    jrule, trule = js.AlphaBlockwise(beta=beta, eps=eps), ts.AlphaBlockwise(beta=beta, eps=eps)
    jp, tp = _params()
    jst, tst = jrule.init(jp), trule.init(tp)
    assert set(tst.r) == set(LEAVES) and all(float(v) == 0.0 for v in tst.r.values())
    dims = {k: float(np.prod(s)) for k, s in LEAVES.items()}
    assert local_tree_dims(tp).leaf_dims == dims and local_tree_dims(tp).d == D
    for leaf_sq in _leaf_sq_sequence([n, 7]):
        jd, td = _stats(leaf_sq)
        jst, tst = jrule.update(jst, jd), trule.update(tst, td)
        for k in LEAVES:
            _assert_bit_equal(tst.r[k], jst.r[k])
        for eta in ETAS:
            want = jrule.alpha_tree(jst, jnp.float32(eta), n, dims, float(D))
            got = trule.alpha_tree(tst, torch.tensor(eta, dtype=torch.float32), n, dims, float(D))
            assert set(got) == set(want)
            for k in LEAVES:
                _assert_bit_equal(got[k], want[k])
    vals = [float(v) for v in got.values()]
    assert len(set(vals)) > 1  # the leaves differ in size and in r: so do their α
    with pytest.raises(NotImplementedError, match="alpha_tree"):
        trule.alpha(tst, torch.tensor(0.1), n, D)
    with pytest.raises(NotImplementedError, match="alpha_tree"):
        jrule.alpha(jst, jnp.float32(0.1), n, D)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 4, 100])
def test_heuristic_rule_matches_jax(bits, n):
    jrule, trule = js.AlphaHeuristic(bits=bits), ts.AlphaHeuristic(bits=bits)
    assert trule.needs_profiling and not ts.AlphaMovingAvg().needs_profiling
    rng = np.random.default_rng([bits, n])
    absmax = np.concatenate([
        (rng.uniform(0.5, 2.0, 20) * 10.0 ** rng.integers(-6, 6, 20)).astype(np.float32),
        np.float32([1.0, 2.0, 0.5, 1024.0, 3.0, 0.0, 1e-35]),
    ])
    for v in absmax:
        want = np.asarray(jrule.alpha_from_absmax(jnp.float32(v), n))
        got = trule.alpha_from_absmax(torch.tensor(v), n)
        # XLA lowers exp2(e) to exp(ln2·e), off by up to ~60 ulp (4e-6
        # relative) at e = -99, the 1e-30 floor; PyTorch's exp2 gives the
        # power of two exactly. So: the rule's exact value, and JAX's to 1e-5.
        e = np.ceil(np.log2(max(float(v), float(np.float32(1e-30)))))
        exact = np.float32((2.0 ** (bits - 1) - 1.0) / (n * 2.0**e))
        _assert_bit_equal(got, exact)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    jp, tp = _params()
    jst, tst = jrule.init(jp), trule.init(tp)
    jd, td = _stats(_leaf_sq_sequence(1, 1)[0])
    jst, tst = jrule.update(jst, jd), trule.update(tst, td)
    _assert_bit_equal(tst.r, jst.r)
    assert int(tst.step) == int(jst.step) == 1
    with pytest.raises(NotImplementedError, match="absmax"):
        trule.alpha(tst, torch.tensor(0.1), n, D)


def test_make_alpha_rule_names_match_jax():
    names = ["moving_avg", "last_step", "blockwise", "heuristic", "diana"]
    for name in names:
        assert type(ts.make_alpha_rule(name)).__name__ == type(js.make_alpha_rule(name)).__name__
    assert ts.make_alpha_rule("blockwise", beta=0.5).beta == 0.5
    with pytest.raises(ValueError, match="unknown alpha rule"):
        ts.make_alpha_rule("nope")


def _dx(seed, shapes):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}


def _local_stats(dx):
    return local_dx_stats({k: torch.from_numpy(v) for k, v in dx.items()})


def test_prop3_last_step_identity():
    """Prop 3: α = η√d/(√(2n)||Δx||)  =>  d·η²/α² == 2n||Δx||²."""
    rule = ts.AlphaLastStep()
    dx = _dx(1, [(64,)])
    d, n, eta = 64, 4, 0.1
    stats = _local_stats(dx)
    state = rule.update(rule.init({k: torch.from_numpy(v) for k, v in dx.items()}), stats)
    alpha = float(rule.alpha(state, torch.tensor(eta, dtype=torch.float32), n, d))
    sq = float(stats.sq)
    assert abs(d * eta**2 / alpha**2 - 2 * n * sq) / (2 * n * sq) < 1e-4


def test_prop4_blockwise_identity():
    """Prop 4: Σ_l d_l η²/α_l² == 2n Σ_l r_l (+ ε-term)."""
    rule = ts.AlphaBlockwise(beta=0.0, eps=0.0)
    dx = _dx(2, [(32, 16), (100,)])
    dims = {"p0": 512.0, "p1": 100.0}
    d = 612.0
    n, eta = 8, 0.05
    stats = _local_stats(dx)
    state = rule.update(rule.init({k: torch.from_numpy(v) for k, v in dx.items()}), stats)
    alphas = rule.alpha_tree(state, torch.tensor(eta, dtype=torch.float32), n, dims, d)
    lhs = sum(float(dims[k]) * eta**2 / float(alphas[k]) ** 2 for k in dims)
    rhs = 2 * n * float(stats.sq)
    assert abs(lhs - rhs) / rhs < 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_local_dx_stats_match_jax(seed):
    dx = _dx(seed, [(300, 700), (7,), (3, 5, 7), (4096,)])
    want = jlocal_dx_stats({k: jnp.asarray(v) for k, v in dx.items()})
    got = _local_stats(dx)
    assert set(got.leaf_sq) == set(want.leaf_sq)
    for k in dx:
        np.testing.assert_allclose(got.leaf_sq[k].numpy(), np.asarray(want.leaf_sq[k]), rtol=1e-6)
    np.testing.assert_allclose(got.sq.numpy(), np.asarray(want.sq), rtol=1e-6)
    # (name, tensor) pairs, made one at a time, give the same statistics
    pairs = local_dx_stats((k, torch.from_numpy(v)) for k, v in dx.items())
    assert all(torch.equal(pairs.leaf_sq[k], got.leaf_sq[k]) for k in dx)


@pytest.mark.parametrize("name", ["intsgd_block", "intsgd_determ"])
def test_registry_entries_match_jax_fields(name):
    j, t = jmake(name), make_compressor(name)
    assert isinstance(t, IntSGD)
    assert (t.bits, t.stochastic, t.wire) == (j.bits, j.stochastic, None)
    assert type(t.alpha_rule).__name__ == type(j.alpha_rule).__name__
    assert (t.alpha_rule.beta, t.alpha_rule.eps) == (j.alpha_rule.beta, j.alpha_rule.eps)
    assert t.blockwise == j.blockwise == (name == "intsgd_block")
    t8 = make_compressor(name, bits=8, wire="packed8")
    assert t8.wire_format == PackedInt(bits=8) and t8.bits == 8


def test_blockwise_compressor_gives_one_alpha_per_leaf():
    comp = make_compressor("intsgd_block")
    params = {k: torch.zeros(s) for k, s in LEAVES.items()}
    state = comp.init(params)
    _, td = _stats(_leaf_sq_sequence(9, 1)[0])
    state = comp.observe_update(state, td)
    dims = local_tree_dims(params)
    eta = torch.tensor(0.3, dtype=torch.float32)
    alphas = comp._alphas(state, sorted(params), eta, 4, dims)
    want = comp.alpha_rule.alpha_tree(state, eta, 4, dims.leaf_dims, float(dims.d))
    assert all(torch.equal(alphas[k], want[k]) and alphas[k].shape == () for k in LEAVES)
    glob = make_compressor("intsgd")
    a = glob._alphas(glob.init(params), sorted(params), eta, 4, dims)
    assert len({id(v) for v in a.values()}) == 1  # one global α shared by every leaf
