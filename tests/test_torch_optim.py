"""Port vs JAX: the optimizers' fused-route registry, AdamW's scalar tail
and its exact-step update, and the §4.1 dx_scale of both optimizers.

``fused_step_scalars``: lr, b1, omb1 = f32(1−b1), b2, omb2, eps, wd are
bit-equal. The bias corrections bc = 1 − b^t (t the f32 step count) are
PyTorch's ``pow`` against XLA's: on the train path's 0-d count they are
bit-equal over the first 200 steps (asserted); over a vector of 4000 counts
(both frameworks' vectorized paths) 2 of the 8000 values differ, by up to
2 ULP, so the vector check's tolerance is 2 ULP.
``fused_reference_update`` (the exact step 0): rtol=1e-6, atol=1e-9 — XLA
may contract a product and a sum into one FMA, the port never does.

The simulator's pieces: ``step_decay`` is bit-equal to JAX's over a step
range; ``cosine_decay`` agrees to lr·2^-23 — within one float32 ULP of
cos(πt), which XLA's CPU cos does not round correctly (about 1 % of
arguments off by one ULP) and PyTorch's does. ``apply_updates`` is
bit-equal, in float32 and bf16; ``chain_clip_by_global_norm``'s update at
rtol 1e-6 (||g||² is summed in another order) and, like JAX's, not
fused-capable.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw as jadamw, sgd as jsgd  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.optim import base  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-9)
SHAPES = {"a": (300, 70), "b": (1000,), "c": (3, 5, 7)}


def test_adamw_fused_step_scalars_match_jax():
    jo, to = jadamw(weight_decay=1e-4), adamw(weight_decay=1e-4)
    counts = np.arange(4000, dtype=np.int32)  # the scalar state before the step
    jtail, jnew = jbase.fused_step_scalars(jo, {"count": jnp.asarray(counts)}, jnp.float32(3e-4))
    ttail, tnew = base.fused_step_scalars(
        to, {"count": torch.from_numpy(counts)}, torch.tensor(3e-4)
    )
    assert base.FUSED_SCALAR_TAIL["adamw"] == jbase.FUSED_SCALAR_TAIL["adamw"]
    assert len(ttail) == len(jtail) == 9
    for name, j, t in zip(base.FUSED_SCALAR_TAIL["adamw"], jtail, ttail):
        assert t.dtype == torch.float32, name
        got = np.broadcast_to(t.numpy(), counts.shape)
        want = np.broadcast_to(np.asarray(j, np.float32), counts.shape)
        if name in ("bc1", "bc2"):
            np.testing.assert_array_max_ulp(got, want, maxulp=2)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for c in range(200):  # the train path: one 0-d count per step
        jt, _ = jbase.fused_step_scalars(jo, {"count": jnp.int32(c)}, jnp.float32(3e-4))
        tt, _ = base.fused_step_scalars(
            to, {"count": torch.tensor(c, dtype=torch.int32)}, torch.tensor(3e-4)
        )
        assert tt[7].item() == float(jt[7]) and tt[8].item() == float(jt[8]), c
    assert ttail[2].item() == np.float32(1.0 - 0.9) and ttail[4].item() == np.float32(1.0 - 0.95)
    np.testing.assert_array_equal(tnew["count"].numpy(), np.asarray(jnew["count"]))
    assert tnew["count"].dtype == torch.int32


def _tree(rng, scale, nonneg=False):
    out = {}
    for k, s in SHAPES.items():
        v = rng.standard_normal(s).astype(np.float32) * scale
        out[k] = np.abs(v) if nonneg else v
    return out


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
@pytest.mark.parametrize("count", [0, 7])
def test_fused_reference_update_matches_jax(kind, count):
    rng = np.random.default_rng([count, len(kind)])
    params, ghat = _tree(rng, 0.02), _tree(rng, 0.01)
    if kind == "sgd":
        jo, to = jsgd(momentum=0.9, weight_decay=1e-4), sgd(momentum=0.9, weight_decay=1e-4)
        state = {"mom": _tree(rng, 1e-3)}
    else:
        jo, to = jadamw(weight_decay=1e-4), adamw(weight_decay=1e-4)
        state = {"mu": _tree(rng, 1e-3), "nu": _tree(rng, 1e-5, nonneg=True),
                 "count": np.int32(count)}
    eta = np.float32(3e-4)
    jstate = {k: ({n: jnp.asarray(a) for n, a in v.items()} if isinstance(v, dict)
                  else jnp.asarray(v)) for k, v in state.items()}
    tstate = {k: ({n: torch.from_numpy(a) for n, a in v.items()} if isinstance(v, dict)
                  else torch.tensor(v)) for k, v in state.items()}
    jp, jnew = jbase.fused_reference_update(
        jo, {k: jnp.asarray(v) for k, v in ghat.items()},
        {k: jnp.asarray(v) for k, v in params.items()}, jstate, jnp.asarray(eta),
    )
    tp, tnew = base.fused_reference_update(
        to, {k: torch.from_numpy(v) for k, v in ghat.items()},
        {k: torch.from_numpy(v) for k, v in params.items()}, tstate, torch.tensor(eta),
    )
    assert set(tnew) == set(jnew)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
        for name in base.FUSED_STATE_TENSORS[kind]:
            np.testing.assert_allclose(tnew[name][k].numpy(), np.asarray(jnew[name][k]), **TOL)
    if kind == "adamw":
        assert int(tnew["count"]) == int(jnew["count"]) == count + 1


def _root_f64(x):
    """The correctly rounded float32 square root: through float64."""
    return np.sqrt(x.astype(np.float64)).astype(np.float32)


def test_sqrt_rn_is_correctly_rounded():
    """``kernels.ref.sqrt_rn`` on the CPU equals numpy's float32 root
    (IEEE, correctly rounded) bit for bit, over values from 1e-30 to 1e30
    and the second moments' range."""
    from repro_torch.kernels.ref import sqrt_rn

    rng = np.random.default_rng(5)
    x = np.concatenate([10.0 ** rng.uniform(-30, 30, 1 << 18),
                        np.abs(rng.standard_normal(1 << 18)) * 1e-10]).astype(np.float32)
    got = sqrt_rn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))


@pytest.mark.parametrize("path", ["fused_reference_update", "fused_adamw_ref", "adamw_update"])
def test_adamw_plain_passes_take_a_correctly_rounded_root(path):
    """Each plain AdamW pass equals, bit for bit, the same float32 arithmetic
    in numpy with the root taken through float64, on a fixed (300, 70)
    input whose second moments are tiny (where an ULP of the root moves the
    step most). The CPU's float32 ``torch.sqrt`` is not correctly rounded,
    and which elements it gets wrong changes from process to process."""
    from repro_torch.kernels.ref import fused_adamw_ref

    rng = np.random.default_rng(2024)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    p, g, mu = f32(300, 70, scale=0.02), f32(300, 70, scale=0.01), f32(300, 70, scale=1e-3)
    nu = np.abs(f32(300, 70, scale=1e-5))
    t = lambda a: torch.from_numpy(a)
    opt = adamw(weight_decay=1e-4)
    tail, _ = base.fused_step_scalars(opt, {"count": torch.tensor(7, dtype=torch.int32)},
                                      torch.tensor(3e-4))
    lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2 = (np.float32(v.item()) for v in tail)
    if path == "fused_reference_update":
        got, new = base.fused_reference_update(
            opt, {"a": t(g)}, {"a": t(p)},
            {"mu": {"a": t(mu)}, "nu": {"a": t(nu)}, "count": torch.tensor(7, dtype=torch.int32)},
            torch.tensor(3e-4))
        got, got_v = got["a"], new["nu"]["a"]
        m, v = b1 * mu + omb1 * g, b2 * nu + omb2 * (g * g)
        want = p - lr * ((m / bc1) / (_root_f64(v / bc2) + eps) + wd * p)
    elif path == "fused_adamw_ref":
        ints = rng.integers(-400, 400, (300, 70)).astype(np.int32)
        inv = np.float32(2.5e-5)
        got, _, got_v = fused_adamw_ref(t(ints), t(p), t(mu), t(nu), inv_nalpha=torch.tensor(inv),
                                        **dict(zip(base.FUSED_SCALAR_TAIL["adamw"], tail)))
        gg = ints.astype(np.float32) * inv
        m, v = b1 * mu + omb1 * gg, b2 * nu + (omb2 * gg) * gg
        want = p - lr * ((m / bc1) / (_root_f64(v / bc2) + eps) + wd * p)
    else:
        state = {"mu": {"a": t(mu)}, "nu": {"a": t(nu)}, "count": torch.tensor(7, dtype=torch.int32)}
        upd, new = opt.update({"a": t(g)}, state, {"a": t(p)}, torch.tensor(3e-4))
        got, got_v = upd["a"], new["nu"]["a"]
        tb1, tb2 = np.float32(0.9), np.float32(0.95)
        m = tb1 * mu + np.float32(1 - 0.9) * g
        v = tb2 * nu + np.float32(1 - 0.95) * np.square(g)
        tc = torch.tensor(8.0)  # the count after the step
        c1 = np.float32((1.0 - torch.pow(0.9, tc)).item())
        c2 = np.float32((1.0 - torch.pow(0.95, tc)).item())
        want = -np.float32(3e-4) * ((m / c1) / (_root_f64(v / c2) + np.float32(1e-8))
                                     + np.float32(1e-4) * p)
    np.testing.assert_array_equal(got_v.numpy(), v)
    np.testing.assert_array_equal(got.numpy(), want)


def test_adamw_unfused_update_matches_jax():
    rng = np.random.default_rng(3)
    params, grads = _tree(rng, 0.02), _tree(rng, 0.01)
    jo, to = jadamw(weight_decay=1e-4), adamw(weight_decay=1e-4)
    jstate = jo.init({k: jnp.asarray(v) for k, v in params.items()})
    tstate = to.init({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(3):
        ju, jstate = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                               {k: jnp.asarray(v) for k, v in params.items()}, jnp.float32(3e-4))
        tu, tstate = to.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate,
                               {k: torch.from_numpy(v) for k, v in params.items()},
                               torch.tensor(3e-4))
    for k in SHAPES:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(tstate["nu"][k].numpy(), np.asarray(jstate["nu"][k]), **TOL)
    assert int(tstate["count"]) == int(jstate["count"]) == 3


def test_dx_scale_and_fused_capabilities_match_jax():
    for b1 in (0.9, 0.8):
        assert adamw(b1=b1).dx_scale == 1 - b1 == jadamw(b1=b1).dx_scale
    assert sgd(momentum=0.9).dx_scale == jsgd(momentum=0.9).dx_scale
    assert adamw().fused_kernel == "adamw" and adamw().kind == "adamw"
    assert base.FUSED_STATE_TENSORS == jbase.FUSED_STATE_TENSORS
    assert base.FUSED_STATE_SCALARS == jbase.FUSED_STATE_SCALARS
    st = base.fused_state_init(adamw(), {"w": torch.zeros(3, 4)})
    assert set(st) == {"mu", "nu", "count"} and st["count"].dtype == torch.int32
    assert st["mu"]["w"].shape == (3, 4) and int(st["count"]) == 0


@pytest.mark.parametrize("lr,boundaries,factor", [(0.1, [30, 60, 90], 0.1), (0.3, [5, 7], 0.5),
                                                  (1e-3, [2, 3, 100], 0.2)])
def test_step_decay_matches_jax_bit_for_bit(lr, boundaries, factor):
    j, t = jsched.step_decay(lr, boundaries, factor), schedules.step_decay(lr, boundaries, factor)
    want = np.array([np.asarray(j(jnp.int32(s))) for s in range(120)], np.float32)
    got = np.array([t(s).item() for s in range(120)], np.float32)
    assert t(3).dtype == torch.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lr,total,final", [(0.1, 100, 0.1), (0.3, 1000, 0.0),
                                            (3e-4, 777, 0.05)])
def test_cosine_decay_matches_jax(lr, total, final):
    j, t = jsched.cosine_decay(lr, total, final), schedules.cosine_decay(lr, total, final)
    steps = range(0, total + 20)
    want = np.array([np.asarray(j(jnp.int32(s))) for s in steps], np.float64)
    got = np.array([t(s).item() for s in steps], np.float64)
    assert t(3).dtype == torch.float32
    assert np.abs(got - want).max() <= lr * 2.0**-23
    assert (got == want).mean() > 0.9
    assert got[-1] == want[-1] == np.float32(lr) * np.float32(final)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(dtype):
    rng = np.random.default_rng(11)
    params, upd = _tree(rng, 0.02), _tree(rng, 1e-3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    want = jbase.apply_updates(jp, {k: jnp.asarray(v) for k, v in upd.items()})
    got = base.apply_updates(tp, {k: torch.from_numpy(v) for k, v in upd.items()})
    for k in SHAPES:
        assert got[k].dtype == tdt
        np.testing.assert_array_equal(got[k].to(torch.float32).numpy(),
                                      np.asarray(want[k]).astype(np.float32))


@pytest.mark.parametrize("max_norm", [0.05, 100.0])
def test_chain_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng([int(max_norm * 100)])
    params, grads, mom = _tree(rng, 0.02), _tree(rng, 0.01), _tree(rng, 1e-3)
    jo = jbase.chain_clip_by_global_norm(jsgd(momentum=0.9, weight_decay=1e-4), max_norm)
    to = base.chain_clip_by_global_norm(sgd(momentum=0.9, weight_decay=1e-4), max_norm)
    assert to.fused_kernel is None and to.kind == "custom" and to.dx_scale == jo.dx_scale
    j = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    tt = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}  # noqa: E731
    jupd, jst = jo.update(j(grads), j(mom), j(params), jnp.float32(0.3))
    tupd, tst = to.update(tt(grads), tt(mom), tt(params), torch.tensor(np.float32(0.3)))
    for k in SHAPES:
        np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]), **TOL)
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)
