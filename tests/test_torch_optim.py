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
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw as jadamw, sgd as jsgd  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro_torch.optim import base  # noqa: E402
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
