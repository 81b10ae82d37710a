"""Port vs JAX: IntDIANA (Algorithm 3) at n = 4 workers — the compressed
stage, the shift advance, the AlphaDiana rule and the fused update with
the shift, on the dense8 and packed8 wires.

JAX side: ``IntDIANA(bits=8, wire=<codec>(8, use_kernels=True))
.aggregate_wire`` under ``coll.vmap_workers`` with a 4-worker ``CommCtx``
(h_local mapped over the workers, α state and h_global replicated), then
the fused AdamW kernel with ``shift=h_global`` per leaf
(``kops.fused_apply`` / ``kops.fused_unpack_apply``, interpret mode). Port
side: the same gradients, shifts, α state and per-(worker, leaf) seeds.

Summed words (in the lane type) and images are bit-equal; α, the advanced
h_local, the decoded ĝ and the update's outputs (params, both moments and
the new shift) agree to rtol=1e-6 (atol=1e-9): the same f32 ops in the
same order, up to XLA's FMA contractions.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.comm import CommCtx as JCommCtx  # noqa: E402
from repro.core.compressor import IntDIANA as JIntDIANA, _leaf_keys  # noqa: E402
from repro.core.scaling import AlphaState as JAlphaState  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro.wire import DenseInt as JDenseInt, PackedInt as JPackedInt  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import IntDIANA, make_compressor  # noqa: E402
from repro_torch.core.scaling import AlphaDiana, AlphaState  # noqa: E402
from repro_torch.optim import base  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.wire import DenseInt, PackedInt  # noqa: E402

N = 4
SHAPES = {"a": (300, 70), "b": (1000,), "c": (3, 5, 7), "d": (8, 128)}
TOL = dict(rtol=1e-6, atol=1e-9)
JWIRES = {"dense8": JDenseInt, "packed8": JPackedInt}


def _jax_seeds(key, grads):
    rows = []
    for w in range(N):
        keys = jax.tree.leaves(_leaf_keys(jax.random.fold_in(key, w), grads))
        rows.append([int(kops.seed_from_key(k)) for k in keys])
    return np.array(rows, np.int32)


@pytest.mark.parametrize("wire", ["dense8", "packed8"])
@pytest.mark.parametrize("r,step", [(3e-5, 1), (2e-3, 6)])
def test_intdiana_stage_matches_jax_n4(wire, r, step):
    rng = np.random.default_rng([int(r * 1e6), step, len(wire)])
    grads = {k: (rng.standard_normal((N, *s)) * 1e-2).astype(np.float32)
             for k, s in SHAPES.items()}
    # shifts from earlier steps: h_i near the worker's gradient, h its mean
    h_local = {k: (g + rng.standard_normal(g.shape).astype(np.float32) * 3e-3)
               for k, g in grads.items()}
    h_global = {k: h.mean(axis=0).astype(np.float32) for k, h in h_local.items()}
    p = {k: (rng.standard_normal(s) * 0.02).astype(np.float32) for k, s in SHAPES.items()}
    mu = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32) for k, s in SHAPES.items()}
    nu = {k: (np.abs(rng.standard_normal(s)) * 1e-5).astype(np.float32) for k, s in SHAPES.items()}
    eta = np.float32(3e-4 * (min(step, 4) + 1) / 5)
    key = jax.random.PRNGKey(step + 29)

    # ---- JAX: per-worker aggregate_wire under the worker vmap
    jcomp = JIntDIANA(bits=8, wire=JWIRES[wire](8, use_kernels=True))
    jctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))
    jalpha = JAlphaState(r=jnp.float32(r), step=jnp.int32(step))
    jhg = {k: jnp.asarray(v) for k, v in h_global.items()}

    def worker(g, hl, k):
        state = {"alpha": jalpha, "h_local": hl, "h_global": jhg}
        wa, alphas, st, met = jcomp.aggregate_wire(state, g, key=k, eta=jnp.float32(eta), ctx=jctx)
        ghat, _, _ = jcomp.aggregate(state, g, key=k, eta=jnp.float32(eta), ctx=jctx)
        return wa.words, wa.ints, alphas, st["h_local"], ghat, met.max_int

    jwords, jints, jalphas, jhl, jghat, jmax = jcoll.vmap_workers(worker, in_axes=(0, 0, None))(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in h_local.items()}, key,
    )

    # ---- port: the same inputs and seeds
    seeds = torch.from_numpy(_jax_seeds(key, {k: v[0] for k, v in grads.items()}))
    comp = make_compressor("intdiana", bits=8, wire=wire)
    assert isinstance(comp, IntDIANA) and comp.fused_capable

    def state():
        return {
            "alpha": AlphaState(r=torch.tensor(np.float32(r)),
                                step=torch.tensor(step, dtype=torch.int32)),
            "h_local": {k: torch.from_numpy(v.copy()) for k, v in h_local.items()},
            "h_global": {k: torch.from_numpy(v.copy()) for k, v in h_global.items()},
        }

    def worker_grads():
        return ({k: torch.from_numpy(v[w]) for k, v in grads.items()} for w in range(N))

    st0 = state()
    wa, alphas, st, met = comp.aggregate_wire(
        st0, worker_grads(), seeds=seeds, eta=torch.tensor(eta), ctx=CommCtx(n_workers=N),
    )
    lane = torch.int8 if wire == "dense8" else torch.int32
    opt = adamw(weight_decay=1e-4)
    tail, _ = base.fused_step_scalars(opt, {"count": torch.tensor(step, dtype=torch.int32)},
                                      torch.tensor(eta))
    for k in SHAPES:
        assert wa.words[k].dtype == lane and str(np.asarray(jwords[k]).dtype) == str(lane).split(".")[1]
        np.testing.assert_array_equal(wa.words[k].numpy(), np.asarray(jwords[k][0]))
        np.testing.assert_array_equal(wa.ints[k].numpy(), np.asarray(jints[k][0]))
        np.testing.assert_allclose(alphas[k].numpy(), np.asarray(jalphas[k][0]), rtol=1e-6)
        np.testing.assert_allclose(st["h_local"][k].numpy(), np.asarray(jhl[k]), **TOL)
        # the fused AdamW update with the shift, on the summed payload
        sc = torch.stack([1.0 / (N * alphas[k]), torch.tensor(0.61), *tail])
        tp, (tm, tv), th = comp.wire_format.fused_update(
            wa.words[k], torch.from_numpy(p[k]), (torch.from_numpy(mu[k]), torch.from_numpy(nu[k])),
            sc, kernel="adamw", n_summed=N, shift=comp.fused_shift(st)[k],
        )
        jsc = jnp.asarray(sc.numpy())
        jargs = (jwords[k][0], jnp.asarray(p[k]), (jnp.asarray(mu[k]), jnp.asarray(nu[k])), jsc,
                 jnp.asarray(h_global[k]))
        if wire == "dense8":
            jp, (jm, jv), jh = kops.fused_apply(*jargs, kernel="adamw")
        else:
            jp, (jm, jv), jh = kops.fused_unpack_apply(*jargs, kernel="adamw", bits=8, n_summed=N)
        for got, want in ((tp, jp), (tm, jm), (tv, jv), (th, jh)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # the new shift is the decoded aggregate ĝ = h + Σints/(nα)
        np.testing.assert_allclose(th.numpy(), np.asarray(jghat[k][0]), **TOL)
    assert float(met.max_int) == float(jmax[0]) <= N * 31

    # the decode-here wrapper on the same inputs: ĝ == the new global shift
    ghat, st2, _ = comp.aggregate(
        state(), worker_grads(), seeds=seeds, eta=torch.tensor(eta), ctx=CommCtx(n_workers=N),
    )
    for k in SHAPES:
        np.testing.assert_allclose(ghat[k].numpy(), np.asarray(jghat[k][0]), **TOL)
        assert st2["h_global"][k] is ghat[k]


@pytest.mark.parametrize("r,step", [(3e-5, 1), (2e-3, 6), (0.0, 0)])
@pytest.mark.parametrize("eta", [3e-4, 0.3])
def test_alpha_diana_matches_jax(r, step, eta):
    from repro.core.scaling import AlphaDiana as JAlphaDiana

    want = JAlphaDiana().alpha(JAlphaState(r=jnp.float32(r), step=jnp.int32(step)),
                               jnp.float32(eta), N, 123457)
    got = AlphaDiana().alpha(AlphaState(r=torch.tensor(np.float32(r)),
                                        step=torch.tensor(step, dtype=torch.int32)),
                             torch.tensor(np.float32(eta)), N, 123457)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_intdiana_init_and_registry():
    params = {"w": torch.zeros(3, 4), "b": torch.zeros(5)}
    comp = make_compressor("intdiana")
    assert comp.wire_format == DenseInt(bits=32) and comp.fused_local_state
    st = comp.init(params, n_workers=4)
    assert st["h_local"]["w"].shape == (4, 3, 4) and st["h_global"]["b"].shape == (5,)
    assert make_compressor("intdiana", bits=8, wire="packed8").wire_format == PackedInt(bits=8)
    assert make_compressor("intsgd8").wire_format == DenseInt(bits=8)
    assert make_compressor("intsgd4").wire_format.lane_dtype == torch.int8
