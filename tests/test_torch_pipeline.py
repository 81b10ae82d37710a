"""Port vs JAX: microbatch wire pipelining (``encode_ints(n_accum=M)``, the
per-microbatch integer all-reduce, ``finish_pipelined``) and the train
step builder's checks of it.

- One pipelined round at n = 4 workers and M = 2 microbatches, for IntSGD
  on packed8 and IntDIANA on dense8, against JAX's round under
  ``vmap_workers`` with the same gradients, shifts, α state and
  per-(microbatch, worker, leaf) seeds: each microbatch's images, its
  summed image and the int32 accumulator bit for bit; ĝ, h_local and
  h_global at rtol 1e-6 (atol 1e-9) — the same f32 ops in the same order,
  up to XLA's FMA contractions.
- IntDIANA's pipelined estimator is unbiased (a port of
  ``tests/test_compressors.py::test_intdiana_pipelined_estimator_unbiased``).
- ``build_train_step`` raises the JAX package's three build-time errors
  word for word: the fused route with M > 1, M < 1, and a local batch that
  M does not divide.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.comm import CommCtx as JCommCtx  # noqa: E402
from repro.core.compressor import IntDIANA as JIntDIANA, IntSGD as JIntSGD, _leaf_keys  # noqa: E402
from repro.core.scaling import AlphaState as JAlphaState  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro.wire import DenseInt as JDenseInt, PackedInt as JPackedInt  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.core.scaling import AlphaState  # noqa: E402

N, M = 4, 2
SHAPES = {"a": (300, 70), "b": (1000,), "c": (3, 5, 7), "d": (8, 128)}
TOL = dict(rtol=1e-6, atol=1e-9)


def _seeds(key, like):
    """(M, n, n_leaves) int32: microbatch m's key fold_in(key, m), then the
    worker's fold_in, then one split per leaf — as the JAX step derives
    them."""
    out = np.zeros((M, N, len(like)), np.int32)
    for m in range(M):
        for w in range(N):
            keys = jax.tree.leaves(_leaf_keys(jax.random.fold_in(jax.random.fold_in(key, m), w), like))
            out[m, w] = [int(kops.seed_from_key(k)) for k in keys]
    return out


def _port_round(comp, state, grads, seeds, eta):
    """The port's pipelined round on the compressor API, as
    ``launch.step._pipelined_grad_stage`` runs it."""
    ctx = CommCtx(n_workers=N)
    wf = comp.wire_format
    images, sums, int_acc, local_acc, alphas = [], [], None, {}, {}
    for m in range(M):
        def gen():
            for w in range(N):
                ints, a = comp.encode_ints(
                    state, {k: torch.from_numpy(v[w, m]) for k, v in grads.items()},
                    seeds=seeds[m], eta=eta, ctx=ctx.at_worker(w), n_accum=M,
                )
                alphas.update(a)
                images.append(ints)
                for k, v in ints.items():
                    local_acc.setdefault(k, torch.zeros((N, *v.shape), dtype=torch.int32))
                    local_acc[k][w].add_(v)
                yield ints

        _, int_sum = ctx.psum_wire(gen(), wf)
        sums.append({k: v.clone() for k, v in int_sum.items()})
        int_acc = int_sum if int_acc is None else {k: int_acc[k] + v for k, v in int_sum.items()}
    ghat, st = comp.finish_pipelined(
        state, int_acc, local_acc if comp.fused_local_state else None, alphas, ctx=ctx,
        n_accum=M)
    return images, sums, int_acc, ghat, st


@pytest.mark.parametrize("comp_name,wire", [("intsgd", "packed8"), ("intdiana", "dense8")])
def test_pipelined_round_matches_jax_n4(comp_name, wire):
    rng = np.random.default_rng([len(comp_name), M])
    grads = {k: (rng.standard_normal((N, M, *s)) * 1e-2).astype(np.float32)
             for k, s in SHAPES.items()}
    h_local = {k: (g.mean(axis=1) + rng.standard_normal(g.shape[:1] + g.shape[2:])
                   .astype(np.float32) * 3e-3) for k, g in grads.items()}
    h_global = {k: h.mean(axis=0).astype(np.float32) for k, h in h_local.items()}
    r, step, eta = np.float32(3e-5), 2, np.float32(0.18)
    key = jax.random.PRNGKey(11)
    seeds = _seeds(key, {k: v[0, 0] for k, v in grads.items()})

    # ---- JAX: the pipelined round per worker under the worker vmap
    jwire = {"packed8": JPackedInt, "dense8": JDenseInt}[wire](8, use_kernels=True)
    jctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))
    jalpha = JAlphaState(r=jnp.float32(r), step=jnp.int32(step))
    if comp_name == "intsgd":
        jcomp = JIntSGD(bits=8, wire=jwire, use_kernels=True)
    else:
        jcomp = JIntDIANA(bits=8, wire=jwire)
    jhg = {k: jnp.asarray(v) for k, v in h_global.items()}

    def worker(g, hl):
        state = jalpha if comp_name == "intsgd" else {
            "alpha": jalpha, "h_local": hl, "h_global": jhg}
        imgs, sums = [], []
        int_acc = local_acc = alphas = None
        for m in range(M):
            ints, alphas = jcomp.encode_ints(
                state, jax.tree.map(lambda v: v[m], g), key=jax.random.fold_in(key, m),
                eta=jnp.float32(eta), ctx=jctx, n_accum=M)
            local_acc = ints if local_acc is None else jax.tree.map(jnp.add, local_acc, ints)
            _, int_sum = jctx.psum_wire(ints, jcomp.wire_format)
            int_acc = int_sum if int_acc is None else jax.tree.map(jnp.add, int_acc, int_sum)
            imgs.append(ints)
            sums.append(int_sum)
        ghat, st = jcomp.finish_pipelined(state, int_acc, local_acc, alphas, ctx=jctx, n_accum=M)
        return imgs, sums, int_acc, ghat, st

    jimgs, jsums, jacc, jghat, jst = jcoll.vmap_workers(worker, in_axes=(0, 0))(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in h_local.items()})

    # ---- port: the same inputs and seeds
    comp = make_compressor(comp_name, bits=8, wire=wire)
    assert comp.fused_capable
    alpha = AlphaState(r=torch.tensor(r), step=torch.tensor(step, dtype=torch.int32))
    state = alpha if comp_name == "intsgd" else {
        "alpha": alpha,
        "h_local": {k: torch.from_numpy(v.copy()) for k, v in h_local.items()},
        "h_global": {k: torch.from_numpy(v.copy()) for k, v in h_global.items()},
    }
    images, sums, int_acc, ghat, st = _port_round(
        comp, state, grads, torch.from_numpy(seeds), torch.tensor(eta))

    lim_sum = N * comp.wire_format.clip_limit(N * M)  # the clip for the n·M sum
    for m in range(M):
        for w in range(N):
            for k in SHAPES:
                np.testing.assert_array_equal(images[m * N + w][k].numpy(),
                                              np.asarray(jimgs[m][k][w]))
        for k in SHAPES:
            np.testing.assert_array_equal(sums[m][k].numpy(), np.asarray(jsums[m][k][0]))
            assert int(sums[m][k].abs().max()) <= lim_sum
    for k in SHAPES:
        np.testing.assert_array_equal(int_acc[k].numpy(), np.asarray(jacc[k][0]))
        np.testing.assert_allclose(ghat[k].numpy(), np.asarray(jghat[k][0]), **TOL)
    if comp_name == "intdiana":
        for k in SHAPES:
            np.testing.assert_allclose(st["h_local"][k].numpy(), np.asarray(jst["h_local"][k]),
                                       **TOL)
            np.testing.assert_allclose(st["h_global"][k].numpy(),
                                       np.asarray(jst["h_global"][k][0]), **TOL)
            assert st["h_global"][k] is ghat[k]
    else:
        assert st is state


def test_intdiana_pipelined_estimator_unbiased():
    """Every image carries the full local shift: the pipelined round
    recovers the true gradient mean to quantization precision, h_i moves to
    worker i's mean gradient, and h advances to ĝ. A per-image h_i/M
    dilution would decode to ḡ + h̄·(1 − 1/M)."""
    rng = np.random.default_rng(0)
    d = 64
    g = rng.standard_normal((N, M, d)).astype(np.float32)
    h0 = rng.standard_normal((N, d)).astype(np.float32)
    comp = make_compressor("intdiana", stochastic=False)
    state = comp.init({"w": torch.zeros(d)}, N)
    # α = η√d/(√n·√r) = 1e6: rounding error ~5e-7, far below the h̄-scale
    # bias the dilution would leave, and far inside the int32 clip
    state = dict(state, alpha=AlphaState(r=torch.tensor(np.float32(1.6e-11)),
                                         step=torch.tensor(1, dtype=torch.int32)),
                 h_local={"w": torch.from_numpy(h0.copy())},
                 h_global={"w": torch.from_numpy(h0.mean(0))})
    seeds = torch.zeros((M, N, 1), dtype=torch.int32)
    _, _, _, ghat, st = _port_round(comp, state, {"w": g}, seeds, torch.tensor(1.0))
    np.testing.assert_allclose(ghat["w"].numpy(), g.mean(axis=(0, 1)), atol=1e-4)
    np.testing.assert_allclose(st["h_local"]["w"].numpy(), g.mean(axis=1), atol=1e-4)
    np.testing.assert_allclose(st["h_global"]["w"].numpy(), ghat["w"].numpy(), atol=1e-6)


def _builders():
    from repro.configs import ShapeConfig as JShape, get_arch as jget_arch, smoke_config as jsmoke
    from repro.launch.step import build_train_step as jbuild
    from repro.optim import sgd as jsgd
    from repro.optim.schedules import constant as jconstant
    from repro.parallel.collectives import mesh_from_counts
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.launch.step import build_train_step
    from repro_torch.optim.schedules import constant
    from repro_torch.optim.sgd import sgd

    def jax_build(batch, **kw):
        return jbuild(jsmoke(jget_arch("granite-8b")), mesh_from_counts(data=1, model=1),
                      JShape("t", 16, batch, "train"),
                      compressor=JIntSGD(bits=8, wire=JPackedInt(8)),
                      base_opt=jsgd(momentum=0.9), lr_schedule=jconstant(0.1), **kw)

    def port_build(batch, n_workers=1, **kw):
        return build_train_step(smoke_config(get_arch("granite-8b")),
                                ShapeConfig("t", 16, batch, "train"), n_workers=n_workers,
                                compressor=make_compressor("intsgd8_packed"),
                                base_opt=sgd(momentum=0.9), lr_schedule=constant(0.1),
                                device="cpu", **kw)

    return jax_build, port_build


@pytest.mark.parametrize("kw", [dict(fused=True, microbatches=2), dict(microbatches=0),
                                dict(microbatches=3)])
def test_build_errors_match_jax_word_for_word(kw):
    jax_build, port_build = _builders()
    with pytest.raises(ValueError) as jerr:
        jax_build(4, **kw)
    with pytest.raises(ValueError) as terr:
        port_build(4, **kw)
    assert str(terr.value) == str(jerr.value)
    assert "microbatch" in str(terr.value)
    # the local batch is the global batch over the workers
    if kw == dict(microbatches=3):
        with pytest.raises(ValueError, match=r"local batch 2 \(global 8 over 4 workers\)"):
            port_build(8, n_workers=4, **kw)
        port_build(12, n_workers=4, **kw)  # 3 per worker: builds


def test_pipelined_step_needs_seeds_per_microbatch():
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.launch.step import build_init_state
    from repro_torch.models.transformer import init_lm_params

    _, port_build = _builders()
    art = port_build(8, n_workers=2, microbatches=2)
    params = init_lm_params(smoke_config(get_arch("granite-8b")),
                            generator=torch.Generator().manual_seed(0), device="cpu")
    comp = make_compressor("intsgd8_packed")
    from repro_torch.optim.sgd import sgd

    opt_state, cs = build_init_state(params, n_workers=2, compressor=comp,
                                     base_opt=sgd(momentum=0.9))
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int64),
             "labels": torch.zeros((8, 16), dtype=torch.int64)}
    with pytest.raises(ValueError, match=r"\(M, n_workers, n_leaves\)"):
        art.steps["compressed"](params, opt_state, cs, 1, batch,
                                torch.zeros((2, len(params)), dtype=torch.int32))
