"""Port vs JAX: ZeRO-1 (``optim/zero1.py``) and the uncompressed baseline.

- ``shard_leaf`` / ``zero1_init``: the port's (n_dp, ceil(k/n_dp)) master
  rows and the optimizer state's layout equal the JAX package's, bit for
  bit, at n_dp = 4 (ragged leaves padded with zeros at the end).
- ``zero1_update`` at n_dp = 4 for ``sgd(0.9, 1e-4)``, ``sgd(0.9,
  nesterov=True)`` and ``adamw(weight_decay=1e-4)``, against JAX's
  ``zero1_update`` run per worker under ``vmap_workers``: master rows,
  moments, ``count`` and the gathered params in f32 and bf16. The port
  updates the n rows as one tensor op, the same f32 ops in the same order.
  SGD agrees bit for bit. AdamW's moments and count agree bit for bit, its
  master rows to rtol 1e-6 (atol 1e-9): XLA's CPU sqrt is not correctly
  rounded (about 0.7 % of float32 inputs come out one ULP off IEEE sqrtf,
  which PyTorch computes), and the master add m + u cancels. The gathered
  params are each side's own master rows, cast and cut, bit for bit.
- ``zero1_state_from_jax`` carries JAX's global ZeRO-1 state (from
  ``build_init_state(fused=False)`` and from ``zero1_init`` at n_dp = 4)
  over to the port's layout and back unchanged.
- ``NoCompression`` (``none``) and ``allgather_sgd`` at n = 4 against
  JAX's pmean and all-gather under ``vmap_workers``: ĝ at rtol 1e-6 (the
  float sums run in another order), the metrics exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.comm import CommCtx as JCommCtx  # noqa: E402
from repro.core.compressor import NoCompression as JNoCompression  # noqa: E402
from repro.optim import adamw as jadamw, sgd as jsgd  # noqa: E402
from repro.optim import zero1 as jzero1  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import NoCompression, make_compressor  # noqa: E402
from repro_torch.models.transformer import zero1_state_from_jax  # noqa: E402
from repro_torch.optim import zero1  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402

N = 4
# ragged leaves (pad 2, 3, 1 at n_dp = 4), an exact split and a scalar-ish one
SHAPES = {"a": (300, 70), "b": (1001,), "c": (3, 5, 7), "d": (8, 128), "e": (3,)}
OPTS = {
    "sgd": (lambda: jsgd(momentum=0.9, weight_decay=1e-4),
            lambda: sgd(momentum=0.9, weight_decay=1e-4)),
    "sgd_nesterov": (lambda: jsgd(momentum=0.9, nesterov=True),
                     lambda: sgd(momentum=0.9, nesterov=True)),
    "adamw": (lambda: jadamw(weight_decay=1e-4), lambda: adamw(weight_decay=1e-4)),
}


def _tree(rng, scale, shapes=SHAPES):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_shard_leaf_and_init_match_jax_layout():
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.02)
    for name, (jmake, tmake) in OPTS.items():
        jstate = jzero1.zero1_init(jmake(), {k: jnp.asarray(v) for k, v in params.items()}, N)
        state = zero1.zero1_init(tmake(), _t(params), N)
        for k, p in params.items():
            per = -(-p.size // N)
            got = state["master"][k]
            assert got.shape == (N, per) and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(jstate["master"][k]))
            assert not got.reshape(-1)[p.size:].any()  # zero padding at the end
            np.testing.assert_array_equal(
                zero1.shard_leaf(torch.from_numpy(p), N).numpy(),
                np.asarray(jzero1.shard_leaf(jnp.asarray(p), N)))
        if name == "adamw":
            assert state["base"]["count"].dtype == torch.int32
            assert int(state["base"]["count"]) == int(jstate["base"]["count"]) == 0
            moments = [state["base"]["mu"], state["base"]["nu"]]
        else:
            moments = [state["base"]]
        for m in moments:
            assert all(m[k].shape == state["master"][k].shape and not m[k].any()
                       for k in params)
        # a copy: the masters never share the params' storage
        src = _t(params)
        assert all(zero1.zero1_init(tmake(), src, N)["master"][k].data_ptr()
                   != src[k].data_ptr() for k in src)


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_zero1_update_matches_jax_n4(opt, param_dtype):
    rng = np.random.default_rng([len(opt), len(param_dtype)])
    jmake, tmake = OPTS[opt]
    jo, to = jmake(), tmake()
    params = _tree(rng, 0.02)
    ghat = _tree(rng, 1e-2)
    eta = np.float32(0.3 if opt.startswith("sgd") else 3e-4)
    # a state one step in: masters off the params, nonzero moments, count 2
    state = zero1.zero1_init(to, _t(params), N)
    state["master"] = {k: m + torch.from_numpy(
        (rng.standard_normal(m.shape) * 1e-4).astype(np.float32)) for k, m in state["master"].items()}
    if opt == "adamw":
        state["base"] = {
            "mu": {k: torch.from_numpy((rng.standard_normal(m.shape) * 1e-3).astype(np.float32))
                   for k, m in state["master"].items()},
            "nu": {k: torch.from_numpy((np.abs(rng.standard_normal(m.shape)) * 1e-5)
                                       .astype(np.float32)) for k, m in state["master"].items()},
            "count": torch.tensor(2, dtype=torch.int32),
        }
    else:
        state["base"] = {k: torch.from_numpy((rng.standard_normal(m.shape) * 1e-3)
                                             .astype(np.float32))
                         for k, m in state["master"].items()}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    plike = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}

    # ---- JAX: each worker updates its own row inside the worker vmap; the
    # state leaves carry the local dp dim of 1, count is replicated
    rows = lambda t: {k: jnp.asarray(v.numpy())[:, None] for k, v in t.items()}
    if opt == "adamw":
        jbase = {"mu": rows(state["base"]["mu"]), "nu": rows(state["base"]["nu"]),
                 "count": jnp.int32(2)}
        base_axes = {"mu": 0, "nu": 0, "count": None}
    else:
        jbase, base_axes = rows(state["base"]), 0
    jstate = {"master": rows(state["master"]), "base": jbase}

    def worker(st, g):
        return jzero1.zero1_update(
            jo, st, g, jnp.float32(eta), dp_axes=(jcoll.WORKER_AXIS,),
            dp_index=jax.lax.axis_index(jcoll.WORKER_AXIS), n_dp=N,
            param_dtype=jdt, params_like=plike,
        )

    jparams, jnew = jcoll.vmap_workers(worker, in_axes=({"master": 0, "base": base_axes}, None))(
        jstate, {k: jnp.asarray(v) for k, v in ghat.items()})

    # ---- port: all n rows at once
    tlike = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
             for k, v in plike.items()}
    new_params, new = zero1.zero1_update(
        to, state, _t(ghat), torch.tensor(eta), n_dp=N, param_dtype=tdt, params_like=tlike)

    for k, shape in SHAPES.items():
        jmaster = np.asarray(jnew["master"][k])[:, 0]
        if opt == "adamw":
            np.testing.assert_allclose(new["master"][k].numpy(), jmaster, rtol=1e-6, atol=1e-9)
        else:
            np.testing.assert_array_equal(new["master"][k].numpy(), jmaster)
        # the gather: the rows in worker order, cut to the leaf, in param_dtype
        size = int(np.prod(shape))
        assert new_params[k].dtype == tdt and new_params[k].shape == shape
        assert torch.equal(new_params[k], new["master"][k].reshape(-1)[:size].to(tdt).reshape(shape))
        jwant = np.asarray(jnp.asarray(jmaster).reshape(-1)[:size].astype(jdt)
                           .astype(jnp.float32)).reshape(shape)
        for w in range(N):  # every worker gathered the same params
            np.testing.assert_array_equal(np.asarray(jparams[k][w].astype(jnp.float32)), jwant)
        if opt != "adamw":
            np.testing.assert_array_equal(new_params[k].to(torch.float32).numpy(), jwant)
    if opt == "adamw":
        for name in ("mu", "nu"):
            for k in SHAPES:
                np.testing.assert_array_equal(new["base"][name][k].numpy(),
                                              np.asarray(jnew["base"][name][k])[:, 0])
        assert new["base"]["count"].dtype == torch.int32
        assert int(new["base"]["count"]) == 3 == int(np.asarray(jnew["base"]["count"])[0])
    else:
        for k in SHAPES:
            np.testing.assert_array_equal(new["base"][k].numpy(), np.asarray(jnew["base"][k])[:, 0])


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_zero1_update_consuming_the_grads_is_the_same_update(param_dtype):
    rng = np.random.default_rng(7)
    to = OPTS["adamw"][1]()
    params, ghat = _tree(rng, 0.02), _tree(rng, 1e-2)
    like = {k: v.to(param_dtype) for k, v in _t(params).items()}
    want_p, want = zero1.zero1_update(
        to, zero1.zero1_init(to, _t(params), N), _t(ghat), torch.tensor(3e-4), n_dp=N,
        param_dtype=param_dtype, params_like=like)
    consumed = _t(ghat)
    got_p, got = zero1.zero1_update(
        to, zero1.zero1_init(to, _t(params), N), consumed, torch.tensor(3e-4), n_dp=N,
        param_dtype=param_dtype, params_like=like, consume_grads=True)
    assert consumed == {}  # every leaf handed over
    for k in SHAPES:
        assert torch.equal(got_p[k], want_p[k])
        assert torch.equal(got["master"][k], want["master"][k])
        for name in ("mu", "nu"):
            assert torch.equal(got["base"][name][k], want["base"][name][k])


def test_all_gather_rows_is_the_concat_of_the_rows():
    rows = torch.arange(12, dtype=torch.float32).reshape(N, 3)
    jrows = jcoll.vmap_workers(
        lambda r: jcoll.all_gather_concat(r[None], (jcoll.WORKER_AXIS,), N), in_axes=0)(
        jnp.asarray(rows.numpy()))
    np.testing.assert_array_equal(coll.all_gather_rows(rows).numpy(), np.asarray(jrows[0]).reshape(-1))


def test_zero1_state_from_jax_round_trips():
    from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
    from repro.launch.step import build_init_state as jbuild_init
    from repro.core.compressor import IntDIANA as JIntDIANA
    from repro.models.transformer import init_lm_params
    from repro.parallel.collectives import mesh_from_counts
    from repro_torch.launch.step import build_init_state
    from repro_torch.models.transformer import params_from_jax
    from repro_torch.utils.tree import leaf_names

    cfg = jsmoke(jget_arch("granite-8b"))
    mesh = mesh_from_counts(data=1, model=1)
    jp = init_lm_params(jax.random.PRNGKey(3), cfg, tp=1, n_shards=1, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for name, (jmake, tmake) in OPTS.items():
        for jcomp, comp in ((JIntDIANA(bits=8), make_compressor("intdiana", bits=8)),
                            (JNoCompression(), make_compressor("none"))):
            jopt, jcs = jbuild_init(cfg, mesh, compressor=jcomp, base_opt=jmake(), fused=False)(jp)
            jopt_np = jax.tree.map(np.asarray, jopt)
            opt_state, comp_state = zero1_state_from_jax(
                jopt_np, jax.tree.map(np.asarray, jcs), "cpu")
            want_opt, want_comp = build_init_state(params, n_workers=1, compressor=comp,
                                                   base_opt=tmake())
            # the port's own init state, tensor for tensor
            got_leaves = jax.tree.leaves(opt_state)
            want_leaves = jax.tree.leaves(want_opt)
            assert len(got_leaves) == len(want_leaves) == (
                len(params) * (3 if name == "adamw" else 2) + (name == "adamw"))
            for g, w in zip(got_leaves, want_leaves):
                assert g.dtype == w.dtype and torch.equal(g, w)
            # and back: every array unchanged, in JAX's leaf order
            masters = jax.tree.leaves(jopt_np["master"])
            names = leaf_names(opt_state["master"])
            for k, m in zip(names, masters):
                np.testing.assert_array_equal(opt_state["master"][k].numpy(), m)
            if isinstance(comp_state, dict):
                assert set(comp_state) == set(want_comp)
    # n_dp = 4: zero1_init's global rows carried over unchanged
    rng = np.random.default_rng(7)
    small = _tree(rng, 0.02)
    jst = jax.tree.map(np.asarray, jzero1.zero1_init(
        jadamw(), {k: jnp.asarray(v) for k, v in small.items()}, N))
    st, _ = zero1_state_from_jax(jst, (), "cpu")
    ref = zero1.zero1_init(adamw(), _t(small), N)
    for k in small:
        assert torch.equal(st["master"][k], ref["master"][k])
        assert torch.equal(st["base"]["mu"][k], ref["base"]["mu"][k])
    assert st["base"]["count"].dtype == torch.int32 and int(st["base"]["count"]) == 0


@pytest.mark.parametrize("name", ["none", "allgather_sgd"])
def test_no_compression_matches_jax_n4(name):
    rng = np.random.default_rng(len(name))
    grads = {k: (rng.standard_normal((N, *s)) * 1e-2).astype(np.float32) for k, s in SHAPES.items()}
    jcomp = JNoCompression(use_allgather=name == "allgather_sgd")
    jctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))

    def worker(g):
        ghat, _, met = jcomp.aggregate((), g, key=None, eta=jnp.float32(0.1), ctx=jctx)
        return ghat, met.max_int, met.bits_per_coord

    jghat, jmax, jbits = jcoll.vmap_workers(worker, in_axes=0)(
        {k: jnp.asarray(v) for k, v in grads.items()})
    comp = make_compressor(name)
    assert isinstance(comp, NoCompression) and not comp.fused_capable
    ghat, st, met = comp.aggregate(
        (), ({k: torch.from_numpy(v[w]) for k, v in grads.items()} for w in range(N)),
        seeds=None, eta=torch.tensor(0.1), ctx=CommCtx(n_workers=N))
    assert st == ()
    for k in SHAPES:
        assert ghat[k].dtype == torch.float32 and ghat[k].shape == SHAPES[k]
        np.testing.assert_allclose(ghat[k].numpy(), np.asarray(jghat[k][0]), rtol=1e-6, atol=1e-9)
    assert float(met.max_int) == float(jmax[0]) == 0.0
    assert float(met.bits_per_coord) == float(jbits[0]) == 32.0
    d = sum(int(np.prod(s)) for s in SHAPES.values())
    assert met.payload_bytes == 4.0 * d * (N if name == "allgather_sgd" else 1)
    assert met.alphas == {}


def test_all_gather_stacks_the_workers():
    trees = [{"w": torch.full((2, 3), float(w))} for w in range(N)]
    out = CommCtx(n_workers=N).all_gather(iter(trees))
    assert out["w"].shape == (N, 2, 3) and [float(v[0, 0]) for v in out["w"]] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="all_gather over 3 workers"):
        CommCtx(n_workers=N).all_gather(trees[:3])
