"""Port vs JAX: the train step with tensor parallelism (TP) on a data ×
model grid. The JAX side is ``build_train_step`` on its ``("data",
"model")`` mesh (forced 4 CPU devices, every corner in one subprocess);
the port's is ``build_train_step(grid=...)`` on gloo ranks
(``launch.mesh.make_debug_mesh``), each rank given its shard of JAX's
global state (``params_from_jax``, ``opt_state_from_jax``,
``zero1_state_from_jax`` and ``comp_state_from_jax`` with a
``TpShard``), and its shards gathered back (``gather_shards``).

Corners (smoke widths, float32 params, global batch 4, seq 32, clip 1.0,
the train loop's warmup schedule, the encode's counter PRNG):

  * granite 2 × 2, 2 layers, fused SGD (0.9) IntSGD packed8: the exact
    step and two compressed steps;
  * granite 2 × 2, ZeRO-1 AdamW IntSGD dense8;
  * granite 1 × 2: fused AdamW IntDIANA dense8; fused SGD blockwise α
    packed8; ZeRO-1 SGD Heuristic IntSGD packed8 (its max through the
    model group too);
  * deepseek 2 × 2 (``moe_ep``: two experts a rank and an all-to-all each
    way; MLA on two heads a rank; the shared expert), ZeRO-1 AdamW packed8;
  * mixtral with 6 experts on 1 × 4 (``moe_tp`` at tp > 1, each expert's
    d_ff split; the KV heads padded from 2 to 4), fused SGD packed8.

As in ``tests/test_torch_slice_dense.py`` and ``test_torch_slice_moe.py``,
the two packages' bf16 forwards round differently, so each step is checked
twice. (1) Each rank's own loss and gradients at JAX's params are held to
the JAX device's: loss rtol 2e-2, gradients within 3e-2 relative L2 over
the rank's leaves (the ×tp factor of JAX's ``psum`` transpose included);
for the moe corners at step 0 only: after one update a top-2 choice of the
mixtral corner sits so near a tie that the port's own bf16 and float32
gradients differ by 6.6 % at step 1 (``tests/test_torch_tp.py`` holds the
MoE blocks at tp > 1 in float32 at 1e-5). (2) JAX's gradients, taken on
each device inside its jitted step, are handed to the port's step in place
of its own, from JAX's state before the step: max_int is then bit-equal, α
within rtol 1e-6, the gathered params and IntDIANA's gathered global shift
within rtol = atol = 2e-6, α's r within rtol 5e-5 (||Δx||² of an update
near 1e-4 taken from params that agree to 2e-6, summed over the model
group in another order), the loss within rtol 1e-6; the dp replicas of
each shard end bit-identical. Where JAX's jitted step computes α one float32
ULP away from the same formula run eagerly, which the port's α equals
(the granite corner's step 2: 5395.1387 jitted, 5395.1392 eager and in
the port), a stochastic rounding can cross its threshold: at most
``MAX_FLIPS`` coordinates a step may then differ, each by at most that
step's learning rate.

The reference's factor: from the same global params and batch, the exact
SGD update (momentum 0, lr 1, no clip) on 1 × 2 over the one on 1 × 1 is 2
within 1e-2 for every leaf, in both packages.

Every compressor of the JAX package's TP step builds at tp = 2 (the
paper's baselines and IntSGD on a gather wire are held to JAX's step in
``tests/test_torch_tp_baselines.py`` and
``tests/test_torch_tp_baselines_reduce.py``); the one refusal left is
PowerSGD where the reference fails to build, which this file's JAX
subprocess pins on the reference's side.
"""
import dataclasses
import math
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.launch.step as tstep  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.step import build_train_step  # noqa: E402
from repro_torch.models.common import gather_shards  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    comp_state_from_jax, opt_state_from_jax, params_from_jax, zero1_state_from_jax,
)
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.optim.schedules import constant, warmup_wrap  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402

SEQ, BATCH = 32, 4
MAX_FLIPS = 4
# name: (arch, layers, n_dp, tp, fused, optimizer, compressor, wire, steps, extra)
CORNERS = {
    "granite-2x2-fused-sgd-packed8": ("granite-8b", 2, 2, 2, True, "sgd", "intsgd", "packed8",
                                      3, {}),
    "granite-2x2-zero1-adamw-dense8": ("granite-8b", 1, 2, 2, False, "adamw", "intsgd",
                                       "dense8", 2, {}),
    "granite-1x2-fused-adamw-intdiana": ("granite-8b", 1, 1, 2, True, "adamw", "intdiana",
                                         "dense8", 2, {}),
    "granite-1x2-fused-sgd-block": ("granite-8b", 1, 1, 2, True, "sgd", "intsgd_block",
                                    "packed8", 2, {}),
    "granite-1x2-zero1-heuristic": ("granite-8b", 1, 1, 2, False, "sgd", "heuristic_intsgd",
                                    "packed8", 2, {}),
    "deepseek-2x2-zero1-adamw-packed8": ("deepseek-v2-lite-16b", 1, 2, 2, False, "adamw",
                                         "intsgd", "packed8", 2, {}),
    "mixtral6-1x4-fused-sgd-packed8": ("mixtral-8x22b", 1, 1, 4, True, "sgd", "intsgd",
                                       "packed8", 2, {"n_experts": 6}),
}
# the factor: exact SGD step (momentum 0, lr 1, no clip) at 1 x 2 and 1 x 1
FACTOR = ("granite-8b", 1)

_JAX = """
import dataclasses, pickle, types
import jax, jax.numpy as jnp, numpy as np
from jax import lax
import repro.launch.step as jstep
from repro.configs import ShapeConfig, get_arch, smoke_config
from repro.core.compressor import HeuristicIntSGD, IntDIANA, IntSGD, _leaf_keys
from repro.core.scaling import AlphaBlockwise, AlphaState
from repro.kernels import ops
from repro.models.transformer import init_lm_params
from repro.optim import adamw, sgd
from repro.optim.schedules import constant, warmup_wrap
from repro.wire import DenseInt, PackedInt

corners, factor, batches, path = pickle.load(open({inp!r}, "rb"))

def flat(tree):
    return {{"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}

def plain(x):
    if isinstance(x, AlphaState):
        return types.SimpleNamespace(r=plain(x.r), step=plain(x.step))
    if isinstance(x, dict):
        return {{k: plain(v) for k, v in x.items()}}
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    return np.asarray(x)

grads, alphas = {{}}, {{}}
fb = jstep._forward_backward

def spy_fb(layout, loss_fn, params, batch):
    loss, g = fb(layout, loss_fn, params, batch)
    jax.debug.callback(lambda l, t, d, m: grads.__setitem__((int(d), int(m)), (float(l), flat(t))),
                       loss, g, lax.axis_index("data"), lax.axis_index("model"))
    return loss, g

jstep._forward_backward = spy_fb
for cls in (IntSGD, IntDIANA):
    def spy_enc(self, *a, _enc=cls.encode_ints, **kw):
        ints, al = _enc(self, *a, **kw)
        jax.debug.callback(lambda t, d, m: alphas.__setitem__((int(d), int(m)), flat(t)), al,
                           lax.axis_index("data"), lax.axis_index("model"))
        return ints, al
    cls.encode_ints = spy_enc

def compressor(name, wire):
    w = {{"packed8": PackedInt, "dense8": DenseInt}}[wire](8, use_kernels=True)
    if name == "intsgd":
        return IntSGD(bits=8, wire=w, use_kernels=True)
    if name == "intsgd_block":
        return IntSGD(bits=8, wire=w, use_kernels=True, alpha_rule=AlphaBlockwise())
    if name == "intdiana":
        return IntDIANA(bits=8, wire=w)
    return HeuristicIntSGD(bits=8, wire=w)

def jbatch(b):
    return {{"tokens": jnp.asarray(b[0], jnp.int32), "labels": jnp.asarray(b[1], jnp.int32)}}

out = {{}}
for name, (arch, layers, n_dp, tp, fused, opt, comp, wire, steps, extra) in corners.items():
    cfg = dataclasses.replace(smoke_config(get_arch(arch)), n_layers=layers, **extra)
    mesh = jax.make_mesh((n_dp, tp), ("data", "model"))
    jc = compressor(comp, wire)
    jo = sgd(momentum=0.9, weight_decay=1e-4) if opt == "sgd" else adamw(weight_decay=1e-4)
    lr = 0.3 if opt == "sgd" else 3e-4
    art = jstep.build_train_step(cfg, mesh, ShapeConfig("tp", {seq}, {batch}, "train"),
                                 compressor=jc, base_opt=jo, lr_schedule=warmup_wrap(constant(lr), 5),
                                 param_dtype=jnp.float32, fused=fused, clip_norm=1.0, donate=False)
    key = jax.random.PRNGKey(0)
    params = init_lm_params(key, cfg, tp=tp, n_shards=1, dtype=jnp.float32)
    host0 = jax.tree.map(np.asarray, params)
    params = jax.device_put(params, art.in_shardings[0])
    opt_state, comp_state = jstep.build_init_state(cfg, mesh, compressor=jc, base_opt=jo,
                                                   fused=fused)(params)
    recs = []
    for i in range(steps):
        before = plain((params, opt_state, comp_state))
        k = jax.random.fold_in(key, i)
        akey = jax.random.fold_in(k, 1)
        seeds = [[int(ops.seed_from_key(s)) for s in
                  jax.tree.leaves(_leaf_keys(jax.random.fold_in(akey, w), host0))]
                 for w in range(n_dp)]
        grads.clear(); alphas.clear()
        fn = art.jitted["exact"] if i == 0 else art.jitted["compressed"]
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, jnp.int32(i), k, jbatch(batches[i]))
        jax.effects_barrier()
        recs.append(dict(before=before, seeds=seeds, grads=dict(grads), alphas=dict(alphas),
                         loss=float(loss), max_int=float(metrics[0]),
                         params=flat(params), comp=plain(comp_state)))
    out[name] = recs

arch, layers = factor
cfg = dataclasses.replace(smoke_config(get_arch(arch)), n_layers=layers)
params0 = init_lm_params(jax.random.PRNGKey(1), cfg, tp=2, n_shards=1, dtype=jnp.float32)
updates = {{}}
for tp in (1, 2):
    mesh = jax.make_mesh((1, tp), ("data", "model"))
    jc, jo = IntSGD(bits=8, wire=PackedInt(8, use_kernels=True), use_kernels=True), sgd()
    art = jstep.build_train_step(cfg, mesh, ShapeConfig("tp", {seq}, {batch}, "train"),
                                 compressor=jc, base_opt=jo, lr_schedule=constant(1.0),
                                 param_dtype=jnp.float32, fused=False, clip_norm=None,
                                 donate=False)
    p = jax.device_put(params0, art.in_shardings[0])
    o, c = jstep.build_init_state(cfg, mesh, compressor=jc, base_opt=jo, fused=False)(p)
    new = art.jitted["exact"](p, o, c, jnp.int32(0), jax.random.PRNGKey(0), jbatch(batches[0]))[0]
    updates[tp] = {{k: v - w for (k, v), w in zip(flat(new).items(), flat(params0).values())}}
out["factor"] = dict(params0=flat(params0),
                     ratio={{k: float(np.linalg.norm(updates[2][k]) / np.linalg.norm(updates[1][k]))
                            for k in updates[1]}})
# PowerSGD at its default min_compress_size on granite smoke at 2 layers, 2 x 2:
# the reference fails to build (a leaf that is a matrix globally but not on its
# shard: _comp_state_shapes maps its global Q against the shard's None)
from repro.core.compressor import PowerSGD
try:
    jstep.build_train_step(dataclasses.replace(smoke_config(get_arch("granite-8b")), n_layers=2),
                           jax.make_mesh((2, 2), ("data", "model")),
                           ShapeConfig("tp", {seq}, {batch}, "train"), compressor=PowerSGD(),
                           base_opt=sgd(momentum=0.9), lr_schedule=constant(0.1),
                           param_dtype=jnp.float32, donate=False)
    out["powersgd_build"] = None
except Exception as e:
    out["powersgd_build"] = type(e).__name__
pickle.dump(out, open(path, "wb"))
print("JAX_SLICE_TP_OK")
"""


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):
        toks = rng.integers(0, 256, (BATCH, SEQ))
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        out.append((toks, labels))
    return out


def _cfg(arch, layers, extra):
    return dataclasses.replace(smoke_config(get_arch(arch)), n_layers=layers, **extra)


def _compressor(name, wire):
    if name == "intsgd":
        return make_compressor({"packed8": "intsgd8_packed", "dense8": "intsgd8"}[wire])
    if name == "heuristic_intsgd":
        return make_compressor(name, wire=wire)
    return make_compressor(name, bits=8, wire=wire)


def _tbatch(b):
    return {"tokens": torch.from_numpy(b[0]), "labels": torch.from_numpy(b[1])}


def _rel_l2(got, want):
    num = sum(float(torch.sum((got[k].double() - torch.from_numpy(want[k]).double()) ** 2))
              for k in got)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in got)
    return (num / den) ** 0.5


def _corner_rank(grid, name, recs, batches):
    """One rank of one corner: per step, its own forward at JAX's params,
    then the step with JAX's gradients handed in, from JAX's state."""
    arch, layers, n_dp, tp, fused, opt, comp, wire, steps, extra = CORNERS[name]
    cfg = _cfg(arch, layers, extra)
    shard = specs.tp_shard(cfg, tp, grid.tp_index)
    base_opt = sgd(momentum=0.9, weight_decay=1e-4) if opt == "sgd" else adamw(weight_decay=1e-4)
    lr = 0.3 if opt == "sgd" else 3e-4
    compressor = _compressor(comp, wire)
    art = build_train_step(
        cfg, ShapeConfig("tp", SEQ, BATCH, "train"), n_workers=n_dp, compressor=compressor,
        base_opt=base_opt, lr_schedule=warmup_wrap(constant(lr), 5), param_dtype=torch.float32,
        fused=fused, clip_norm=1.0, device="cpu", grid=grid)
    me = (grid.dp_index, grid.tp_index)
    fb = tstep._forward_backward
    out = []
    for i, rec in enumerate(recs):
        p0, o0, c0 = rec["before"]
        params = params_from_jax(p0, "cpu", shard=shard)
        if fused:
            opt_state = opt_state_from_jax(o0, "cpu", shard=shard)
            comp_state = comp_state_from_jax(c0, "cpu", rank=grid.dp_index, shard=shard)
        else:
            opt_state, comp_state = zero1_state_from_jax(o0, c0, "cpu", rank=grid.dp_index,
                                                         shard=shard)
        batch = _tbatch(batches[i])
        jloss, jgrads = rec["grads"][me]
        own_loss, own = fb(art.layout, params, tstep._microbatch(batch, grid.dp_index, n_dp))
        assert set(own) == set(jgrads) and all(own[k].shape == jgrads[k].shape for k in own)
        handed = {k: torch.from_numpy(jgrads[k]) for k in own}
        tstep._forward_backward = lambda layout, p, b: (torch.tensor(jloss), dict(handed))
        try:
            fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
            seeds = torch.tensor(rec["seeds"], dtype=torch.int32)
            params, opt_state, comp_state, loss, metrics = fn(
                params, opt_state, comp_state, i, batch, seeds)
        finally:
            tstep._forward_backward = fb
        out.append(dict(own_loss=float(own_loss), jloss=jloss, grad_err=_rel_l2(own, jgrads),
                        leaf_err={k: _rel_l2({k: own[k]}, jgrads) for k in own},
                        loss=float(loss), max_int=float(metrics[0]),
                        alphas={k: float(v) for k, v in metrics[2].items()},
                        params=params, comp=comp_state))
    return out


def _ranks(group, rank, names, ref, batches):
    out = {}
    for name in names:
        _, _, n_dp, tp, *_ = CORNERS[name]
        grid = make_debug_mesh(n_dp, tp)
        out[name] = _corner_rank(grid, name, ref[name], batches)
    if "factor" in ref:
        out["factor"] = _factor_rank(make_debug_mesh(1, 2), ref["factor"]["params0"], batches[0])
    return out


def _exact_update(params0, batch, grid=None):
    arch, layers = FACTOR
    cfg = _cfg(arch, layers, {})
    art = build_train_step(
        cfg, ShapeConfig("tp", SEQ, BATCH, "train"), n_workers=1,
        compressor=make_compressor("intsgd8_packed"), base_opt=sgd(),
        lr_schedule=constant(1.0), param_dtype=torch.float32, clip_norm=None, device="cpu",
        grid=grid)
    shard = None if grid is None else specs.tp_shard(cfg, grid.tp, grid.tp_index)
    params = params_from_jax(params0, "cpu", shard=shard)
    from repro_torch.launch.step import build_init_state

    opt_state, comp_state = build_init_state(
        params, n_workers=1, compressor=make_compressor("intsgd8_packed"), base_opt=sgd(),
        grid=grid)
    new = art.steps["exact"](params, opt_state, comp_state, 0, _tbatch(batch))[0]
    return {k: new[k] - params[k] for k in params}


def _factor_rank(grid, params0, batch):
    return _exact_update(params0, batch, grid)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from conftest import run_forced_mesh

    tmp = tmp_path_factory.mktemp("slice_tp")
    batches = _batches()
    inp, outp = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as fh:
        pickle.dump((CORNERS, FACTOR, batches, outp), fh)
    out = run_forced_mesh(_JAX.format(inp=inp, seq=SEQ, batch=BATCH), timeout=600)
    assert "JAX_SLICE_TP_OK" in out
    with open(outp, "rb") as fh:
        ref = pickle.load(fh)
    four = [n for n in CORNERS if CORNERS[n][2] * CORNERS[n][3] == 4]
    two = [n for n in CORNERS if CORNERS[n][2] * CORNERS[n][3] == 2]
    ranks4 = run_ranks(_ranks, 4, args=(four, {n: ref[n] for n in four}, batches))
    ranks2 = run_ranks(_ranks, 2, args=(two, dict({n: ref[n] for n in two},
                                                  factor=ref["factor"]), batches))
    return ref, {n: ranks4 if n in four else ranks2 for n in CORNERS}, ranks2, batches


@pytest.mark.parametrize("name", list(CORNERS))
def test_tp_step_matches_jax(runs, name):
    ref, ranks_of, _, _ = runs
    arch, layers, n_dp, tp, fused, opt, comp, wire, steps, extra = CORNERS[name]
    cfg = _cfg(arch, layers, extra)
    spec = specs.infer_param_specs(cfg, tp)[2]
    ranks = [r[name] for r in ranks_of[name]]
    lim = n_dp * 127 // n_dp  # packed8/dense8: the n_dp-worker sum's clip
    for i, want in enumerate(ref[name]):
        where = f"{name} step {i}"
        got = [r[i] for r in ranks]
        for rank, g in enumerate(got):
            np.testing.assert_allclose(g["own_loss"], g["jloss"], rtol=2e-2, err_msg=where)
            if i == 0 or cfg.family != "moe":
                assert g["grad_err"] < 3e-2, (where, rank, g["grad_err"], g["leaf_err"])
            np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-6, err_msg=where)
            assert g["max_int"] == want["max_int"], (where, rank, g["max_int"], want["max_int"])
        if i == 0:
            assert want["max_int"] == 0
        else:
            assert 0 < want["max_int"] <= lim
        # α: every rank the same, each leaf JAX's (the encode's α)
        if want["alphas"]:
            jal = want["alphas"][(0, 0)]
            for g in got:
                assert set(g["alphas"]) == set(jal)
                for k, v in g["alphas"].items():
                    np.testing.assert_allclose(v, jal[k], rtol=1e-6, err_msg=f"{where} {k}")
        # the dp replicas of each model shard are bit-identical
        for rank in range(tp, n_dp * tp):
            a, b = got[rank]["params"], got[rank % tp]["params"]
            assert all(torch.equal(a[k], b[k]) for k in a), (where, rank)
        full = gather_shards([g["params"] for g in got[:tp]], spec)
        assert set(full) == set(want["params"])
        exact_alpha = not want["alphas"] or all(
            np.float32(v) == want["alphas"][(0, 0)][k] for k, v in got[0]["alphas"].items())
        flips = 0
        for k, p in full.items():
            diff = np.abs(p.numpy() - want["params"][k])
            off = diff > 2e-6 + 2e-6 * np.abs(want["params"][k])
            flips += int(off.sum())
            if exact_alpha:
                assert not off.any(), (where, k, float(diff.max()))
            assert float(diff.max()) <= (0.3 if opt == "sgd" else 3e-4), (where, k)
        assert flips <= MAX_FLIPS, (where, flips)
        jcomp, tcomp = want["comp"], got[0]["comp"]
        if comp == "intdiana":
            h = gather_shards([g["comp"]["h_global"] for g in got[:tp]], spec)
            jh = params_from_jax(jcomp["h_global"], "cpu")
            for k, v in h.items():
                np.testing.assert_allclose(v.numpy(), jh[k][0].numpy(), rtol=2e-6, atol=2e-6,
                                           err_msg=f"{where} h_global {k}")
            jcomp, tcomp = jcomp["alpha"], tcomp["alpha"]
        if comp != "heuristic_intsgd":
            jr = jcomp.r
            if isinstance(tcomp.r, dict):
                jr = params_from_jax(jr, "cpu")
                for k, v in tcomp.r.items():
                    np.testing.assert_allclose(float(v), float(jr[k][0]), rtol=5e-5,
                                               err_msg=f"{where} r {k}")
            else:
                np.testing.assert_allclose(float(tcomp.r), float(np.asarray(jr)[0]), rtol=5e-5,
                                           err_msg=f"{where} r")
            assert int(tcomp.step) == int(np.asarray(jcomp.step)[0])


def test_reference_gradient_is_tp_times_the_single_device_one(runs):
    ref, _, ranks2, batches = runs
    ratio = ref["factor"]["ratio"]
    assert len(ratio) == 12
    for k, v in ratio.items():  # the JAX package
        assert abs(v - 2.0) < 1e-2, (k, v)
    arch, layers = FACTOR
    spec = specs.infer_param_specs(_cfg(arch, layers, {}), 2)[2]
    tp2 = gather_shards([r["factor"] for r in ranks2], spec)
    tp1 = _exact_update(ref["factor"]["params0"], batches[0])
    for k, u in tp1.items():  # the port, the same factor
        got = float(torch.linalg.vector_norm(tp2[k]) / torch.linalg.vector_norm(u))
        assert abs(got - 2.0) < 1e-2, (k, got)
        assert abs(got - ratio[k]) < 1e-2, (k, got, ratio[k])


def test_baselines_refuse_tp(runs):
    """What stays refused at tp > 1 (ROADMAP item 12.6d): PowerSGD where
    the JAX package's TP step fails to build, a leaf that is a matrix of
    at least ``min_compress_size`` elements globally but not on its shard
    (granite smoke at 2 layers and the default 4,096: ``layers/attn/wk``
    has 4,096 elements globally and 2,048 on a shard). The port raises
    ``NotImplementedError`` naming the leaf, its sizes and the option; the
    reference raises an ``AttributeError`` in ``_comp_state_shapes``
    (pinned in this file's JAX subprocess). The hybrid family builds at
    tp = 2 (its leaves sharded by head)."""
    from repro_torch.launch.mesh import Grid

    ref = runs[0]
    assert ref["powersgd_build"] == "AttributeError"
    grid = Grid(n_dp=1, tp=2, dp_index=0, tp_index=0, data_group=None, model_group=None)
    kw = dict(n_workers=1, base_opt=sgd(), lr_schedule=constant(0.1), device="cpu", grid=grid)
    shape = ShapeConfig("tp", SEQ, BATCH, "train")
    with pytest.raises(NotImplementedError,
                       match=r"'layers/attn/wk' .* 4096 elements globally but of 2048 .* "
                             r"min_compress_size = 4096"):
        build_train_step(_cfg("granite-8b", 2, {}), shape, compressor=make_compressor(
            "powersgd"), **kw)
    # at 4 layers every leaf is a matrix on its shard too, and it builds
    build_train_step(_cfg("granite-8b", 4, {}), shape, compressor=make_compressor("powersgd"),
                     **kw)
    art = build_train_step(_cfg("zamba2-2.7b", 4, {}), shape,
                           compressor=make_compressor("intsgd8_packed"), **kw)
    assert art.layout.tp == 2 and "layers/m/w_xz" not in art.layout.rep
    assert {"layers/m/w_bc", "shared_attn/w_in"} <= art.layout.rep


# every compressor the JAX package's TP step runs, by make_compressor name
# and arguments (the steps themselves: tests/test_torch_tp_baselines.py and
# tests/test_torch_tp_baselines_reduce.py)
TP_BUILDS = {
    "none": ("none", {}), "allgather_sgd": ("allgather_sgd", {}), "qsgd": ("qsgd", {}),
    "qsgd-packed8": ("qsgd", {"wire": "packed8"}), "natsgd": ("natsgd", {}),
    "powersgd-256": ("powersgd", {"min_compress_size": 256}), "signsgd": ("signsgd", {}),
    "topk": ("topk", {}), "intsgd-topk8": ("intsgd", {"bits": 8, "wire": "topk8:16"}),
    "intsgd-topk16": ("intsgd", {"bits": 16, "wire": "topk16:16"}),
}


@pytest.mark.parametrize("name", list(TP_BUILDS))
def test_every_baseline_builds_at_tp_2(name):
    """Each compressor builds on granite smoke at 2 layers on a 1 × 2 grid
    and inits its state on the rank's shard: the error-feedback trees
    param-shaped per local leaf, PowerSGD's Q (cols, rank) of the shard."""
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.step import build_init_state

    comp_name, extra = TP_BUILDS[name]
    grid = Grid(n_dp=1, tp=2, dp_index=0, tp_index=0, data_group=None, model_group=None)
    cfg = _cfg("granite-8b", 2, {})
    comp = make_compressor(comp_name, **extra)
    art = build_train_step(cfg, ShapeConfig("tp", SEQ, BATCH, "train"), n_workers=1,
                           compressor=comp, base_opt=sgd(), lr_schedule=constant(0.1),
                           device="cpu", grid=grid)
    assert art.layout.tp == 2
    local = specs.infer_param_specs(cfg, 2)[1]
    params = {k: torch.zeros(s) for k, s in local.items()}
    _, state = build_init_state(params, n_workers=1, compressor=comp, base_opt=sgd(),
                                grid=grid)
    ef = {"topk": state, "signsgd": state, "powersgd": state.get("err") if state else None,
          "intsgd": state.get("ef") if isinstance(state, dict) else None}.get(comp_name)
    if ef is not None:
        assert {k: tuple(v.shape[1:]) for k, v in ef.items()} == local
    if comp_name == "powersgd":
        assert {k: tuple(q.shape) for k, q in state["q"].items()} == {
            k: (math.prod(s) // s[0], 2) for k, s in local.items() if comp.compresses(s)}


def test_checkpoint_refuses_tp(tmp_path):
    """Checkpoints at tp > 1: what a store refuses (a grid store without the
    model specs; a train loop on a grid handed a store made off it), and the
    CLI's --ckpt-dir and --resume under torchrun on a 1 × 2 grid, which
    saves every 20 steps: the checkpoint holds the global layout, and the
    resumed step 20 is the uninterrupted run's."""
    import json
    import os
    import re
    import subprocess
    import sys

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.train import train_loop

    grid = Grid(n_dp=1, tp=2, dp_index=0, tp_index=0, data_group=None, model_group=None)
    with pytest.raises(ValueError, match="specs"):
        CheckpointStore(str(tmp_path), grid=grid)
    with pytest.raises(ValueError, match="same grid"):
        train_loop(_cfg("granite-8b", 1, {}), ShapeConfig("tp", SEQ, BATCH, "train"), steps=1,
                   device="cpu", grid=grid, ckpt=CheckpointStore(str(tmp_path)), resume=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1")
    ck = str(tmp_path / "ck")

    def cli(*extra):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch",
               "granite-8b", "--smoke", "--data", "1", "--model", "2", "--steps", "21",
               "--batch", str(BATCH), "--seq", str(SEQ), "--device", "cpu", "--fused",
               "--compressor", "intsgd8_packed", "--wire", "packed8", "--ckpt-dir", ck,
               *extra]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=repo)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout

    first = cli()
    meta = json.load(open(os.path.join(ck, "step_0000000020", "manifest.json")))["arrays"]
    assert meta["params/embed"]["shape"] == [256, 64]  # whole over the model axis
    assert meta["opt/mom/layers/attn/wq"]["shape"] == [4, 64, 64]
    assert meta["comp/.r"]["shape"] == [1]  # one copy a data replica
    second = cli("--resume")
    assert "[train] resumed from step 20" in second
    step20 = re.compile(r"\[train\] step +20 loss \S+")
    assert step20.search(first).group(0) == step20.search(second).group(0)


def test_recurrent_and_encdec_decode_refuse_tp(monkeypatch):
    """The hybrid, ssm and encdec families' cache, decode step and serve
    step build and run at tp = 2 (ROADMAP item 12.6e) with the shapes the
    JAX package declares (``cache_shapes`` of the rank's and of the global
    cache). One process:
    the model group's sum and max are stood in by identities, so only the
    shapes are checked here; ``tests/test_torch_tp_serve_recurrent.py``
    holds the values on four ranks."""
    import jax
    from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
    from repro.launch import specs as jspecs

    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.step import build_serve_step
    from repro_torch.models import encdec
    from repro_torch.models.decode import lm_decode_step
    from repro_torch.models.transformer import init_lm_params, resolve_dims
    from repro_torch.parallel import collectives as coll

    monkeypatch.setattr(coll, "psum_tp", lambda x, group: x)
    monkeypatch.setattr(coll, "pmax_tp", lambda x, group: x)

    def jax_shapes(jcfg, n_shards, b, s):
        tree = jspecs.cache_shapes(jcfg, 2, n_shards, b, s, s_src=s)
        return {"/".join(p.key for p in path): tuple(v.shape)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    grid = Grid(n_dp=1, tp=2, dp_index=0, tp_index=0, data_group=None, model_group=None)
    b, s = 2, 16
    shape = ShapeConfig("tp", s, b, "decode")
    for arch in ("zamba2-2.7b", "xlstm-125m", "seamless-m4t-medium"):
        cfg, jcfg = smoke_config(get_arch(arch)), jsmoke(jget_arch(arch))
        enc = cfg.family == "encdec"
        assert specs.cache_shapes(cfg, 2, 1, b, s) == jax_shapes(jcfg, 1, b, s), arch
        art = build_serve_step(cfg, grid, shape, device="cpu")
        cache = art.init_cache()
        local = {k: tuple(v.shape) for k, v in cache.items()}
        assert art.cache_shapes == local == jax_shapes(jcfg, 2, b, s), arch
        init = encdec.init_encdec_params if enc else init_lm_params
        params = specs.tp_shard(cfg, 2, 0).tree(init(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu", tp=2))
        tokens, pos = torch.arange(b), torch.zeros(b, dtype=torch.long)
        if enc:
            frames = torch.randn(b, s, cfg.frontend_dim, generator=torch.Generator().manual_seed(1))
            cache = encdec.encdec_prefill(params, frames, cache, cfg, axes=art.axes)
            logits, cache = encdec.encdec_decode_step(params, cache, tokens, pos, cfg,
                                                      axes=art.axes)
        else:
            logits, cache = lm_decode_step(params, cache, tokens, pos, cfg, axes=art.axes)
        assert logits.shape == (b, resolve_dims(cfg, 2, 2).vocab_loc), arch
        nxt, cache = art.steps["decode"](params, cache, tokens, pos + 1)
        assert nxt.shape == (b,) and torch.isfinite(logits).all(), arch
        assert {k: tuple(v.shape) for k, v in cache.items()} == local, arch