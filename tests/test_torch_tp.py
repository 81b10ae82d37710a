"""Port vs JAX: the tensor-parallel (TP) primitives over a model axis.

1. From shapes only, for every attention-family config at tp in {1, 2, 4,
   16}: ``plan_heads``, ``resolve_dims`` (global and local), the leaf
   shapes and ``infer_param_specs`` (which dimension each leaf shards), and
   ``global_tree_dims`` (α's d; each leaf's d_l where the JAX package's
   int32 product does not overflow: past 2^31 elements it wraps, the
   port's count is exact).
2. ``embed_lookup`` and ``tp_cross_entropy`` on 2 and 4 ranks, and a
   column- then row-parallel MLP on 2, values and gradients, against the
   same functions inside the JAX package's ``shard_map`` (``check_vma``
   off, as its step runs them) on a forced 4-device mesh, in one
   subprocess. The vocabulary is 256 and 255, which pads to 256: the
   padded logit columns enter the exp-sum in both packages. Each rank's
   gradients, the ×tp factor of the ``psum`` transpose included, are held
   to the JAX device's at rtol = atol = 1e-5, the values at 1e-6 (float32;
   the matmuls and sums run in another order).
3. The CLI under ``torch.distributed.run`` on a 2 × 2 grid (granite) and a
   1 × 2 grid (deepseek: ``moe_ep`` and MLA): it runs, rank 0 alone
   prints, and the loss falls.
4. The blocks with a model axis inside, float32 end to end, values and
   gradients against JAX's the same way: the MoE block at (E = 4, tp = 2),
   which picks ``moe_ep`` (two experts a rank, the token slices exchanged
   by all-to-all, a shared expert), and at (E = 6, tp = 4), which picks
   ``moe_tp`` at tp > 1 (each expert's d_ff split); MLA on two heads a
   rank.
5. ``all_to_all_tp``'s values and its gradient (the inverse exchange), and
   the refusals: a model-axis collective without a model group, a model
   group on the local backend, a grid that does not fit the world.

The port's side runs on gloo ranks spawned by
``repro_torch.parallel.spawn.run_ranks`` (one 4-rank spawn: a 2 × 2 grid
and a 1 × 4 grid).
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    SINGLE, Axes, col_parallel, embed_lookup, pad_to_multiple, plan_heads, row_parallel,
    swiglu, tp_cross_entropy,
)
from repro_torch.models.transformer import resolve_dims  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402

ATTENTION_ARCHS = ("deepseek-v2-lite-16b", "granite-8b", "h2o-danube-3-4b", "internvl2-2b",
                   "minitron-4b", "mixtral-8x22b", "qwen2.5-32b")
TPS = (1, 2, 4, 16)


def _flat(tree):
    import jax

    return {"/".join(p.key for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# 1. shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
@pytest.mark.parametrize("tp", TPS)
def test_dims_shapes_and_specs_match_jax(arch, tp):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_arch as jget_arch
    from repro.launch import specs as jspecs
    from repro.models.transformer import resolve_dims as jresolve

    jcfg, cfg = jget_arch(arch), get_arch(arch)
    for n_shards in (1, tp):
        jd, td = jresolve(jcfg, tp, n_shards), resolve_dims(cfg, tp, n_shards)
        assert dataclasses.asdict(jd.layout) == dataclasses.asdict(td.layout)
        for f in dataclasses.fields(td):
            if f.name != "layout":
                assert getattr(jd, f.name) == getattr(td, f.name), (f.name, n_shards)
    g, lo, ps = jspecs.infer_param_specs(jcfg, tp)
    ps = {"/".join(p.key for p in path): s for path, s in jax.tree_util.tree_flatten_with_path(
        ps, is_leaf=lambda x: isinstance(x, P))[0]}
    tg, tlo, tps = specs.infer_param_specs(cfg, tp)
    g, lo = _flat(g), _flat(lo)
    assert set(g) == set(tg) == set(tps)
    for k in g:
        assert tuple(g[k].shape) == tg[k] and tuple(lo[k].shape) == tlo[k], k
        dim = next((i for i, a in enumerate(ps[k]) if a is not None), None)
        assert dim == tps[k], (k, ps[k], tps[k])
    if tp > 1:  # what each family shards
        assert tps["embed"] == 0 and tps["layers/ln1"] is None and tps["ln_f"] is None
        assert tps.get("layers/moe/router", None) is None
    jdims, tdims = jspecs.global_tree_dims(jcfg, tp), specs.global_tree_dims(cfg, tp)
    assert jdims.d == tdims.d
    for k, v in _flat(jdims.leaf_dims).items():
        if tdims.leaf_dims[k] < 2**31:  # JAX's int32 product wraps past it
            assert v == tdims.leaf_dims[k], k
        assert tdims.leaf_dims[k] == float(np.prod(g[k].shape, dtype=np.int64))


def test_plan_heads_matches_jax_on_a_grid_of_counts():
    from repro.models.common import plan_heads as jplan

    for n_q in range(1, 13):
        for n_kv in (d for d in range(1, n_q + 1) if n_q % d == 0):
            for tp in (1, 2, 3, 4, 8):
                assert dataclasses.asdict(jplan(n_q, n_kv, 16, tp)) == dataclasses.asdict(
                    plan_heads(n_q, n_kv, 16, tp)), (n_q, n_kv, tp)
    # KV heads pad up to one per rank: mixtral's smoke 2 -> 4 at tp = 4
    assert (plan_heads(4, 2, 16, 4).n_kv, plan_heads(4, 2, 16, 4).kv_local) == (4, 1)


# ---------------------------------------------------------------------------
# 2. the primitives against JAX's shard_map
# ---------------------------------------------------------------------------

B, T, D, D_FF = 2, 8, 16, 24
CASES = [(tp, v) for tp in (2, 4) for v in (256, 255)]


def _inputs(vocab, tp):
    rng = np.random.default_rng(vocab + 7 * tp)
    v_pad = pad_to_multiple(vocab, tp)
    labels = rng.integers(0, vocab, (B, T))
    labels[0, :2] = -1
    return dict(
        table=rng.standard_normal((v_pad, D)).astype(np.float32),
        head=(rng.standard_normal((D, v_pad)) / 4).astype(np.float32),
        h=rng.standard_normal((B, T, D)).astype(np.float32),
        r=rng.standard_normal((B, T, D)).astype(np.float32),
        ids=rng.integers(0, vocab, (B, T)),
        labels=labels,
    )


def _mlp_inputs():
    rng = np.random.default_rng(3)
    return dict(x=rng.standard_normal((B, T, D)).astype(np.float32),
                w_gate=rng.standard_normal((D, D_FF)).astype(np.float32) / 4,
                w_up=rng.standard_normal((D, D_FF)).astype(np.float32) / 4,
                w_down=rng.standard_normal((D_FF, D)).astype(np.float32) / 4,
                r=rng.standard_normal((B, T, D)).astype(np.float32))


E_D, E_F, E_T = 16, 24, 16  # the blocks' d_model, expert d_ff, tokens a sequence
BLOCKS = {"moe_ep": (4, 2), "moe_tp": (6, 4), "mla": (0, 2)}  # name: (experts, tp)


def _block_inputs(name):
    rng = np.random.default_rng(len(name) + 40)
    n_exp, _ = BLOCKS[name]
    f32 = lambda *s, scale=0.25: (rng.standard_normal(s) * scale).astype(np.float32)
    x = f32(B, E_T, E_D, scale=1.0)
    if name == "mla":  # 4 heads of 8, kv_lora 12, the rotary 64
        p = {"w_dkv": f32(E_D, 12), "w_kr": f32(E_D, 64), "w_q": f32(E_D, 4 * 72),
             "w_uk": f32(12, 32), "w_uv": f32(12, 32), "wo": f32(32, E_D)}
    else:
        p = {"router": f32(E_D, n_exp, scale=1.0), "w_gate": f32(n_exp, E_D, E_F),
             "w_up": f32(n_exp, E_D, E_F), "w_down": f32(n_exp, E_F, E_D)}
        if name == "moe_ep":
            p.update({"shared/w_gate": f32(E_D, E_F), "shared/w_up": f32(E_D, E_F),
                      "shared/w_down": f32(E_F, E_D)})
    return x, p, f32(B, E_T, E_D, scale=1.0)


# each block leaf's sharded dimension (None: replicated)
BLOCK_SPECS = {
    "moe_ep": {"router": None, "w_gate": 0, "w_up": 0, "w_down": 0, "shared/w_gate": 1,
               "shared/w_up": 1, "shared/w_down": 0},
    "moe_tp": {"router": None, "w_gate": 2, "w_up": 2, "w_down": 1},
    "mla": {"w_dkv": None, "w_kr": None, "w_q": 1, "w_uk": 1, "w_uv": 1, "wo": 0},
}


_JAX = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.models.common import Axes, embed_lookup, tp_cross_entropy, col_parallel, row_parallel, swiglu
from repro.parallel.collectives import sharded_jit

cases, mlp, blocks = pickle.load(open({inp!r}, "rb"))
out = {{}}
for (tp, vocab), a in cases.items():
    mesh = jax.make_mesh((4 // tp, tp), ("data", "model"))
    axes = Axes(tp="model", tp_size=tp)

    def body(table, head, h, r, ids, labels):
        def loss_fn(table, head, h):
            x = embed_lookup(table, ids, axes)
            logits = jnp.einsum("btd,dv->btv", h + x, head)
            ce = tp_cross_entropy(logits, labels, axes)
            mask = (labels >= 0).astype(jnp.float32)
            return jnp.sum(ce * mask) / jnp.sum(mask) + jnp.sum(x * r), (ce, x)
        (loss, (ce, x)), g = jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
            table, head, h)
        return loss[None], ce[None], x[None], g[0], g[1], g[2][None]

    fn = sharded_jit(body, mesh, (P("model", None), P(None, "model"), P(), P(), P(), P()),
                     (P("model"), P("model"), P("model"), P("model", None), P(None, "model"),
                      P("model")))
    res = fn(*(jnp.asarray(a[k]) for k in ("table", "head", "h", "r", "ids", "labels")))
    out[(tp, vocab)] = [np.asarray(v) for v in res]

mesh = jax.make_mesh((2, 2), ("data", "model"))
axes = Axes(tp="model", tp_size=2)

def mlp_body(x, w_gate, w_up, w_down, r):
    def loss_fn(x, w_gate, w_up, w_down):
        h = swiglu(col_parallel(x, w_gate, axes), col_parallel(x, w_up, axes))
        y = row_parallel(h, w_down, axes)
        return jnp.sum(y * r), y
    (loss, y), g = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        x, w_gate, w_up, w_down)
    return loss[None], y[None], g[0][None], g[1], g[2], g[3]

fn = sharded_jit(mlp_body, mesh, (P(), P(None, "model"), P(None, "model"), P("model", None), P()),
                 (P("model"), P("model"), P("model"), P(None, "model"), P(None, "model"),
                  P("model", None)))
out["mlp"] = [np.asarray(v) for v in fn(*(jnp.asarray(mlp[k]) for k in
                                          ("x", "w_gate", "w_up", "w_down", "r")))]

from repro.models.moe import moe_block
from repro.models.mla import mla_train

def nest(p):  # "shared/w_up" -> {{"shared": {{"w_up": ...}}}}
    out = {{}}
    for k, v in p.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {{}})
        d[last] = v
    return out

def unnest(p, prefix=""):
    out = {{}}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(unnest(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out

for name, (n_exp, tp, x, p, r, sp) in blocks.items():
    mesh = jax.make_mesh((4 // tp, tp), ("data", "model"))
    axes = Axes(tp="model", tp_size=tp)
    names = sorted(p)
    specs = tuple(P(*[("model" if i == sp[k] else None) for i in range(p[k].ndim)]) for k in names)

    def blk(x, r, *leaves):
        def loss_fn(x, leaves):
            q = nest(dict(zip(names, leaves)))
            if name == "mla":
                pos = jnp.broadcast_to(jnp.arange(x.shape[1], dtype=jnp.int32), x.shape[:2])
                y = mla_train(q, x, pos, axes, n_heads_local=4 // tp, head_dim=8)
            else:
                y = moe_block(q, x, axes, n_experts=n_exp, top_k=2)
            return jnp.sum(y * r), y
        (loss, y), (gx, gl) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(x, list(leaves))
        # a replicated leaf's gradient is each device's partial one
        gl = [g[None] if sp[k] is None else g for k, g in zip(names, gl)]
        return (loss[None], y[None], gx[None], *gl)

    gspecs = tuple(P("model") if sp[k] is None else s for k, s in zip(names, specs))
    fn = sharded_jit(blk, mesh, (P(), P(), *specs), (P("model"), P("model"), P("model"), *gspecs))
    res = fn(jnp.asarray(x), jnp.asarray(r), *(jnp.asarray(p[k]) for k in names))
    out[name] = [np.asarray(v) for v in res[:3]] + [dict(zip(names, (np.asarray(v) for v in res[3:])))]
pickle.dump(out, open({outp!r}, "wb"))
print("JAX_TP_OK")
"""


def _slice(a, dim, tp, i):
    n = a.shape[dim] // tp
    return a.narrow(dim, i * n, n).clone()


def _port_case(axes, a):
    """One rank: the primitives' loss, values and gradients on its shard."""
    tp, i = axes.tp_size, axes.tp_index
    table = _slice(torch.from_numpy(a["table"]), 0, tp, i).requires_grad_(True)
    head = _slice(torch.from_numpy(a["head"]), 1, tp, i).requires_grad_(True)
    h = torch.from_numpy(a["h"]).requires_grad_(True)
    ids, labels = torch.from_numpy(a["ids"]), torch.from_numpy(a["labels"])
    x = embed_lookup(table, ids, axes)
    ce = tp_cross_entropy((h + x) @ head, labels, axes)
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(ce * mask) / torch.sum(mask) + torch.sum(x * torch.from_numpy(a["r"]))
    g = torch.autograd.grad(loss, [table, head, h])
    return [loss.detach(), ce.detach(), x.detach(), *g]


def _port_mlp(axes, m):
    tp, i = axes.tp_size, axes.tp_index
    x = torch.from_numpy(m["x"]).requires_grad_(True)
    w_gate = _slice(torch.from_numpy(m["w_gate"]), 1, tp, i).requires_grad_(True)
    w_up = _slice(torch.from_numpy(m["w_up"]), 1, tp, i).requires_grad_(True)
    w_down = _slice(torch.from_numpy(m["w_down"]), 0, tp, i).requires_grad_(True)
    hid = swiglu(col_parallel(x, w_gate, axes), col_parallel(x, w_up, axes))
    y = row_parallel(hid, w_down, axes)
    loss = torch.sum(y * torch.from_numpy(m["r"]))
    g = torch.autograd.grad(loss, [x, w_gate, w_up, w_down])
    return [loss.detach(), y.detach(), *g]


def _port_block(axes, name):
    from repro_torch.models.mla import mla_train
    from repro_torch.models.moe import moe_block

    n_exp, tp = BLOCKS[name]
    x, p, r = _block_inputs(name)
    x = torch.from_numpy(x).requires_grad_(True)
    q = {k: _slice(torch.from_numpy(v), BLOCK_SPECS[name][k], tp, axes.tp_index)
         if BLOCK_SPECS[name][k] is not None else torch.from_numpy(v) for k, v in p.items()}
    q = {k: v.requires_grad_(True) for k, v in q.items()}
    if name == "mla":
        pos = torch.arange(x.shape[1]).expand(x.shape[:2])
        y = mla_train(q, x, pos, n_heads=4 // tp, head_dim=8, axes=axes)
    else:
        y = moe_block(q, x, n_experts=n_exp, top_k=2, axes=axes)
    loss = torch.sum(y * torch.from_numpy(r))
    g = torch.autograd.grad(loss, [x, *q.values()])
    return [loss.detach(), y.detach(), g[0], dict(zip(q, g[1:]))]


def _axes(grid):
    return Axes(group=grid.model_group, tp_size=grid.tp, tp_index=grid.tp_index)


def _ranks(group, rank, cases, mlp):
    grids = {2: make_debug_mesh(2, 2), 4: make_debug_mesh(1, 4)}
    out = {key: _port_case(_axes(grids[key[0]]), a) for key, a in cases.items()}
    out["mlp"] = _port_mlp(_axes(grids[2]), mlp)
    for name in BLOCKS:
        out[name] = _port_block(_axes(grids[BLOCKS[name][1]]), name)
    # all_to_all_tp over the 1 x 4 grid's model group: row j goes to rank j
    x = (torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * rank).requires_grad_(True)
    y = coll.all_to_all_tp(x, grids[4].model_group)
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3) * (rank + 1)
    out["a2a"] = (y.detach(), torch.autograd.grad(torch.sum(y * w), x)[0])
    out["tp_counts"] = coll.tp_counts()
    out["grid"] = (grids[2].dp_index, grids[2].tp_index, grids[4].dp_index, grids[4].tp_index)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from conftest import run_forced_mesh

    tmp = tmp_path_factory.mktemp("tp")
    cases = {(tp, v): _inputs(v, tp) for tp, v in CASES}
    mlp = _mlp_inputs()
    inp, outp = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    blocks = {}
    for name, (n_exp, tp) in BLOCKS.items():
        x, p, r = _block_inputs(name)
        blocks[name] = (n_exp, tp, x, p, r, BLOCK_SPECS[name])
    with open(inp, "wb") as fh:
        pickle.dump((cases, mlp, blocks), fh)
    assert "JAX_TP_OK" in run_forced_mesh(_JAX.format(inp=inp, outp=outp))
    with open(outp, "rb") as fh:
        jax_out = pickle.load(fh)
    return run_ranks(_ranks, 4, args=(cases, mlp)), jax_out


def _close(got, want, rtol, what):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol, err_msg=what)


@pytest.mark.parametrize("tp,vocab", CASES)
def test_embed_lookup_and_parallel_cross_entropy_match_jax(runs, tp, vocab):
    ranks, jax_out = runs
    loss, ce, x, g_table, g_head, g_h = jax_out[(tp, vocab)]
    a = _inputs(vocab, tp)
    for rank, r in enumerate(ranks if tp == 4 else ranks[:2]):
        i = rank % tp
        got = r[(tp, vocab)]
        _close(got[0], loss[i], 1e-6, "loss")
        _close(got[1], ce[i], 1e-6, "per-token loss")
        _close(got[2], x[i], 1e-6, "rows")
        n_v = g_table.shape[0] // tp
        _close(got[3], g_table[i * n_v:(i + 1) * n_v], 1e-5, "table grad")
        _close(got[4], g_head[:, i * n_v:(i + 1) * n_v], 1e-5, "head grad")
        _close(got[5], g_h[i], 1e-5, "hidden grad (this rank's partial)")
    # the picked rows are the table's; the loss is the plain softmax CE
    full = torch.from_numpy(a["table"])[torch.from_numpy(a["ids"])]
    assert torch.allclose(ranks[0][(tp, vocab)][2], full)
    logits = (torch.from_numpy(a["h"]) + full) @ torch.from_numpy(a["head"])
    want = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.from_numpy(a["labels"]).clamp(0)[..., None])[..., 0]
    keep = torch.from_numpy(a["labels"]) >= 0
    assert torch.allclose(ranks[0][(tp, vocab)][1][keep], want[keep], rtol=1e-5, atol=1e-5)
    # the psum transpose's factor: the head's gradient is tp x the
    # single-device one (the table's rows and the head columns of a padded
    # vocabulary included)
    head = torch.from_numpy(a["head"]).requires_grad_(True)
    lg = (torch.from_numpy(a["h"]) + full) @ head
    ce1 = torch.logsumexp(lg, -1) - torch.gather(
        lg, -1, torch.from_numpy(a["labels"]).clamp(0)[..., None])[..., 0]
    g1 = torch.autograd.grad(torch.sum(ce1 * keep) / keep.sum(), head)[0]
    g_tp = torch.cat([r[(tp, vocab)][4] for r in ranks[:tp]], dim=1)
    assert torch.allclose(g_tp, tp * g1, rtol=1e-4, atol=1e-6)


def test_column_then_row_parallel_mlp_gradients_match_jax(runs):
    ranks, jax_out = runs
    loss, y, g_x, g_gate, g_up, g_down = jax_out["mlp"]
    for rank, r in enumerate(ranks):
        i = rank % 2
        got = r["mlp"]
        _close(got[0], loss[i], 1e-6, "loss")
        _close(got[1], y[i], 1e-6, "out")
        _close(got[2], g_x[i], 1e-5, "x grad (partial)")
        _close(got[3], g_gate[:, i * 12:(i + 1) * 12], 1e-5, "w_gate grad")
        _close(got[4], g_up[:, i * 12:(i + 1) * 12], 1e-5, "w_up grad")
        _close(got[5], g_down[i * 12:(i + 1) * 12], 1e-5, "w_down grad")


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_tp_blocks_match_jax(runs, name):
    from repro_torch.models.moe import pick_strategy

    ranks, jax_out = runs
    n_exp, tp = BLOCKS[name]
    if n_exp:
        assert pick_strategy(n_exp, tp) == name[len("moe_"):]
    loss, y, g_x, g_leaves = jax_out[name]
    for rank, r in enumerate(ranks if tp == 4 else ranks[:2]):
        i = rank % tp
        got = r[name]
        _close(got[0], loss[i], 1e-5, "loss")
        _close(got[1], y[i], 1e-5, "out")
        _close(got[2], g_x[i], 1e-5, "x grad (partial)")
        for k, want in g_leaves.items():
            dim = BLOCK_SPECS[name][k]
            if dim is None:  # this device's partial gradient
                want = want[i]
            else:
                n = want.shape[dim] // tp
                want = np.take(want, range(i * n, (i + 1) * n), axis=dim)
            _close(got[3][k], want, 1e-5, f"{k} grad")


def test_all_to_all_tp_exchanges_rows_and_inverts_its_gradient(runs):
    ranks, _ = runs
    assert [r["grid"] for r in ranks] == [(0, 0, 0, 0), (0, 1, 0, 1), (1, 0, 0, 2),
                                          (1, 1, 0, 3)]
    for rank, r in enumerate(ranks):
        y, g = r["a2a"]
        want = torch.stack([torch.arange(3, dtype=torch.float32) + 3 * rank + 100 * j
                            for j in range(4)])
        assert torch.equal(y, want)
        # row j of y came from rank j and weighs w's row j there: the
        # gradient of x's row j is rank j's row `rank` of its w
        want_g = torch.stack([torch.arange(3, dtype=torch.float32) + 3 * rank
                              for _ in range(4)]) * torch.arange(1, 5.0)[:, None]
        assert torch.equal(g, want_g)
        counts = r["tp_counts"]
        # this exchange, and moe_ep's two (out and back) on the 2 x 2 grid
        assert counts["all_to_all_tp"] == counts["all_to_all_tp_backward"] == 3
        assert counts["psum_tp"] > 0 and counts["psum_tp_backward"] == counts["psum_tp"]


def test_model_axis_needs_a_group():
    x = torch.ones(3)
    assert SINGLE.psum_tp(x) is x and SINGLE.pmax_tp(x) is x
    with pytest.raises(ValueError, match="model group"):
        Axes(tp_size=2).psum_tp(x)
    with pytest.raises(ValueError, match="model group"):
        coll.all_to_all_tp(x, None)
    with pytest.raises(ValueError, match="local backend"):
        CommCtx(n_workers=2, model_group=object())


def _bad_grid(group, rank):
    try:
        make_debug_mesh(2, 2)
    except ValueError as e:
        return str(e)
    return None


def test_grid_must_fit_the_world():
    assert all("needs 4 ranks" in m for m in run_ranks(_bad_grid, 2))


@pytest.mark.parametrize("arch,data,model", [("granite-8b", 2, 2),
                                             ("deepseek-v2-lite-16b", 1, 2)])
def test_cli_under_torchrun_on_a_grid(arch, data, model):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(data * model), "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
           "--data", str(data), "--model", str(model), "--steps", "6", "--batch", "4",
           "--seq", "32", "--compressor", "intsgd8_packed", "--wire", "packed8", "--device",
           "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    losses = [float(v) for v in re.findall(r"step +\d+ loss ([0-9.]+)", r.stdout)]
    assert len(losses) == 2, r.stdout  # steps 0 and 5, printed by rank 0 alone
    assert losses[1] < losses[0] - 0.1, losses
