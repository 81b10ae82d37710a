"""Port vs JAX: the paper's reduce-shaped compressors on a 2 × 2 data ×
model grid — the uncompressed ``none`` and ``allgather_sgd``, SignSGD
and PowerSGD — and their checkpoints at tp = 2. The scheme, the grid, the
step and the checks are ``tests/test_torch_tp_baselines.py``'s (one JAX
subprocess beside one 4-rank gloo spawn; JAX's gradients handed to the
port's step from JAX's state); the tolerances are its ``TOL``, the ones
``tests/test_torch_baselines.py`` holds each compressor to at tp = 1:
``none`` and ``allgather_sgd`` rtol 1e-6 (a float mean), SignSGD rtol
1e-6 (its scale ‖w‖₁/d through a reduction), PowerSGD rtol 1e-4 with an
absolute floor of 1e-4 of the largest |value| (two matmuls and a QR in
another order).

Corners: granite-8b smoke at 2 layers, and PowerSGD also on xlstm-125m
smoke at 6 layers (two (m, m, s) blocks, so every stacked leaf has 2
rows, PowerSGD's rank), PowerSGD at ``min_compress_size=256``.

PowerSGD at tp > 1 (ROADMAP's reference behaviours):

- Q's global layout is the JAX package's ``_comp_state_shapes`` rule: for
  a param sharded past its rows, Q (cols, rank) is sharded on its rows,
  the ranks' local Qs stacked; ``comp_state_from_jax`` takes the rank's
  rows, equal to its JAX device's buffer bit for bit;
- for a param sharded on its rows (``embed``, ``lm_head``'s transpose
  being the other case) Q has the same shape on every rank, which JAX's
  spec calls replicated, yet each rank's next Q is its own M_localᵀ·P̂:
  each rank's Q is held to its own JAX device's buffer
  (``addressable_shards``), and ``np.asarray`` of JAX's global array holds
  model rank 0's, which is what ``comp_state_from_jax`` gives every rank
  and what a checkpoint of either package holds.

Checkpoints (the port's own run, 3 steps, saved after the second): for
TopK, PowerSGD and IntSGD on ``topk8`` the manifest's compressor shapes
are JAX's ``_comp_state_shapes`` global shapes (the leading n_dp axis);
JAX's ``CheckpointStore.restore`` reads the file onto its mesh, every
device's shard equal to the rank's state at the save bit for bit
(PowerSGD's row-sharded Q: model rank 0's on both); a resumed TopK and
IntSGD-``topk8`` run equals the uninterrupted one bit for bit; a resumed
PowerSGD run restores model rank 0's Q of ``embed`` on model rank 1 as
well, so it differs from the uninterrupted run there, as it does in the
JAX package.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_baselines import (  # noqa: E402
    BATCH, GRID, LR, SEQ, TOL, check_corner, corner_cfg, corner_rank, run_both, wait_load,
)

from repro_torch.checkpoint import CheckpointStore, flatten_state  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.compressor import leaf_seeds, make_compressor  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMData  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.step import build_init_state, build_train_step  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

P256 = {"min_compress_size": 256}
# name: (arch, layers, compressor, make_compressor arguments, n_dp, tp)
CORNERS = {
    "none": ("granite-8b", 2, "none", {}, *GRID),
    "allgather_sgd": ("granite-8b", 2, "allgather_sgd", {}, *GRID),
    "signsgd": ("granite-8b", 2, "signsgd", {}, *GRID),
    "powersgd": ("granite-8b", 2, "powersgd", P256, *GRID),
    "powersgd-xlstm": ("xlstm-125m", 6, "powersgd", P256, *GRID),
}
# the checkpoint corners (granite-8b smoke, 2 layers): name -> compressor
CKPT = {"topk": ("topk", {}), "powersgd": ("powersgd", P256),
        "intsgd-topk8": ("intsgd", {"bits": 8, "wire": "topk8:16"})}
CKPT_STEPS = 3

# run after the corners in the JAX subprocess (the same globals): JAX's own
# PowerSGD buffers, then each port checkpoint read by JAX's store
_JAX_CKPT = """
from repro.checkpoint import CheckpointStore
from repro.launch import step as jstep2
ck_dirs, ck_corners = pickle.load(open(os.path.join(out_dir, "ckpt_in.pkl"), "rb"))
cfg = dataclasses.replace(smoke_config(get_arch("granite-8b")), n_layers=2)
mesh = jax.make_mesh((2, 2), ("data", "model"))
pos = {d.id: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}
out = {}

def per_rank(tree):
    got = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        for sh in leaf.addressable_shards:
            got.setdefault(pos[sh.device.id], {})[key_of(path)] = np.asarray(sh.data)
    return got

for name, (comp, kw) in ck_corners.items():
    jc = make_compressor(comp, **kw)
    art = jstep2.build_train_step(cfg, mesh, ShapeConfig("tp", seq, batch, "train"),
                                  compressor=jc, base_opt=sgd(momentum=0.9),
                                  lr_schedule=constant(lr), param_dtype=jnp.float32,
                                  fused=False, clip_norm=1.0, donate=False)
    glob = jstep2._comp_state_shapes(jc, cfg, 2, 2)[0]
    shapes = {"comp/" + key_of(p): tuple(v.shape)
              for p, v in jax.tree_util.tree_flatten_with_path(glob)[0]}
    keys = ("params", "opt", "comp")
    like = dict(zip(keys, art.arg_structs[:3]))
    shard = dict(zip(keys, art.in_shardings[:3]))
    path = os.path.join(ck_dirs[name], "step_0000000002", "manifest.json")
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert time.monotonic() - t0 < wait_s, path
        time.sleep(0.2)
    state, _, _ = CheckpointStore(ck_dirs[name], async_writes=False).restore(
        like, step=2, shardings=shard)
    out[name] = dict(shapes=shapes, restored=per_rank(state))
# JAX's own PowerSGD state after its steps: np.asarray's copy of a
# row-sharded leaf's Q, and what its store writes, are model rank 0's
recs = pickle.load(open(os.path.join(out_dir, "powersgd.pkl"), "rb"))
last = recs[-1]
out["jax_q"] = dict(glob=last["comp"]["q"], devices=last["q_after"])
pickle.dump(out, open(os.path.join(out_dir, "ckpt_out.pkl"), "wb"))
"""


def _ckpt_run(grid, name, d, resume=False):
    """The port's own run of ``CKPT[name]`` on this rank, ``CKPT_STEPS``
    steps from the seed-0 draw, saved after its second (or resumed from
    that save): the losses, the state at the save (or just restored) and
    the final state, flattened."""
    comp_name, kw = CKPT[name]
    cfg = corner_cfg("granite-8b", 2)
    comp, base_opt = make_compressor(comp_name, **kw), sgd(momentum=0.9)
    shape = ShapeConfig("tp", SEQ, BATCH, "train")
    art = build_train_step(cfg, shape, n_workers=grid.n_dp, compressor=comp, base_opt=base_opt,
                           lr_schedule=constant(LR), param_dtype=torch.float32, clip_norm=1.0,
                           device="cpu", grid=grid)
    params = specs.tp_shard(cfg, grid.tp, grid.tp_index).tree(init_lm_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu", tp=grid.tp))
    opt_state, comp_state = build_init_state(params, n_workers=grid.n_dp, compressor=comp,
                                             base_opt=base_opt, grid=grid)
    store = CheckpointStore(d, grid=grid, specs=specs.infer_param_specs(cfg, grid.tp)[2],
                            async_writes=False)
    seed_gen = torch.Generator().manual_seed(0)
    data = SyntheticLMData(cfg.vocab, SEQ, BATCH, seed=0)
    n_leaves, start, kept, losses = len(art.layout.names), 0, None, []
    if resume:
        state, _, start = store.restore({"params": params, "opt": opt_state, "comp": comp_state})
        params, opt_state, comp_state = state["params"], state["opt"], state["comp"]
        kept = {k: v.clone() for k, v in flatten_state(state).items()}
        for _ in range(start):
            leaf_seeds(seed_gen, grid.n_dp, n_leaves, "cpu")
    for i in range(start, CKPT_STEPS):
        seeds = leaf_seeds(seed_gen, grid.n_dp, n_leaves, "cpu")
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        params, opt_state, comp_state, loss, _ = fn(params, opt_state, comp_state, i,
                                                    data.batch(i, 0, device="cpu"), seeds)
        losses.append(float(loss))
        if i + 1 == 2 and not resume:
            tree = {"params": params, "opt": opt_state, "comp": comp_state}
            kept = {k: v.clone() for k, v in flatten_state(tree).items()}
            store.save(2, tree)
            store.wait()
    final = {"params": params, "opt": opt_state, "comp": comp_state}
    return dict(losses=losses, kept=kept,
                final={k: v.clone() for k, v in flatten_state(final).items()})


def _ranks(group, rank, corners, out_dir, batches, ck_dirs):
    grid = make_debug_mesh(*GRID)
    out = {"ckpt": {}}
    for name in CKPT:  # first: the JAX subprocess reads these after its corners
        straight = _ckpt_run(grid, name, ck_dirs[name])
        resumed = _ckpt_run(grid, name, ck_dirs[name], resume=True)
        out["ckpt"][name] = dict(straight=straight, resumed=resumed)
    for name in corners:
        out[name] = corner_rank(grid, corners, name,
                                wait_load(os.path.join(out_dir, name + ".pkl")), batches)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import pickle

    tmp = tmp_path_factory.mktemp("tp_baselines_reduce")
    ck_dirs = {name: str(tmp / f"ck-{name}") for name in CKPT}
    with open(tmp / "ckpt_in.pkl", "wb") as fh:
        pickle.dump((ck_dirs, CKPT), fh)
    ref, ranks = run_both(tmp, CORNERS, ranks=_ranks, extra=(ck_dirs,),
                          jax_tail=_JAX_CKPT)
    with open(tmp / "ckpt_out.pkl", "rb") as fh:
        jck = pickle.load(fh)
    jck["dirs"] = ck_dirs
    return ref, ranks, jck


@pytest.mark.parametrize("name", list(CORNERS))
def test_tp_baseline_step_matches_jax(runs, name):
    ref, ranks, _ = runs
    check_corner(ref, ranks, CORNERS, name)


@pytest.mark.parametrize("name", ["powersgd", "powersgd-xlstm"])
def test_powersgd_q_is_each_rank_own_device_buffer(runs, name):
    """Each rank's Q after every step against its own JAX device's buffer
    (PowerSGD's tolerance); before the step, ``comp_state_from_jax``'s Q is
    the device's buffer bit for bit where Q is sharded (a param sharded
    past its rows) and model rank 0's where it is not; the row-sharded
    ``embed``'s Q differs between the two model ranks once a step has run
    (JAX's buffers and the port's alike)."""
    ref, ranks, _ = runs
    arch, layers, *_ = CORNERS[name]
    spec = specs.infer_param_specs(corner_cfg(arch, layers), 2)[2]
    rtol, atol = TOL["powersgd"][0]
    for i, want in enumerate(ref[name]):
        for rank, r in enumerate(ranks):
            me = divmod(rank, GRID[1])
            got = r[name][i]
            assert set(got["q"]) == set(want["q_after"][me]), (name, i)
            for k, q in got["q"].items():
                w = want["q_after"][me][k]
                np.testing.assert_allclose(q.numpy(), w, rtol=rtol,
                                           atol=atol * float(np.abs(w).max()),
                                           err_msg=f"{name} step {i} rank {me} q {k}")
                src = me if spec[k] is not None and spec[k] >= 1 else (me[0], 0)
                assert np.array_equal(got["q_from_jax"][k].numpy(),
                                      want["q_before"][src][k]), (name, i, me, k)
        if i > 0 and "embed" in want["q_after"][(0, 0)]:
            for d in range(GRID[0]):
                a, b = want["q_after"][(d, 0)]["embed"], want["q_after"][(d, 1)]["embed"]
                assert not np.allclose(a, b), (name, i, d)


def test_jax_global_q_holds_model_rank_0s_buffer(runs):
    """The JAX package's own PowerSGD state at tp = 2: ``np.asarray`` of a
    row-sharded leaf's Q (``embed``) holds, for each data replica, model
    rank 0's buffer and not model rank 1's, so a checkpoint (which writes
    ``np.asarray``) keeps rank 0's; a Q sharded on its rows is the two
    ranks' buffers stacked."""
    _, _, jck = runs
    glob, dev = jck["jax_q"]["glob"], jck["jax_q"]["devices"]
    for d in range(GRID[0]):
        assert np.array_equal(glob["embed"][d], dev[(d, 0)]["embed"])
        assert not np.array_equal(glob["embed"][d], dev[(d, 1)]["embed"])
        stacked = np.concatenate([dev[(d, m)]["layers/attn/wq"] for m in range(GRID[1])])
        assert np.array_equal(glob["layers"]["attn"]["wq"][d], stacked)


@pytest.mark.parametrize("name", list(CKPT))
def test_tp_checkpoint_has_jax_global_shapes_and_is_read_by_jax(runs, name):
    _, ranks, jck = runs
    import json

    meta = json.load(open(os.path.join(jck["dirs"][name], "step_0000000002",
                                       "manifest.json")))["arrays"]
    comp = {k: tuple(v["shape"]) for k, v in meta.items() if k.startswith("comp/")}
    assert comp == jck[name]["shapes"], name
    spec = specs.infer_param_specs(corner_cfg("granite-8b", 2), 2)[2]
    for rank, r in enumerate(ranks):
        me = divmod(rank, GRID[1])
        kept = r["ckpt"][name]["straight"]["kept"]
        restored = jck[name]["restored"][me]
        assert set(kept) == set(restored), name
        for k, v in kept.items():
            want = restored[k]
            if k.startswith("comp/q/") and spec[k[len("comp/q/"):]] == 0:
                v = ranks[rank - me[1]]["ckpt"][name]["straight"]["kept"][k]  # rank 0's
            want = np.asarray(want).reshape(tuple(v.shape))
            assert np.array_equal(v.numpy(), want), (name, me, k)


@pytest.mark.parametrize("name", ["topk", "intsgd-topk8"])
def test_tp_resume_equals_the_uninterrupted_run(runs, name):
    _, ranks, _ = runs
    for r in ranks:
        s, q = r["ckpt"][name]["straight"], r["ckpt"][name]["resumed"]
        assert q["losses"] == s["losses"][2:], name
        assert set(q["final"]) == set(s["final"])
        for k, v in s["final"].items():
            assert torch.equal(q["final"][k], v), (name, k)


def test_tp_powersgd_resume_takes_model_rank_0s_q(runs):
    """A resumed PowerSGD run at tp = 2 restores every leaf as saved, but
    ``embed``'s Q on model rank 1 is model rank 0's copy (the reference's
    global layout holds one), so the resumed step-2 loss is the
    uninterrupted one and its update differs from it."""
    _, ranks, _ = runs
    for rank, r in enumerate(ranks):
        dp_i, tp_i = divmod(rank, GRID[1])
        s, q = r["ckpt"]["powersgd"]["straight"], r["ckpt"]["powersgd"]["resumed"]
        mate = ranks[rank - tp_i]["ckpt"]["powersgd"]["straight"]["kept"]
        assert q["losses"][0] == s["losses"][2]
        for k, v in s["kept"].items():
            want = mate[k] if k == "comp/q/embed" else v
            assert torch.equal(q["kept"][k], want), (rank, k)
        if tp_i == 1:
            assert not torch.equal(s["kept"]["comp/q/embed"], mate["comp/q/embed"])
            assert not torch.equal(q["final"]["params/embed"], s["final"]["params/embed"])
