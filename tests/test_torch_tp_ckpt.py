"""Port vs JAX: checkpoints and the elastic resume on a 2 × 2 (data × model)
grid, float32.

1. A JAX train run on a forced 4-device (2, 2) mesh (granite-8b smoke,
   ZeRO-1 AdamW, IntSGD on packed8) saves step 2 with the JAX package's
   store; the port's gloo ranks restore it into their own train state and
   each rank's leaves equal the JAX device's shards bit for bit (the
   shards as the JAX package's own ``restore(..., shardings=)`` places
   them: params, the (n_dp, tp · per) ZeRO-1 rows and AdamW's moments,
   α's per-replica state).
2. The port's checkpoints of two corners at step 2 (granite-8b fused SGD
   and deepseek-v2-lite-16b ZeRO-1 AdamW, both IntSGD on packed8) are read
   by the JAX package's ``CheckpointStore.restore`` into its
   ``build_train_step(...).arg_structs[1:3]`` (and the params' structs),
   and each JAX device's shard equals the rank's state at the save, bit
   for bit.
3. A resumed grid run (2 steps, save, resume, 2 more) equals the
   uninterrupted 4-step run: the losses and the step-4 state, bit for bit.
4. The elastic resume 2 × 2 -> 1 × 2 (rank 3 lost, so data replica 1
   retires whole): the plan equals the JAX package's, the fused route's
   state resumes on the two survivors with finite losses, and the ZeRO-1
   state (rows held one per data replica) is refused by name.

The JAX side runs in one subprocess while the port's runs on one 4-rank
gloo spawn; each waits for the other's checkpoint on disk.
"""
import dataclasses
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointStore, flatten_state  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import make_compressor, with_wire  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.step import build_init_state  # noqa: E402
from repro_torch.launch.train import OPTIMIZERS, train_loop  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402
from repro_torch.runtime.elastic import plan_after_failures  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH = 32, 4
# name: (arch, fused, optimizer, lr)
CORNERS = {"granite-fused-sgd": ("granite-8b", True, "sgd", 0.3),
           "deepseek-zero1-adamw": ("deepseek-v2-lite-16b", False, "adamw", 3e-4)}
JAX_CORNER = ("granite-8b", False, "adamw", 3e-4)  # the one JAX trains
PLAN = dict(dp=2, tp=2, failed_devices=[3], global_batch=BATCH, wire="packed8")
WAIT_S = 300.0


def _manifest(d, step=2):
    return os.path.join(d, f"step_{step:010d}", "manifest.json")


def _wait_for(path):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"no {path} after {WAIT_S} s")
        time.sleep(0.2)


_JAX = """
import dataclasses, os, pickle, time
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import CheckpointStore
from repro.configs import ShapeConfig, get_arch, smoke_config
from repro.core import make_compressor, with_wire
from repro.launch.step import build_train_step
from repro.launch.train import train_loop
from repro.optim import adamw, sgd
from repro.optim.schedules import constant, warmup_wrap
from repro.parallel.collectives import mesh_from_counts
from repro.runtime.elastic import plan_after_failures

jax_dir, port_dirs, corners, jax_corner, plan, outp, seq, batch = pickle.load(open({inp!r}, "rb"))
mesh = mesh_from_counts(data=2, model=2)
rank_of = {{d.id: i * 2 + j for (i, j), d in np.ndenumerate(mesh.devices)}}

def structs(arch, fused, opt, lr):
    cfg = smoke_config(get_arch(arch))
    o = {{"sgd": sgd(momentum=0.9, weight_decay=1e-4), "adamw": adamw(weight_decay=1e-4)}}[opt]
    art = build_train_step(cfg, mesh, ShapeConfig("cli", seq, batch, "train"),
                           compressor=with_wire(make_compressor("intsgd8_packed"), "packed8"),
                           base_opt=o, lr_schedule=warmup_wrap(constant(lr), 5),
                           param_dtype=jnp.float32, fused=fused, clip_norm=1.0)
    keys = ("params", "opt", "comp")
    return (dict(zip(keys, art.arg_structs[:3])), dict(zip(keys, art.in_shardings[:3])))

def per_rank(tree):
    out = [{{}} for _ in range(4)]
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        for sh in leaf.addressable_shards:
            out[rank_of[sh.device.id]][key] = np.asarray(sh.data)
    return out

out = {{"plan": dataclasses.asdict(plan_after_failures(**plan))}}
arch, fused, opt, lr = jax_corner
train_loop(smoke_config(get_arch(arch)), mesh, ShapeConfig("cli", seq, batch, "train"),
           compressor="intsgd8_packed", wire="packed8", steps=2, lr=lr, fused=fused, opt=opt,
           ckpt=CheckpointStore(jax_dir, async_writes=False), ckpt_every=2)
like, shard = structs(*jax_corner)
state, _, _ = CheckpointStore(jax_dir, async_writes=False).restore(like, shardings=shard)
out["jax"] = per_rank(state)
for name, corner in corners.items():
    like, shard = structs(*corner)
    path = os.path.join(port_dirs[name], "step_0000000002", "manifest.json")
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert time.monotonic() - t0 < {wait}, path
        time.sleep(0.2)
    store = CheckpointStore(port_dirs[name], async_writes=False)
    state, _, _ = store.restore(like, step=2, shardings=shard)
    out[name] = per_rank(state)
pickle.dump(out, open(outp, "wb"))
print("JAX_CKPT_OK")
"""


class Keep(CheckpointStore):
    """A store that also keeps, on every rank, a copy of the local state
    each save was given."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.kept = {}

    def save(self, step, tree, extra=None):
        self.kept[step] = {k: v.clone() for k, v in flatten_state(tree).items()}
        super().save(step, tree, extra)


def _corner_kw(corner):
    arch, fused, opt, lr = corner
    return smoke_config(get_arch(arch)), dict(
        compressor="intsgd8_packed", wire="packed8", fused=fused, opt=opt, lr=lr,
        device="cpu", log_every=100)


def _train(cfg, kw, grid, store, steps, resume=False):
    _, hist = train_loop(cfg, ShapeConfig("tp-ckpt", SEQ, BATCH, "train"), n_workers=grid.n_dp,
                         steps=steps, grid=grid, ckpt=store, ckpt_every=2, resume=resume, **kw)
    return [h["loss"] for h in hist]


def _store(d, grid, cfg, cls=Keep):
    return cls(d, grid=grid, specs=specs.infer_param_specs(cfg, grid.tp)[2],
               async_writes=False)


def _ranks(group, rank, dirs, jax_dir):
    grid = make_debug_mesh(2, 2)
    out = {}
    for name, corner in CORNERS.items():
        cfg, kw = _corner_kw(corner)
        half = _store(dirs[name], grid, cfg)
        losses2 = _train(cfg, kw, grid, half, 2)
        if rank == 0:  # the elastic resume's copy of step 2
            shutil.copytree(dirs[name], dirs[name] + "-elastic")
        coll.barrier(group)
        straight = _store(dirs[name] + "-straight", grid, cfg)
        losses4 = _train(cfg, kw, grid, straight, 4)
        resumed = _store(dirs[name], grid, cfg)
        losses_r = _train(cfg, kw, grid, resumed, 4, resume=True)
        out[name] = dict(losses2=losses2, losses4=losses4, losses_r=losses_r,
                         saved2=half.kept[2], straight4=straight.kept[4],
                         resumed4=resumed.kept[4], stats=dict(half.stats))
    # 1. JAX's checkpoint into the port's state
    cfg, kw = _corner_kw(JAX_CORNER)
    params = specs.tp_shard(cfg, 2, grid.tp_index).tree(init_lm_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu", tp=2))
    comp = with_wire(make_compressor("intsgd8_packed"), "packed8")
    opt_state, comp_state = build_init_state(params, n_workers=2, compressor=comp,
                                             base_opt=OPTIMIZERS["adamw"](), grid=grid)
    _wait_for(_manifest(jax_dir))
    state, _, step = _store(jax_dir, grid, cfg, CheckpointStore).restore(
        {"params": params, "opt": opt_state, "comp": comp_state})
    out["from_jax"] = (step, flatten_state(state))
    # 4. the elastic resume onto the 1 x 2 grid of the survivors (ranks 0, 1)
    plan = plan_after_failures(**PLAN)
    survivors = [r for r in range(4) if r // 2 not in plan.retired_replicas]
    small = make_debug_mesh(plan.n_dp, plan.tp, ranks=survivors)
    out["plan"] = dataclasses.asdict(plan)
    if small is not None:
        name = "granite-fused-sgd"
        cfg, kw = _corner_kw(CORNERS[name])
        out["elastic"] = _train(cfg, kw, small, _store(dirs[name] + "-elastic", small, cfg),
                                4, resume=True)
        cfg, kw = _corner_kw(CORNERS["deepseek-zero1-adamw"])
        try:
            _train(cfg, kw, small, _store(dirs["deepseek-zero1-adamw"] + "-elastic", small,
                                          cfg), 4, resume=True)
            out["elastic_zero1"] = None
        except ValueError as e:
            out["elastic_zero1"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    dirs = {name: str(tmp / name) for name in CORNERS}
    jax_dir, inp, outp = str(tmp / "jax"), str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as fh:
        pickle.dump((jax_dir, dirs, CORNERS, JAX_CORNER, PLAN, outp, SEQ, BATCH), fh)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX.format(inp=inp, wait=WAIT_S)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = run_ranks(_ranks, 4, args=(dirs, jax_dir))
        stdout, stderr = proc.communicate(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "JAX_CKPT_OK" in stdout, stderr[-4000:]
    with open(outp, "rb") as fh:
        return ranks, pickle.load(fh), dirs


def _same(got: torch.Tensor, want: np.ndarray, what):
    want = np.asarray(want).reshape(tuple(got.shape))  # α's (1,) replica row -> ()
    assert got.dtype == torch.from_numpy(want).dtype, what
    assert np.array_equal(got.numpy(), want), what


def test_jax_checkpoint_restores_onto_the_port_grid(runs):
    ranks, jout, _ = runs
    for rank, r in enumerate(ranks):
        step, got = r["from_jax"]
        assert step == 2 and set(got) == set(jout["jax"][rank])
        for k, v in got.items():
            _same(v, jout["jax"][rank][k], (rank, k))
    # the rows of a replicated leaf hold each member's copy, side by side
    assert ranks[0]["from_jax"][1]["opt/master/ln_f"].shape == (1, 32)


@pytest.mark.parametrize("name", list(CORNERS))
def test_port_checkpoint_is_read_by_jax(runs, name):
    ranks, jout, dirs = runs
    for rank, r in enumerate(ranks):
        saved = r[name]["saved2"]
        assert set(saved) == set(jout[name][rank])
        for k, v in saved.items():
            _same(v, jout[name][rank][k], (name, rank, k))


@pytest.mark.parametrize("name", list(CORNERS))
def test_resumed_grid_run_equals_the_uninterrupted_one(runs, name):
    ranks, _, _ = runs
    for r in ranks:
        c = r[name]
        assert c["losses2"] == c["losses4"][:2] and c["losses_r"] == c["losses4"][2:]
        assert set(c["resumed4"]) == set(c["straight4"])
        for k, v in c["straight4"].items():
            assert torch.equal(c["resumed4"][k], v), (name, k)
    stats = ranks[0][name]["stats"]  # the writer's timings and bytes
    assert stats["bytes"] > 0 and min(stats["host_s"], stats["disk_s"]) >= 0


def test_elastic_resume_onto_the_survivors_grid(runs):
    ranks, jout, _ = runs
    plan = ranks[0]["plan"]
    assert jout["plan"] == plan and plan["n_dp"] == 1 and plan["tp"] == 2
    assert tuple(plan["retired_replicas"]) == (1,)
    for rank in (0, 1):
        losses = ranks[rank]["elastic"]
        assert len(losses) == 2 and all(np.isfinite(losses))
        msg = ranks[rank]["elastic_zero1"]
        assert msg is not None and "held one row per worker" in msg, msg
        assert "saved by 2 workers" in msg and "restored at 1" in msg, msg
    assert ranks[0]["elastic"] == ranks[1]["elastic"]
    assert "elastic" not in ranks[2] and "elastic" not in ranks[3]
