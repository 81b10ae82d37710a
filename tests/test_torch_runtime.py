"""Port vs JAX: the runtime (``runtime/straggler.py``, ``runtime/elastic.py``)
and the elastic resume of ``launch/train.py``.

1. ``plan_after_failures``: every case of the JAX package's
   ``tests/test_runtime.py`` and ``tests/test_topk.py`` planner tests, and
   a few more (a rescaled batch on packed8, an old count past the wire's
   range, a metered wire), as one parametrised test: the port's
   ``ElasticPlan`` equals JAX's field for field, ``note`` letter for
   letter, or both raise the same error with the same message.
2. ``straggler_tolerant_sum`` on the local backend (n = 4, one worker late)
   over the default int32 wire, dense8, packed8 and topk8 (k = 6): the sum
   and n_live bit-equal to JAX's under ``vmap_workers`` for the same
   images; a dead worker's image replaced by in-range garbage changes
   nothing; dense8 and packed8 agree.
3. ``decode_partial`` with a per-leaf α, a scalar α and an all-dead round:
   bit-equal to JAX's, the flag the same, the dead round finite.
4. The straggler sum on packed8 and dense8 over four gloo ranks (the port's
   counterpart of ``test_straggler_mesh_packed8``): bit-equal to the local
   backend, n_live 3 on every rank.
5. ``test_failure_recovery_end_to_end`` on the port's ``SimTrainer`` and
   ``CheckpointStore``: logreg, 8 workers for 40 steps, a checkpoint, then
   6 workers for 60 steps from the restored params, IntSGD on the counter
   PRNG with JAX's encode seeds handed in (``seeds_fn``); params held to
   JAX's at the checkpoint and at the end within ``test_torch_simulate.py``'s
   tolerance (rtol 1e-6, atol 1e-6 of the largest |param|), and the
   survivors' loss decreasing.
6. ``train_loop(resume=True)`` at n = 3 from a checkpoint written at n = 4
   (granite smoke, 2 layers, the fused route, IntSGD on packed8): its
   losses, max_int and params bit-equal to a fresh 3-worker loop from the
   restored state; a ZeRO-1 and an IntDIANA checkpoint are refused, naming
   the leaf and both counts.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointStore as JCheckpointStore  # noqa: E402
from repro.core.comm import CommCtx as JCommCtx  # noqa: E402
from repro.core.compressor import IntSGD as JIntSGD, _leaf_keys  # noqa: E402
from repro.core.simulate import SimTrainer as JSimTrainer  # noqa: E402
from repro.data.logreg import make_logreg as jmake_logreg  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim.schedules import constant as jconstant  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro.runtime import plan_after_failures as jplan  # noqa: E402
from repro.runtime.straggler import (  # noqa: E402
    decode_partial as jdecode_partial, straggler_tolerant_sum as jsum,
)
from repro.wire import make_wire_format as jwire  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import leaf_seeds, make_compressor  # noqa: E402
from repro_torch.core.simulate import SimTrainer  # noqa: E402
from repro_torch.data.logreg import LogRegProblem  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMData  # noqa: E402
from repro_torch.launch.step import build_init_state, build_train_step  # noqa: E402
from repro_torch.launch.train import OPTIMIZERS, train_loop  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402
from repro_torch.optim.schedules import constant, warmup_wrap  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402
from repro_torch.runtime import plan_after_failures  # noqa: E402
from repro_torch.runtime.straggler import decode_partial, straggler_tolerant_sum  # noqa: E402
from repro_torch.wire import make_wire_format  # noqa: E402

N = 4
ALIVE = (True, True, False, True)

# --------------------------------------------------------------------- 1.
PLANS = {
    "whole-tp-groups": dict(dp=16, tp=16, failed_devices=[5, 250], global_batch=256),
    "rescaled-batch": dict(dp=8, tp=2, failed_devices=[3], global_batch=64,
                           keep_global_batch=False),
    "total-failure": dict(dp=2, tp=2, failed_devices=[0, 3], global_batch=8),
    "packed8-valid": dict(dp=16, tp=1, failed_devices=[5], global_batch=256, wire="packed8"),
    "packed8-128-survivors": dict(dp=130, tp=1, failed_devices=[0, 1], global_batch=256,
                                  wire="packed8"),
    "packed8-x8-microbatches": dict(dp=33, tp=1, failed_devices=[0], global_batch=256,
                                    wire="packed8", microbatches=8),
    "packed8-x2-microbatches": dict(dp=33, tp=1, failed_devices=[0], global_batch=256,
                                    wire="packed8", microbatches=2),
    "no-wire-128-survivors": dict(dp=130, tp=1, failed_devices=[0, 1], global_batch=256),
    "topk16-valid": dict(dp=4, tp=1, failed_devices=[3], global_batch=32, wire="topk16:32"),
    "topk16-past-int32": dict(dp=70_001, tp=1, failed_devices=[0], global_batch=70_001,
                              wire="topk16:32"),
    "packed8-rescaled-4to3": dict(dp=4, tp=1, failed_devices=[3], global_batch=4,
                                  wire="packed8", keep_global_batch=False),
    "packed8-old-count-invalid": dict(dp=256, tp=1, failed_devices=list(range(200)),
                                      global_batch=256, wire="packed8"),
    "dense16-tp2": dict(dp=8, tp=2, failed_devices=[1, 2, 15], global_batch=64, wire="dense16"),
    "logged-dense8": dict(dp=8, tp=1, failed_devices=[7], global_batch=8, wire="logged:dense8"),
}


def _plan(fn, kw):
    try:
        return "ok", dataclasses.asdict(fn(**kw))
    except (RuntimeError, ValueError) as e:  # WireRangeError is a ValueError
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", sorted(PLANS))
def test_elastic_plan_matches_jax(case):
    got, want = _plan(plan_after_failures, PLANS[case]), _plan(jplan, PLANS[case])
    assert got == want


def test_elastic_plan_notes_pinned():
    """The JAX tests' own assertions, on the port."""
    plan = plan_after_failures(**PLANS["whole-tp-groups"])
    assert plan.retired_replicas == (0, 15) and plan.n_dp == 14 and plan.global_batch == 256
    assert "clip limit 7->8" in plan_after_failures(**PLANS["packed8-valid"]).note
    assert "x2 microbatches" in plan_after_failures(**PLANS["packed8-x2-microbatches"]).note
    plan = plan_after_failures(**PLANS["packed8-rescaled-4to3"])
    assert plan.n_dp == 3 and plan.global_batch == 3 and "clip limit 31->42" in plan.note


# --------------------------------------------------------------------- 2.
WIRES = ("default", "dense8", "packed8", "topk8:6")


def _images(wire, seed=3):
    """Per-worker images within the wire's clip for n = 4: two leaves."""
    lim = make_wire_format("dense32" if wire == "default" else wire).clip_limit(N)
    rng = np.random.default_rng(seed)
    return {"w": rng.integers(-lim, lim + 1, (N, 300)).astype(np.int32),
            "b": rng.integers(-lim, lim + 1, (N, 7)).astype(np.int32)}


def _jax_straggler(ints, wire):
    wf = None if wire == "default" else jwire(wire)
    ctx = JCommCtx(axes=(jcoll.WORKER_AXIS,), axis_sizes=(N,))

    def worker(t, a):
        return jsum(t, a, ctx, wf)

    s, n_live = jcoll.vmap_workers(worker, in_axes=(0, 0))(
        {k: jnp.asarray(v) for k, v in ints.items()}, jnp.asarray(ALIVE))
    return {k: np.asarray(v[0]) for k, v in s.items()}, int(n_live[0])


def _port_straggler(ints, wire, alive=ALIVE):
    wf = None if wire == "default" else make_wire_format(wire)
    trees = ({k: torch.from_numpy(v[w]) for k, v in ints.items()} for w in range(N))
    s, n_live = straggler_tolerant_sum(trees, alive, CommCtx(n_workers=N), wf)
    return {k: v.numpy() for k, v in s.items()}, n_live


@pytest.mark.parametrize("wire", WIRES)
def test_straggler_sum_matches_jax(wire):
    ints = _images(wire)
    got, n_live = _port_straggler(ints, wire)
    want, jn_live = _jax_straggler(ints, wire)
    assert n_live.dtype == torch.int32 and int(n_live) == jn_live == 3
    for k in ints:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
        if not wire.startswith("topk"):  # a top-k sum keeps the selected entries only
            np.testing.assert_array_equal(got[k], ints[k][list(ALIVE)].sum(0))
    garbage = {k: v.copy() for k, v in ints.items()}
    for k, v in _images(wire, seed=9).items():
        garbage[k][2] = v[2]  # the dead worker sends anything in range
    again, _ = _port_straggler(garbage, wire)
    for k in ints:
        np.testing.assert_array_equal(again[k], got[k])


def test_straggler_dense_packed_agree_and_alive_checked():
    ints = _images("packed8")
    dense, _ = _port_straggler(ints, "dense8")
    packed, _ = _port_straggler(ints, "packed8")
    for k in ints:
        np.testing.assert_array_equal(dense[k], packed[k])
    with pytest.raises(ValueError, match="3 flags for 4 local workers"):
        _port_straggler(ints, "packed8", alive=(True, True, False))


# --------------------------------------------------------------------- 3.
def test_decode_partial_matches_jax():
    int_sum = {"a": np.array([6, -4, 2**20 + 1], np.int32), "b": np.array([9, -7], np.int32)}
    alphas = {"a": np.float32(2.0), "b": np.float32(3.7)}
    t_sum = {k: torch.from_numpy(v) for k, v in int_sum.items()}
    j_sum = {k: jnp.asarray(v) for k, v in int_sum.items()}
    for alpha in (alphas, np.float32(2.3)):
        for n_live in (3, 1, 0):
            t_alpha = ({k: torch.tensor(v) for k, v in alpha.items()} if isinstance(alpha, dict)
                       else torch.tensor(alpha))
            j_alpha = ({k: jnp.float32(v) for k, v in alpha.items()} if isinstance(alpha, dict)
                       else jnp.float32(alpha))
            got, dead = decode_partial(t_sum, t_alpha, torch.tensor(n_live, dtype=torch.int32))
            want, jdead = jdecode_partial(j_sum, j_alpha, jnp.int32(n_live))
            assert bool(dead) == bool(jdead) == (n_live == 0)
            for k in int_sum:
                assert got[k].dtype == torch.float32
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
                assert np.all(np.isfinite(got[k].numpy()))


# --------------------------------------------------------------------- 4.
def _straggler_rank(group, rank, ints, wire):
    ctx = CommCtx.on_group(group)
    s, n_live = straggler_tolerant_sum([{k: torch.from_numpy(v[rank]) for k, v in ints.items()}],
                                       ALIVE[rank], ctx, make_wire_format(wire))
    return s, n_live


@pytest.mark.parametrize("wire", ["packed8", "dense8"])
def test_straggler_sum_on_four_gloo_ranks(wire):
    ints = _images(wire, seed=0)
    want, _ = _port_straggler(ints, wire)
    for rank, (s, n_live) in enumerate(run_ranks(_straggler_rank, N, args=(ints, wire))):
        assert int(n_live) == 3 and n_live.dtype == torch.int32, rank
        for k in ints:
            np.testing.assert_array_equal(s[k].numpy(), want[k], err_msg=f"rank {rank} {k}")


# --------------------------------------------------------------------- 5.
def _close(got, want, **kw):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), **kw)


def _jax_seeds(key, n, params):
    """JAX's SimTrainer's encode seeds for the step about to run from
    ``key``: (n, n_leaves) int32."""
    sub = jax.random.split(key)[1]
    return np.array([[int(kops.seed_from_key(k)) for k in
                      jax.tree.leaves(_leaf_keys(jax.random.fold_in(sub, w), params))]
                     for w in range(n)], np.int32)


def _jax_train(tr, st, data, steps, seeds):
    for _ in range(steps):
        if st.step > 0:
            seeds.append(_jax_seeds(st.key, tr.n, st.params))
        st, _ = tr.step(st, data)
    return st


def test_failure_recovery_end_to_end(tmp_path):
    """Train with n = 8, checkpoint, lose 2 workers, resume with n = 6 (α
    recomputed with the new n): the port and JAX side by side."""
    jprob = jmake_logreg(jax.random.PRNGKey(0), n_workers=8, m=32, d=20)
    prob = LogRegProblem.from_arrays(np.asarray(jprob.A), np.asarray(jprob.b), lam=jprob.lam)
    jdata, data = jprob.worker_data(), prob.worker_data()
    x0 = np.zeros(20, np.float32)

    def jtrainer(n):
        return JSimTrainer(jprob.worker_loss, n, JIntSGD(use_kernels=True), jsgd(),
                           jconstant(0.5))

    def trainer(n, seeds):
        return SimTrainer(prob.worker_loss, n, make_compressor("intsgd"), sgd(), constant(0.5),
                          device="cpu", seeds_fn=lambda step: seeds[step - 1])

    jseeds8, jseeds6 = [], []
    jst = _jax_train(jtrainer(8), jtrainer(8).init({"x": jnp.asarray(x0)}), jdata, 40, jseeds8)
    jstore = JCheckpointStore(str(tmp_path / "jax"), async_writes=False)
    jstore.save(40, {"params": jst.params})
    jgot, _, _ = jstore.restore({"params": {"x": jnp.asarray(x0)}})
    jdata6 = jax.tree.map(lambda x: x[:6], jdata)
    jst6 = _jax_train(jtrainer(6), jtrainer(6).init(jgot["params"]), jdata6, 60, jseeds6)

    tr8 = trainer(8, jseeds8)
    st = tr8.init({"x": torch.from_numpy(x0)})
    for _ in range(40):
        st, _ = tr8.step(st, data)
    _close(st.params["x"].numpy(), np.asarray(jst.params["x"]), err_msg="at the checkpoint")
    store = CheckpointStore(str(tmp_path / "port"), async_writes=False)
    store.save(40, {"params": st.params})
    got, _, step = store.restore({"params": {"x": torch.zeros(20)}})
    assert step == 40 and torch.equal(got["params"]["x"], st.params["x"])
    tr6 = trainer(6, jseeds6)
    st6 = tr6.init(got["params"])
    data6 = {k: v[:6] for k, v in data.items()}
    for _ in range(60):
        st6, _ = tr6.step(st6, data6)
    _close(st6.params["x"].numpy(), np.asarray(jst6.params["x"]), err_msg="after 60 at n = 6")

    def surv_loss(x):  # the objective over the surviving shards
        z = torch.einsum("wmd,d->wm", data6["A"], x) * data6["b"]
        return float(torch.mean(torch.nn.functional.softplus(-z)))

    assert surv_loss(st6.params["x"]) < surv_loss(got["params"]["x"]) + 1e-6


# --------------------------------------------------------------------- 6.
def _cfg():
    return dataclasses.replace(smoke_config(get_arch("granite-8b")), n_layers=2)


def _run(tmp_path, n, steps, *, resume=False, fused=True, compressor="intsgd8_packed",
         wire="packed8"):
    return train_loop(_cfg(), ShapeConfig("t", 16, n, "train"), n_workers=n,
                      compressor=compressor, wire=wire, steps=steps, fused=fused,
                      device="cpu", log_every=100, ckpt=CheckpointStore(str(tmp_path)),
                      ckpt_every=4, resume=resume)


def test_train_loop_elastic_resume_matches_fresh_loop(tmp_path):
    _run(tmp_path, 4, 4)  # checkpoint at step 4, written by 4 workers
    params, hist = _run(tmp_path, 3, 8, resume=True)
    assert [r["step"] for r in hist] == [4, 5, 6, 7]
    # a fresh 3-worker loop from the restored state
    cfg, n, seed = _cfg(), 3, 0
    shape = ShapeConfig("t", 16, n, "train")
    comp = make_compressor("intsgd8_packed")
    base_opt = OPTIMIZERS["sgd"]()
    art = build_train_step(cfg, shape, n_workers=n, compressor=comp, base_opt=base_opt,
                           lr_schedule=warmup_wrap(constant(0.3), 5), param_dtype=torch.float32,
                           fused=True, clip_norm=1.0, device="cpu")
    like = init_lm_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    opt_state, comp_state = build_init_state(like, n_workers=n, compressor=comp,
                                             base_opt=base_opt, fused=True)
    state, _, start = CheckpointStore(str(tmp_path)).restore(
        {"params": like, "opt": opt_state, "comp": comp_state}, step=4)
    p, o, c = state["params"], state["opt"], state["comp"]
    gen = torch.Generator().manual_seed(seed)
    n_leaves = len(art.layout.names)
    for _ in range(start):
        leaf_seeds(gen, n, n_leaves, "cpu")
    data = SyntheticLMData(cfg.vocab, 16, n, seed=seed)
    for rec in hist:
        i = rec["step"]
        p, o, c, loss, m = art.steps["compressed"](p, o, c, i, data.batch(i, 0),
                                                   leaf_seeds(gen, n, n_leaves, "cpu"))
        assert rec["loss"] == float(loss) and rec["max_int"] == float(m[0]), i
        assert 0 < rec["max_int"] <= 3 * 42  # the clip for n' = 3 on packed8
    for k, v in p.items():
        assert torch.equal(params[k], v), k


@pytest.mark.parametrize("route,leaf", [("zero1", "opt/base/embed"), ("intdiana", "comp/h_local/")])
def test_train_loop_resume_refuses_per_worker_leaves(tmp_path, route, leaf):
    kw = (dict(fused=False) if route == "zero1"
          else dict(compressor="intdiana", wire="dense8"))
    _run(tmp_path, 4, 4, **kw)
    with pytest.raises(ValueError, match=f"{leaf}.*saved by 4 workers, cannot be restored at 3"):
        _run(tmp_path, 3, 6, resume=True, **kw)
    _, hist = _run(tmp_path, 4, 5, resume=True, **kw)  # at the old count it resumes
    assert [r["step"] for r in hist] == [4]
