"""Port vs JAX: the ZeRO-1 route as a whole — four train steps of
granite-8b (smoke config) through ``build_train_step(fused=False)``.

Against the JAX package at n = 1 (``test_zero1_slice_matches_jax_four_steps``),
its ``build_train_step(fused=False)`` on the single CPU device with
``clip_norm=1.0`` and the train loop's warmup schedule, IntSGD's encode
through the counter PRNG (``use_kernels=True``), on five corners: (SGD,
IntSGD, packed8); (AdamW, IntDIANA, dense8); (SGD, IntSGD, packed8) with
two pipelined microbatches; (SGD, ``none``), the uncompressed baseline;
and (SGD, IntSGD, packed8) with bf16 params. The port gets the same
weights, ZeRO-1 and compressor state (``zero1_state_from_jax``), batches
and encode seeds (derived from the JAX step keys as the JAX step derives
them, per microbatch when there are two). Losses agree within rtol=2e-2 —
the bf16 forward rounds differently in XLA and PyTorch — and max_int within
±1.

Within the port at n = 4 (``train_loop``, the same seed on both sides):
the fused route and the ZeRO-1 route agree to rtol 1e-6 on the losses and
rtol = atol = 2e-6 on the params (the integer images are the same; only
the update's arithmetic differs: the fused kernels multiply by 1/(nα) and
take the clip factor off the summed image, ZeRO-1 divides by nα and takes
it off ĝ), for (SGD, IntSGD, packed8), (AdamW, IntSGD, dense8) and (AdamW,
IntDIANA, dense8); and dense8 and packed8 on the ZeRO-1 route agree bit for
bit, with one microbatch and with two (the same integer image, and the same
arithmetic after it).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ShapeConfig as JShape, get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.core.compressor import (  # noqa: E402
    IntDIANA as JIntDIANA, IntSGD as JIntSGD, NoCompression as JNoCompression, _leaf_keys,
)
from repro.kernels import ops as kops  # noqa: E402
from repro.launch.step import build_init_state as jbuild_init, build_train_step as jbuild  # noqa: E402
from repro.models.transformer import init_lm_params  # noqa: E402
from repro.optim import adamw as jadamw, sgd as jsgd  # noqa: E402
from repro.optim.schedules import constant as jconstant, warmup_wrap as jwarmup  # noqa: E402
from repro.parallel.collectives import mesh_from_counts  # noqa: E402
from repro.wire import DenseInt as JDenseInt, PackedInt as JPackedInt  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.launch.step import build_init_state, build_train_step  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.transformer import params_from_jax, zero1_state_from_jax  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.optim.schedules import constant, warmup_wrap  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

STEPS, SEQ, BATCH = 4, 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The port's smoke-size steps on one intra-op thread: at these sizes
    more threads only spin, and under a parallel test run they contend for
    the cores (both sides of every bit-equality here run alike)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (BATCH, SEQ))
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        out.append((toks, labels))
    return out


def _corner(opt, comp, wire):
    """-> (JAX optimizer, JAX compressor, port optimizer, port compressor, lr)."""
    if comp == "none":
        jcomp, tcomp = JNoCompression(), make_compressor("none")
    else:
        jwire = {"packed8": JPackedInt, "dense8": JDenseInt}[wire](8, use_kernels=True)
        if comp == "intsgd":
            jcomp = JIntSGD(bits=8, wire=jwire, use_kernels=True)
            tcomp = make_compressor({"packed8": "intsgd8_packed", "dense8": "intsgd8"}[wire])
        else:
            jcomp = JIntDIANA(bits=8, wire=jwire)
            tcomp = make_compressor("intdiana", bits=8, wire=wire)
    if opt == "sgd":
        return jsgd(momentum=0.9, weight_decay=1e-4), jcomp, sgd(momentum=0.9, weight_decay=1e-4), tcomp, 0.3
    return jadamw(weight_decay=1e-4), jcomp, adamw(weight_decay=1e-4), tcomp, 3e-4


def _jax_run(batches, jo, jcomp, lr, micro, jdt):
    cfg = jsmoke(jget_arch("granite-8b"))
    mesh = mesh_from_counts(data=1, model=1)
    art = jbuild(
        cfg, mesh, JShape("slice", SEQ, BATCH, "train"), compressor=jcomp, base_opt=jo,
        lr_schedule=jwarmup(jconstant(lr), 5), param_dtype=jdt, fused=False,
        clip_norm=1.0, microbatches=micro,
    )
    key = jax.random.PRNGKey(0)
    params = init_lm_params(key, cfg, tp=1, n_shards=1, dtype=jdt)
    params0 = jax.tree.map(np.asarray, params)
    opt_state, comp_state = jbuild_init(cfg, mesh, compressor=jcomp, base_opt=jo, fused=False)(params)
    opt0, comp0 = jax.tree.map(np.asarray, opt_state), jax.tree.map(np.asarray, comp_state)
    losses, max_ints, bits, seeds = [], [], [], []
    for i, (toks, labels) in enumerate(batches):
        k = jax.random.fold_in(key, i)
        akey = jax.random.fold_in(k, 1)
        # the encode keys: microbatch m's fold_in(akey, m) when pipelined,
        # then the worker index (0), then one split per leaf in tree order
        mkeys = [jax.random.fold_in(akey, m) for m in range(micro)] if micro > 1 else [akey]
        seeds.append([[int(kops.seed_from_key(s)) for s in
                       jax.tree.leaves(_leaf_keys(jax.random.fold_in(mk, 0), params0))]
                      for mk in mkeys])
        fn = art.jitted["exact"] if i == 0 else art.jitted["compressed"]
        batch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, jnp.int32(i), k, batch
        )
        losses.append(float(loss))
        max_ints.append(float(metrics[0]))
        bits.append(float(metrics[1]))
    return params0, opt0, comp0, losses, max_ints, bits, seeds


def _check_corner(opt, comp, wire, micro=1, param_dtype="float32"):
    batches = _batches()
    jo, jcomp, to, tcomp, lr = _corner(opt, comp, wire)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    params0, opt0, comp0, jlosses, jmax, jbits, jseeds = _jax_run(batches, jo, jcomp, lr, micro, jdt)

    cfg = smoke_config(get_arch("granite-8b"))
    art = build_train_step(
        cfg, ShapeConfig("slice", SEQ, BATCH, "train"), n_workers=1, compressor=tcomp,
        base_opt=to, lr_schedule=warmup_wrap(constant(lr), 5), param_dtype=tdt,
        clip_norm=1.0, microbatches=micro, device="cpu",
    )
    params = params_from_jax(params0, "cpu")
    assert all(p.dtype == tdt for p in params.values())
    opt_state, comp_state = zero1_state_from_jax(opt0, comp0, "cpu")
    # JAX's init state is the port's: masters equal to the params, zeros
    want_opt, want_comp = build_init_state(params, n_workers=1, compressor=tcomp, base_opt=to)
    got_l, want_l = jax.tree.leaves(opt_state), jax.tree.leaves(want_opt)
    assert len(got_l) == len(want_l) and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got_l, want_l))
    if comp == "none":
        assert comp_state == () == want_comp
    losses, max_ints, bits = [], [], []
    for i, (toks, labels) in enumerate(batches):
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
        seeds = torch.tensor(jseeds[i], dtype=torch.int32)  # (n_workers = 1, n_leaves)
        if micro > 1:
            seeds = seeds[:, None]  # (M, n_workers = 1, n_leaves)
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, batch, seeds
        )
        losses.append(loss.item())
        max_ints.append(metrics[0].item())
        bits.append(metrics[1].item())

    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    assert all(abs(a - b) <= 1 for a, b in zip(max_ints, jmax)), (max_ints, jmax)
    assert all(p.dtype == tdt and torch.isfinite(p).all() for p in params.values())
    assert all(m.dtype == torch.float32 for m in opt_state["master"].values())
    if comp == "none":
        assert max_ints == [0.0] * STEPS and bits[1:] == jbits[1:] == [32.0] * (STEPS - 1)
    else:
        # the clip for the n·M sum: 127 // M at n = 1
        assert max_ints[0] == 0 and all(0 < v <= 127 // micro for v in max_ints[1:])
    if opt == "adamw":
        assert int(opt_state["base"]["count"]) == STEPS
    if comp == "intdiana":  # the shift moved off zero
        assert any(bool(v.any()) for v in comp_state["h_global"].values())
    # the masters and the params agree: the params are the gathered masters
    for k, p in params.items():
        assert torch.equal(p, opt_state["master"][k].reshape(-1)[:p.numel()].to(tdt).reshape(p.shape))


@pytest.mark.parametrize("opt,comp,wire,micro,param_dtype", [
    ("sgd", "intsgd", "packed8", 1, "float32"),
    ("adamw", "intdiana", "dense8", 1, "float32"),
    ("sgd", "intsgd", "packed8", 2, "float32"),
    ("sgd", "none", None, 1, "float32"),
    ("sgd", "intsgd", "packed8", 1, "bfloat16"),
])
def test_zero1_slice_matches_jax_four_steps(opt, comp, wire, micro, param_dtype):
    _check_corner(opt, comp, wire, micro, param_dtype)


def _port_run(*, fused, opt, compressor, wire, micro=1, steps=STEPS):
    cfg = smoke_config(get_arch("granite-8b"))
    shape = ShapeConfig("route", SEQ, 4 * micro, "train")
    return train_loop(
        cfg, shape, n_workers=4, compressor=compressor, wire=wire, steps=steps,
        lr=0.3 if opt == "sgd" else 3e-4, log_every=100, seed=3, fused=fused,
        microbatches=micro, opt=opt, device="cpu",
    )


@pytest.fixture(scope="module")
def port_run():
    """``_port_run`` with each distinct run made once per module: the
    ZeRO-1 SGD/packed8 run at one microbatch serves two tests."""
    done = {}

    def run(*, fused, opt, compressor, wire, micro=1):
        key = (fused, opt, compressor, wire, micro)
        if key not in done:
            done[key] = _port_run(fused=fused, opt=opt, compressor=compressor, wire=wire,
                                  micro=micro)
        return done[key]

    return run


@pytest.mark.parametrize("opt,compressor,wire", [
    ("sgd", "intsgd8_packed", "packed8"),
    ("adamw", "intsgd8", "dense8"),
    ("adamw", "intdiana", "dense8"),
])
def test_fused_route_matches_zero1_n4(port_run, opt, compressor, wire):
    p_ref, h_ref = port_run(fused=False, opt=opt, compressor=compressor, wire=wire)
    p_fus, h_fus = port_run(fused=True, opt=opt, compressor=compressor, wire=wire)
    np.testing.assert_allclose([r["loss"] for r in h_fus], [r["loss"] for r in h_ref], rtol=1e-6)
    assert [r["max_int"] for r in h_fus] == [r["max_int"] for r in h_ref]
    assert h_ref[-1]["max_int"] > 0
    for k in p_ref:
        np.testing.assert_allclose(p_fus[k].numpy(), p_ref[k].numpy(), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("micro", [1, 2])
def test_packed_wire_matches_dense_on_zero1_n4(port_run, micro):
    p_d, h_d = port_run(fused=False, opt="sgd", compressor="intsgd8", wire="dense8", micro=micro)
    p_p, h_p = port_run(fused=False, opt="sgd", compressor="intsgd8_packed", wire="packed8",
                        micro=micro)
    strip = lambda h: [{k: v for k, v in r.items() if k != "ms"} for r in h]
    assert strip(h_d) == strip(h_p)
    assert all(torch.equal(p_d[k], p_p[k]) for k in p_d)
    assert h_p[-1]["max_int"] > 0
