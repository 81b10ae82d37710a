"""Port vs JAX: one exact and one compressed train step of the hybrid
family, zamba2-2.7b at smoke widths (4 Mamba2 layers in two blocks of 2,
the shared attention block after each), through both packages'
``build_train_step`` at n = 1, IntSGD on packed8 with the counter PRNG
(``use_kernels=True``), clip 1.0, the train loop's warmup schedule:

  * on the fused route, SGD (0.9, 1e-4), lr 0.3;
  * on ZeRO-1, AdamW (wd 1e-4), lr 3e-4.

As in ``tests/test_torch_slice_moe.py``, in float32: JAX's gradients,
taken inside its jitted step, are handed to the port's step in place of
its own, and the port starts step 1 from JAX's state after step 0. Given
JAX's encode seeds, the integer images (the tiny per-head leaves such as
``layers/m/a_log`` and the shared block's ``shared_attn/w_in`` among them)
and max_int are bit-equal to JAX's, the params within rtol = atol = 2e-6
after each step. The port's own bf16-activation gradients from the same
params and batch are held to JAX's at the other slice tests' bf16
tolerance (relative L2 over the tree < 3e-2).

With bf16 params (the step's default; one block of 2 layers) every leaf
stays bf16 after each step on both routes, as JAX's does, within one bf16
ULP of JAX's (XLA contracts the update's FMAs); given JAX's bf16 gradients
and state, step 1's images are bit-equal to JAX's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.step as jstep  # noqa: E402
from repro.configs import ShapeConfig as JShape, get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.core.compressor import IntSGD as JIntSGD, _leaf_keys  # noqa: E402
from repro.kernels import ops as kops  # noqa: E402
from repro.models.transformer import init_lm_params  # noqa: E402
from repro.optim import adamw as jadamw, sgd as jsgd  # noqa: E402
from repro.optim.schedules import constant as jconstant, warmup_wrap as jwarmup  # noqa: E402
from repro.parallel.collectives import mesh_from_counts  # noqa: E402
from repro.wire import PackedInt as JPackedInt  # noqa: E402
import repro_torch.launch.step as tstep  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import IntSGD, make_compressor  # noqa: E402
from repro_torch.launch.step import build_init_state, build_train_step  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    comp_state_from_jax, opt_state_from_jax, params_from_jax, zero1_state_from_jax,
)
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.optim.schedules import constant, warmup_wrap  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

NAME = "zamba2-2.7b"
BATCH, SEQ = 2, 32
# route -> (fused, optimizer, lr)
CASES = {
    "fused-sgd": (True, "sgd", 0.3),
    "zero1-adamw": (False, "adamw", 3e-4),
}
JAX_OPT = {"sgd": lambda: jsgd(momentum=0.9, weight_decay=1e-4),
           "adamw": lambda: jadamw(weight_decay=1e-4)}
OPT = {"sgd": lambda: sgd(momentum=0.9, weight_decay=1e-4),
       "adamw": lambda: adamw(weight_decay=1e-4)}
# the leaves new to the step: a tiny per-head leaf and the shared block's
NEW_LEAVES = ("layers/m/a_log", "layers/m/dt_bias", "layers/m/conv_w", "shared_attn/w_in",
              "shared_attn/attn/wq")


def _cfgs(layers):
    return (dataclasses.replace(smoke_config(get_arch(NAME)), n_layers=layers),
            dataclasses.replace(jsmoke(jget_arch(NAME)), n_layers=layers))


def _batches(cfg):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, (BATCH, SEQ))
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        out.append({"tokens": toks, "labels": labels})
    return out


def _flat(tree):
    return {"/".join(p.key for p in path): np.array(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _f32(tree):
    """numpy leaves as float32 (numpy has no bf16 arithmetic)."""
    return {k: v.astype(np.float32) for k, v in tree.items()}


def _jax_batch(b):
    """A numpy batch as the JAX step takes it: ids int32, float leaves (an
    encoder-decoder's frames) bf16, as ``input_specs`` declares them."""
    return {k: jnp.asarray(v, jnp.bfloat16 if np.issubdtype(v.dtype, np.floating) else jnp.int32)
            for k, v in b.items()}


def _jax_run(monkeypatch, jcfg, batches, fused, opt, lr, param_dtype, init=init_lm_params):
    """Steps 0 and 1 of the JAX package from ``init``'s params: its state
    before each step, the outputs, the encode seeds, the gradients each
    step saw and step 1's images."""
    grads, images = [], []
    fb, enc = jstep._forward_backward, JIntSGD.encode_ints

    def spy_fb(layout, loss_fn, params, batch):
        loss, g = fb(layout, loss_fn, params, batch)
        jax.debug.callback(lambda t: grads.append(_flat(t)), g)
        return loss, g

    def spy_enc(self, state, g, **kw):
        ints, alphas = enc(self, state, g, **kw)
        jax.debug.callback(lambda t: images.append(_flat(t)), ints)
        return ints, alphas

    monkeypatch.setattr(jstep, "_forward_backward", spy_fb)
    monkeypatch.setattr(JIntSGD, "encode_ints", spy_enc)
    comp = JIntSGD(bits=8, wire=JPackedInt(8, use_kernels=True), use_kernels=True)
    base_opt = JAX_OPT[opt]()
    mesh = mesh_from_counts(data=1, model=1)
    art = jstep.build_train_step(
        jcfg, mesh, JShape("hybrid", SEQ, BATCH, "train"), compressor=comp, base_opt=base_opt,
        lr_schedule=jwarmup(jconstant(lr), 5), param_dtype=param_dtype, fused=fused,
        clip_norm=1.0, donate=False,
    )
    key = jax.random.PRNGKey(0)
    params = init(key, jcfg, tp=1, n_shards=1, dtype=param_dtype)
    opt_state, comp_state = jstep.build_init_state(
        jcfg, mesh, compressor=comp, base_opt=base_opt, fused=fused)(params)
    states, outs, seeds = [], [], []
    for i, b in enumerate(batches):
        states.append(jax.tree.map(np.array, (params, opt_state, comp_state)))
        k = jax.random.fold_in(key, i)
        wkey = jax.random.fold_in(jax.random.fold_in(k, 1), 0)
        seeds.append([int(kops.seed_from_key(s)) for s in jax.tree.leaves(
            _leaf_keys(wkey, states[-1][0]))])
        fn = art.jitted["exact"] if i == 0 else art.jitted["compressed"]
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, jnp.int32(i), k, _jax_batch(b))
        jax.effects_barrier()
        outs.append((float(loss), float(metrics[0]), _flat(params)))
    assert len(grads) == 2 and len(images) == 1
    return states, outs, seeds, grads, images[0]


def _port_step(cfg, fused, opt, lr, param_dtype):
    return build_train_step(
        cfg, ShapeConfig("hybrid", SEQ, BATCH, "train"), n_workers=1,
        compressor=make_compressor("intsgd8_packed"), base_opt=OPT[opt](),
        lr_schedule=warmup_wrap(constant(lr), 5), param_dtype=param_dtype, fused=fused,
        clip_norm=1.0, device="cpu",
    )


def _port_state(states, fused):
    params0, opt0, comp0 = states
    params = params_from_jax(params0, "cpu")
    if fused:
        return params, opt_state_from_jax(opt0, "cpu"), comp_state_from_jax(comp0, "cpu")
    opt_state, comp_state = zero1_state_from_jax(opt0, comp0, "cpu")
    return params, opt_state, comp_state


def _hand_in(monkeypatch, jgrads, step, own=None):
    """The port's step takes JAX's gradients of step ``step[0]`` in place
    of its own (kept in ``own`` when given); returns the list that
    collects the port's images."""
    images = []
    fb, enc = tstep._forward_backward, IntSGD.encode_ints

    def handed(layout, params, batch):
        loss, grads = fb(layout, params, batch)
        if own is not None:
            own.append((loss, grads))
        return loss, {k: torch.from_numpy(jgrads[step[0]][k]).to(grads[k].dtype)
                      for k in grads}

    def spy_enc(self, *a, **kw):
        ints, alphas = enc(self, *a, **kw)
        images.append({k: v.clone() for k, v in ints.items()})
        return ints, alphas

    monkeypatch.setattr(tstep, "_forward_backward", handed)
    monkeypatch.setattr(IntSGD, "encode_ints", spy_enc)
    return images


def _assert_images_equal(images, jimages):
    assert len(images) == 1 and set(images[0]) == set(jimages)
    for k, v in images[0].items():
        assert v.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), jimages[k], err_msg=k)


@pytest.mark.parametrize("route", list(CASES))
def test_hybrid_step_matches_jax(monkeypatch, route):
    fused, opt, lr = CASES[route]
    cfg, jcfg = _cfgs(4)
    batches = _batches(cfg)
    states, jouts, jseeds, jgrads, jimages = _jax_run(
        monkeypatch, jcfg, batches, fused, opt, lr, jnp.float32)
    art = _port_step(cfg, fused, opt, lr, torch.float32)
    step, own = [0], []
    images = _hand_in(monkeypatch, jgrads, step, own)
    for i, b in enumerate(batches):
        params, opt_state, comp_state = _port_state(states[i], fused)
        if i == 0:  # JAX's init state is the port's
            want_opt, _ = build_init_state(
                params, n_workers=1, compressor=make_compressor("intsgd8_packed"),
                base_opt=OPT[opt](), fused=fused)
            got_l, want_l = jax.tree.leaves(opt_state), jax.tree.leaves(want_opt)
            assert len(got_l) == len(want_l) and all(
                torch.equal(g, w) for g, w in zip(got_l, want_l))
        step[0] = i
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, {k: torch.from_numpy(v) for k, v in b.items()},
            torch.tensor([jseeds[i]], dtype=torch.int32))
        jloss, jmax, jparams = jouts[i]
        np.testing.assert_allclose(loss.item(), jloss, rtol=2e-2)
        assert metrics[0].item() == jmax
        assert set(params) == set(jparams) and len(params) == 23
        for k, p in params.items():
            assert tuple(p.shape) == jparams[k].shape, k
            np.testing.assert_allclose(p.numpy(), jparams[k], rtol=2e-6, atol=2e-6, err_msg=k)

    # step 1's integer images, leaf for leaf, bit for bit
    _assert_images_equal(images, jimages)
    assert 0 < jouts[1][1] <= 127
    if opt == "sgd":  # at lr 0.3 the new leaves carried a nonzero image
        for k in NEW_LEAVES:
            assert bool(np.any(jimages[k] != 0)), k
    # the port's own bf16-activation gradients against JAX's
    for (_, g), jg in zip(own, jgrads):
        num = sum(float(torch.sum((g[k].double() - torch.from_numpy(jg[k]).double()) ** 2))
                  for k in g)
        den = sum(float(np.sum(jg[k].astype(np.float64) ** 2)) for k in g)
        assert (num / den) ** 0.5 < 3e-2


@pytest.mark.parametrize("route", list(CASES))
def test_hybrid_step_with_bf16_params_matches_jax(monkeypatch, route):
    fused, opt, lr = CASES[route]
    cfg, jcfg = _cfgs(2)
    batches = _batches(cfg)
    states, jouts, jseeds, jgrads, jimages = _jax_run(
        monkeypatch, jcfg, batches, fused, opt, lr, jnp.bfloat16)
    assert {str(v.dtype) for v in jax.tree.leaves(states[0][0])} == {"bfloat16"}
    art = _port_step(cfg, fused, opt, lr, torch.bfloat16)
    step = [0]
    images = _hand_in(monkeypatch, [_f32(g) for g in jgrads], step)
    for i, b in enumerate(batches):
        params, opt_state, comp_state = _port_state(states[i], fused)
        assert {str(v.dtype) for v in params.values()} == {"torch.bfloat16"}
        step[0] = i
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, {k: torch.from_numpy(v) for k, v in b.items()},
            torch.tensor([jseeds[i]], dtype=torch.int32))
        jloss, jmax, jparams = jouts[i]
        assert np.isfinite(loss.item())
        np.testing.assert_allclose(loss.item(), jloss, rtol=2e-2)
        assert metrics[0].item() == jmax
        # every leaf stays bf16, as JAX's, within one bf16 ULP of JAX's
        assert {str(v.dtype) for v in params.values()} == {"torch.bfloat16"}
        assert {str(v.dtype) for v in jparams.values()} == {"bfloat16"}
        for k, p in params.items():
            np.testing.assert_allclose(p.float().numpy(), jparams[k].astype(np.float32),
                                       rtol=2.0**-7, atol=0, err_msg=k)
    _assert_images_equal(images, jimages)
