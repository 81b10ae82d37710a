"""Port vs JAX: one exact and one compressed train step of the new dense
configs (smoke widths, 2 layers) through both packages'
``build_train_step`` at n = 1, f32 params, SGD (0.9, 1e-4), IntSGD on
packed8 with the counter PRNG (``use_kernels=True``), clip 1.0, the train
loop's warmup schedule:

  * qwen2.5-32b on the fused route (its QKV bias leaves through the fused
    plain versions);
  * h2o-danube-3-4b on ZeRO-1 at T = 160, past its smoke window (64);
  * internvl2-2b on ZeRO-1 with patch embeddings (8 patches + 24 text).

The two packages' bf16 forwards round differently, so what reaches the
encode is made the same: JAX's gradients are taken inside its jitted step
(``jax.debug.callback`` around its ``_forward_backward``) and handed to the
port's step in place of its own, and the port starts step 1 from JAX's
state after step 0. Given JAX's encode seeds, the port's integer images
and max_int are then bit-equal to JAX's (its images taken the same way
around ``IntSGD.encode_ints``), and its params after each step within
rtol = atol = 2e-6 (the update's arithmetic; the clip factor sums in
another order). The port's own loss and gradients from the same params
and batch are held to JAX's at the bf16 tolerance of the other slice tests
(losses rtol 2e-2).

Within the port: the vlm batch's ``patch_embeds`` is sliced per worker and
per microbatch (n = 2, M = 2 on ZeRO-1, and n = 2 on the fused route), the
step's loss equal to the mean of the slices' losses.
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
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim.schedules import constant as jconstant, warmup_wrap as jwarmup  # noqa: E402
from repro.parallel.collectives import mesh_from_counts  # noqa: E402
from repro.wire import PackedInt as JPackedInt  # noqa: E402
import repro_torch.launch.step as tstep  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import IntSGD, make_compressor  # noqa: E402
from repro_torch.launch.inputs import materialize_batch  # noqa: E402
from repro_torch.launch.step import build_init_state, build_train_step  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    comp_state_from_jax, lm_loss, opt_state_from_jax, params_from_jax, zero1_state_from_jax,
)
from repro_torch.optim.schedules import constant, warmup_wrap  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

LR, BATCH = 0.3, 2
# name -> (fused, sequence length: text, plus the patches for internvl)
CASES = {
    "qwen2.5-32b": (True, 32),
    "h2o-danube-3-4b": (False, 160),
    "internvl2-2b": (False, 32),
}


def _cfgs(name):
    return (dataclasses.replace(smoke_config(get_arch(name)), n_layers=2),
            dataclasses.replace(jsmoke(jget_arch(name)), n_layers=2))


def _batches(cfg, seq):
    rng = np.random.default_rng(11)
    t_text = seq - cfg.n_frontend_tokens if cfg.frontend == "vit" else seq
    out = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, (BATCH, t_text))
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        b = {"tokens": toks, "labels": labels}
        if cfg.frontend == "vit":
            pe = rng.standard_normal((BATCH, cfg.n_frontend_tokens, cfg.frontend_dim), np.float32)
            b["patch_embeds"] = pe
        out.append(b)
    return out


def _jbatch(b):
    return {k: jnp.asarray(v, jnp.int32) if v.dtype.kind == "i" else
            jnp.asarray(v).astype(jnp.bfloat16) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) if v.dtype.kind == "i" else
            torch.from_numpy(v).to(torch.bfloat16) for k, v in b.items()}


def _host(tree):
    return jax.tree.map(np.array, tree)


def _flat(tree):
    return {"/".join(p.key for p in path): np.array(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_run(monkeypatch, jcfg, seq, batches, fused):
    """Steps 0 and 1 of the JAX package, its state before each and the
    gradients, images and metrics each step saw."""
    grads, images = [], []
    fb, enc = jstep._forward_backward, JIntSGD.encode_ints

    def spy_fb(layout, loss_fn, params, batch):
        loss, g = fb(layout, loss_fn, params, batch)
        jax.debug.callback(lambda t: grads.append(_flat(t)), g)
        return loss, g

    def spy_enc(self, *a, **kw):
        ints, alphas = enc(self, *a, **kw)
        jax.debug.callback(lambda t: images.append(_flat(t)), ints)
        return ints, alphas

    monkeypatch.setattr(jstep, "_forward_backward", spy_fb)
    monkeypatch.setattr(JIntSGD, "encode_ints", spy_enc)
    comp = JIntSGD(bits=8, wire=JPackedInt(8, use_kernels=True), use_kernels=True)
    opt = jsgd(momentum=0.9, weight_decay=1e-4)
    mesh = mesh_from_counts(data=1, model=1)
    art = jstep.build_train_step(
        jcfg, mesh, JShape("dense", seq, BATCH, "train"), compressor=comp, base_opt=opt,
        lr_schedule=jwarmup(jconstant(LR), 5), param_dtype=jnp.float32, fused=fused,
        clip_norm=1.0, donate=False,
    )
    key = jax.random.PRNGKey(0)
    params = init_lm_params(key, jcfg, tp=1, n_shards=1, dtype=jnp.float32)
    opt_state, comp_state = jstep.build_init_state(
        jcfg, mesh, compressor=comp, base_opt=opt, fused=fused)(params)
    states, outs, seeds = [], [], []
    for i, b in enumerate(batches):
        states.append(_host((params, opt_state, comp_state)))
        k = jax.random.fold_in(key, i)
        wkey = jax.random.fold_in(jax.random.fold_in(k, 1), 0)
        seeds.append([int(kops.seed_from_key(s)) for s in jax.tree.leaves(
            _leaf_keys(wkey, states[-1][0]))])
        fn = art.jitted["exact"] if i == 0 else art.jitted["compressed"]
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, jnp.int32(i), k, _jbatch(b))
        jax.effects_barrier()
        outs.append((float(loss), float(metrics[0]), _flat(params)))
    assert len(grads) == 2 and len(images) == 1
    return states, outs, seeds, grads, images[0]


def _port_state(states, fused):
    params0, opt0, comp0 = states
    params = params_from_jax(params0, "cpu")
    if fused:
        return params, opt_state_from_jax(opt0, "cpu"), comp_state_from_jax(comp0, "cpu")
    opt_state, comp_state = zero1_state_from_jax(opt0, comp0, "cpu")
    return params, opt_state, comp_state


@pytest.mark.parametrize("name", list(CASES))
def test_dense_step_matches_jax(monkeypatch, name):
    fused, seq = CASES[name]
    cfg, jcfg = _cfgs(name)
    batches = _batches(cfg, seq)
    states, jouts, jseeds, jgrads, jimages = _jax_run(monkeypatch, jcfg, seq, batches, fused)

    art = build_train_step(
        cfg, ShapeConfig("dense", seq, BATCH, "train"), n_workers=1,
        compressor=make_compressor("intsgd8_packed"), base_opt=sgd(momentum=0.9, weight_decay=1e-4),
        lr_schedule=warmup_wrap(constant(LR), 5), param_dtype=torch.float32, fused=fused,
        clip_norm=1.0, device="cpu",
    )
    # the port's own loss and gradients, then JAX's gradients handed on
    own, images = [], []
    fb, enc = tstep._forward_backward, IntSGD.encode_ints

    def handed(layout, params, batch):
        loss, grads = fb(layout, params, batch)
        own.append((loss.item(), grads))
        want = jgrads[len(own) - 1]
        return loss, {k: torch.from_numpy(want[k]) for k in grads}

    def spy_enc(self, *a, **kw):
        ints, alphas = enc(self, *a, **kw)
        images.append({k: v.clone() for k, v in ints.items()})
        return ints, alphas

    monkeypatch.setattr(tstep, "_forward_backward", handed)
    monkeypatch.setattr(IntSGD, "encode_ints", spy_enc)
    for i, b in enumerate(batches):
        params, opt_state, comp_state = _port_state(states[i], fused)
        if i == 0:  # JAX's init state is the port's
            want_opt, want_comp = build_init_state(
                params, n_workers=1, compressor=make_compressor("intsgd8_packed"),
                base_opt=sgd(momentum=0.9, weight_decay=1e-4), fused=fused)
            got_l, want_l = jax.tree.leaves(opt_state), jax.tree.leaves(want_opt)
            assert len(got_l) == len(want_l) and all(
                torch.equal(g, w) for g, w in zip(got_l, want_l))
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        seeds = torch.tensor([jseeds[i]], dtype=torch.int32)
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, _tbatch(b), seeds)
        jloss, jmax, jparams = jouts[i]
        np.testing.assert_allclose(loss.item(), jloss, rtol=2e-2)
        assert metrics[0].item() == jmax
        if i == 1:
            assert metrics[3].item() == jmax  # n = 1: the worker's image is the sum
        assert set(params) == set(jparams)
        for k, p in params.items():
            np.testing.assert_allclose(p.numpy(), jparams[k], rtol=2e-6, atol=2e-6, err_msg=k)

    # step 1's integer images, leaf for leaf, bit for bit
    assert len(images) == 1 and set(images[0]) == set(jimages)
    for k, v in images[0].items():
        assert v.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), jimages[k], err_msg=k)
    assert 0 < jouts[1][1] <= 127
    new = {"qwen2.5-32b": "layers/attn/bq", "internvl2-2b": "frontend_proj"}.get(name)
    if new is not None:  # the new leaf carried a nonzero image
        assert bool(np.any(jimages[new] != 0))
    # the port's own bf16 gradients against JAX's: relative L2 over the tree
    for (_, g), jg in zip(own, jgrads):
        num = sum(float(torch.sum((g[k].double() - torch.from_numpy(jg[k]).double()) ** 2))
                  for k in g)
        den = sum(float(np.sum(jg[k].astype(np.float64) ** 2)) for k in g)
        assert (num / den) ** 0.5 < 3e-2


@pytest.mark.parametrize("fused,micro", [(False, 2), (True, 1)])
def test_vlm_batch_splits_per_worker_and_microbatch(fused, micro):
    cfg = dataclasses.replace(smoke_config(get_arch("internvl2-2b")), n_layers=2)
    n = 2
    shape = ShapeConfig("vlm", cfg.n_frontend_tokens + 16, n * micro * 2, "train")
    art = build_train_step(
        cfg, shape, n_workers=n, compressor=make_compressor("intsgd8_packed"),
        base_opt=sgd(momentum=0.9, weight_decay=1e-4), lr_schedule=constant(0.1),
        param_dtype=torch.float32, fused=fused, clip_norm=1.0, microbatches=micro,
        device="cpu",
    )
    from repro_torch.models.transformer import init_lm_params as tinit

    params = tinit(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = materialize_batch(cfg, shape, torch.Generator().manual_seed(1), "cpu")
    assert batch["patch_embeds"].shape == (n * micro * 2, 8, 32)
    opt_state, comp_state = build_init_state(
        params, n_workers=n, compressor=make_compressor("intsgd8_packed"),
        base_opt=sgd(momentum=0.9, weight_decay=1e-4), fused=fused)
    want = []
    for w in range(n):
        local = tstep._microbatch(batch, w, n)
        assert local["patch_embeds"].shape[0] == local["tokens"].shape[0] == micro * 2
        for m in range(micro):
            mb = tstep._microbatch(local, m, micro)
            assert torch.equal(mb["patch_embeds"], batch["patch_embeds"][(w * micro + m) * 2:
                                                                        (w * micro + m + 1) * 2])
            want.append(lm_loss(params, mb, cfg).item())
    seeds = torch.arange(n * len(params), dtype=torch.int32).reshape(n, -1)
    if micro > 1:
        seeds = torch.stack([seeds, seeds + 1000])
    for i in range(2):
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        new_params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, batch, seeds)
        if i == 0:
            np.testing.assert_allclose(loss.item(), np.mean(want), rtol=1e-6)
        params = new_params
        assert np.isfinite(loss.item())
    assert 0 < metrics[0].item() <= n * 127 // micro
