"""Port vs JAX: one exact and one compressed train step of the encdec
family, seamless-m4t-medium at smoke widths (2 encoder and 2 decoder
layers, d_model 64, frontend_dim 32: 37 leaves, ``lm_head`` untied),
through both packages' ``build_train_step`` at n = 1, IntSGD on packed8
with the counter PRNG (``use_kernels=True``), clip 1.0, the train loop's
warmup schedule:

  * on the fused route, SGD (0.9, 1e-4), lr 0.3;
  * on ZeRO-1, AdamW (wd 1e-4), lr 3e-4.

The pattern and helpers of ``tests/test_torch_slice_hybrid.py``: the
batch carries frames (B, T, frontend_dim) in bf16 to both steps (the JAX
step as ``input_specs`` declares them, not cast to int32), target tokens
and labels (B, T). In float32, JAX's gradients, taken inside its jitted
step, are handed to the port's step in place of its own, and the port
starts step 1 from JAX's state after step 0. Given JAX's encode seeds, the
37 leaves' integer images (from the 256 × 64 ``embed`` and ``lm_head`` to
the LayerNorms' 64-entry shifts) and max_int are bit-equal to JAX's, the
params within rtol = atol = 2e-6 after each step. The port's own
bf16-activation gradients from the same params and batch are held to
JAX's at the slices' bf16 tolerance (relative L2 over the tree < 3e-2).

With bf16 params (the step's default) every leaf stays bf16 after each
step on both routes, as JAX's does, within one bf16 ULP of JAX's; given
JAX's bf16 gradients and state, step 1's images are bit-equal to JAX's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models.encdec import init_encdec_params  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.launch.step import build_init_state  # noqa: E402
from test_torch_slice_hybrid import (  # noqa: E402
    BATCH, CASES, OPT, SEQ, _assert_images_equal, _f32, _hand_in, _jax_run, _port_state,
    _port_step,
)

NAME = "seamless-m4t-medium"
N_LEAVES = 37
# leaves new to the step: the frontend stub, the cross attention, a
# LayerNorm's shift, the GELU MLP's biases and the untied head
NEW_LEAVES = ("frontend_proj", "dec_layers/cross_attn/wk", "enc_layers/ln1/b",
              "dec_layers/mlp/b_in", "enc_layers/mlp/b_out", "lm_head")


def _cfgs():
    cfg, jcfg = smoke_config(get_arch(NAME)), jsmoke(jget_arch(NAME))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.enc_layers, cfg.dec_layers, cfg.frontend) == (2, 2, "audio")
    return cfg, jcfg


def _batches(cfg):
    """Two batches: frames standard normal, rounded to bf16 values (float32
    numpy, which has no bf16), tokens and next-token labels."""
    rng = np.random.default_rng(13)
    out = []
    for _ in range(2):
        frames = rng.standard_normal((BATCH, SEQ, cfg.frontend_dim)).astype(np.float32)
        frames = np.array(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32))
        toks = rng.integers(0, cfg.vocab, (BATCH, SEQ))
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        out.append({"frames": frames, "tokens": toks, "labels": labels})
    return out


def _port_batch(b):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if k == "frames" else torch.from_numpy(v)
            for k, v in b.items()}


def _steps(monkeypatch, route, param_dtype):
    """Both packages' steps 0 and 1 from JAX's states; returns each step's
    outputs beside JAX's, the port's step-1 images, JAX's, and JAX's and
    the port's own gradients."""
    fused, opt, lr = CASES[route]
    cfg, jcfg = _cfgs()
    batches = _batches(cfg)
    jdt = jnp.float32 if param_dtype == torch.float32 else jnp.bfloat16
    states, jouts, jseeds, jgrads, jimages = _jax_run(
        monkeypatch, jcfg, batches, fused, opt, lr, jdt, init=init_encdec_params)
    assert "lm_head" in states[0][0]
    art = _port_step(cfg, fused, opt, lr, param_dtype)
    assert len(art.layout.names) == N_LEAVES
    step, own = [0], []
    images = _hand_in(monkeypatch, [_f32(g) for g in jgrads], step, own)
    outs = []
    for i, b in enumerate(batches):
        params, opt_state, comp_state = _port_state(states[i], fused)
        assert {v.dtype for v in params.values()} == {param_dtype}
        if i == 0 and param_dtype == torch.float32:  # JAX's init state is the port's
            want_opt, _ = build_init_state(
                params, n_workers=1, compressor=make_compressor("intsgd8_packed"),
                base_opt=OPT[opt](), fused=fused)
            got_l, want_l = jax.tree.leaves(opt_state), jax.tree.leaves(want_opt)
            assert len(got_l) == len(want_l) and all(
                torch.equal(g, w) for g, w in zip(got_l, want_l))
        step[0] = i
        batch = _port_batch(b)
        assert batch["frames"].dtype == torch.bfloat16
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, batch,
            torch.tensor([jseeds[i]], dtype=torch.int32))
        outs.append(((params, loss, metrics), jouts[i]))
    return outs, images, jimages, jgrads, own


@pytest.mark.parametrize("route", list(CASES))
def test_encdec_step_matches_jax(monkeypatch, route):
    outs, images, jimages, jgrads, own = _steps(monkeypatch, route, torch.float32)
    for (params, loss, metrics), (jloss, jmax, jparams) in outs:
        np.testing.assert_allclose(loss.item(), jloss, rtol=2e-2)
        assert metrics[0].item() == jmax
        assert set(params) == set(jparams) and len(params) == N_LEAVES
        for k, p in params.items():
            assert tuple(p.shape) == jparams[k].shape, k
            np.testing.assert_allclose(p.numpy(), jparams[k], rtol=2e-6, atol=2e-6, err_msg=k)

    # step 1's integer images, leaf for leaf, bit for bit
    _assert_images_equal(images, jimages)
    assert len(jimages) == N_LEAVES
    assert 0 < outs[1][1][1] <= 127
    if CASES[route][1] == "sgd":  # at lr 0.3 the new leaves carried a nonzero image
        for k in NEW_LEAVES:
            assert bool(np.any(jimages[k] != 0)), k
    # the port's own bf16-activation gradients against JAX's
    for (_, g), jg in zip(own, jgrads):
        assert set(g) == set(jg)
        num = sum(float(torch.sum((g[k].double() - torch.from_numpy(jg[k]).double()) ** 2))
                  for k in g)
        den = sum(float(np.sum(jg[k].astype(np.float64) ** 2)) for k in g)
        assert (num / den) ** 0.5 < 3e-2


@pytest.mark.parametrize("route", list(CASES))
def test_encdec_step_with_bf16_params_matches_jax(monkeypatch, route):
    outs, images, jimages, _, _ = _steps(monkeypatch, route, torch.bfloat16)
    for (params, loss, metrics), (jloss, jmax, jparams) in outs:
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
