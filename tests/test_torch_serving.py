"""Port vs JAX: the serving engine (``serving/engine.py``) on the granite
smoke model, from JAX's weights (``params_from_jax``).

1. The four tests of the JAX package's ``tests/test_serving.py`` on the
   port: continuous batching completes every request (more requests than
   slots too), the same prompt gives the same continuation alone and beside
   a companion, and the weight refresh over the integer wire (packed8, α =
   1000, the port's own encode) lands within 1/α of the float delta.
2. The port's engine against JAX's ``ServeEngine`` on the same prompts. JAX's
   engine runs its own admit and run loops with its step un-jitted (each
   operation rounded to bf16 as written; see ``test_torch_decode.py``),
   recording every step's tokens, positions and logits. Fed the same tokens
   and positions, the port's ``lm_decode_step`` gives the same logits at
   every step within ``test_torch_decode.py``'s bf16 tolerance (2 bf16 ULPs
   of the largest |logit|). The port's own engine then takes the same step
   inputs as JAX's up to and including the first step at which an active
   slot's top-1 logit leads its top-2 by less than twice the two packages'
   largest logit difference at that step (past it the greedy picks may
   differ by rounding alone); with no such step, every request's tokens
   are equal. On these seeds the logits are bit-equal at every step, so
   the whole streams are compared.
   The same holds for a hybrid (zamba2-2.7b) and an ssm (xlstm-125m) smoke
   model, whose O(1) states the engine carries per slot.
3. ``apply_wire_delta`` given JAX's packed8 words and α (JAX's own encode
   and pack) gives params bit-equal to JAX's engine's after its refresh.
4. The reference behaviour the port keeps in the recurrent families: every
   slot steps on every prompt token of another slot's prefill, so a slot's
   state advances on another slot's prefill (in JAX's engine too), and a
   slot is not reset when it admits a request, which so starts from the
   state its slot's last occupant left.
"""
import math
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro.models.transformer import init_lm_params as jinit  # noqa: E402
from repro.serving.engine import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro.wire import PackedInt as JPackedInt  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.core.compressor import leaf_seeds  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.decode import init_lm_cache, lm_decode_step  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.wire import PackedInt  # noqa: E402
from test_torch_decode import _flat  # noqa: E402

PROMPTS = ([3, 141, 59, 26], [53, 5], [89, 79, 32, 38, 46])


@pytest.fixture(scope="module")
def small_model():
    jcfg = jsmoke(jget_arch("granite-8b"))
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return smoke_config(get_arch("granite-8b")), params, jcfg, jparams


def _bf16_tol(logits) -> float:
    """2 bf16 ULPs of the largest |logit|."""
    return 2 * 2.0 ** (math.floor(math.log2(float(np.abs(logits).max()))) - 7)


# --------------------------------------------------------------------- 1.
def test_engine_completes_requests(small_model):
    cfg, params, _, _ = small_model
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cpu")
    reqs = [Request(rid=i, prompt=[1 + i, 2 + i, 3 + i], max_new=5) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.done
        assert len(r.out) >= 5
        assert all(0 <= t < cfg.vocab for t in r.out)


def test_engine_more_requests_than_slots(small_model):
    cfg, params, _, _ = small_model
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cpu")
    reqs = [Request(rid=i, prompt=[7, 8], max_new=3) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)


def test_identical_prompts_identical_outputs(small_model):
    """Greedy decode is deterministic: the same prompt gives the same
    continuation whatever the slot and the batch's other requests."""
    cfg, params, _, _ = small_model
    outs = []
    for trial in range(2):
        eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cpu")
        r = Request(rid=0, prompt=[11, 12, 13], max_new=6)
        eng.submit(r)
        if trial == 1:  # a companion request changes the batch's composition
            eng.submit(Request(rid=1, prompt=[40], max_new=6))
        eng.run()
        outs.append(tuple(r.out))
    assert outs[0] == outs[1]


def test_wire_delta_weight_refresh(small_model):
    """Train→serve refresh over the integer wire: Δparams as packed8 words
    (the port's encode, α = 1000, n = 1), decoded and applied within the
    quantization error 1/α per coordinate (|αΔ| << 127: no clip)."""
    cfg, params, _, _ = small_model
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cpu")
    wf = PackedInt(bits=8)
    alpha = torch.tensor(1000.0)
    rng = np.random.default_rng(7)
    deltas = {k: torch.from_numpy(1e-3 * rng.standard_normal(p.shape).astype(np.float32))
              for k, p in params.items()}
    seeds = leaf_seeds(torch.Generator().manual_seed(7), 1, len(deltas), "cpu")[0]
    words = {k: wf.pack(wf.encode(d, alpha, seeds[i], n_workers=1), n_workers=1)
             for i, (k, d) in enumerate(deltas.items())}
    assert all(not w.is_floating_point() for w in words.values())  # floatless wire
    before = {k: v.clone() for k, v in eng.params.items()}
    eng.apply_wire_delta(words, {k: alpha for k in words}, wf)
    for k, d in deltas.items():
        got = eng.params[k].float() - before[k].float()
        assert float((got - d).abs().max()) <= 1.0 / float(alpha) + 1e-6, k


# --------------------------------------------------------------------- 2.
def _jax_engine_run(jcfg, jparams, slots, max_new):
    """JAX's engine on PROMPTS with its step un-jitted, recording each
    step's (tokens, pos, logits, active slots)."""
    eng = JServeEngine(jcfg, jparams, slots=slots, max_seq=64)
    steps = []
    impl = partial(jdecode.lm_decode_step, axes=Axes(), cfg=jcfg)

    def step(params, cache, tokens, pos):
        with jax.disable_jit():
            logits, cache = impl(params, cache, tokens, pos)
        steps.append((np.asarray(tokens), np.asarray(pos), np.asarray(logits),
                      [r is not None for r in eng.active]))
        return jnp.argmax(logits, axis=-1), cache

    eng._step = step
    reqs = [JRequest(rid=i, prompt=list(p), max_new=max_new) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return steps, [r.out for r in reqs]


def _engine_vs_jax(cfg, params, jcfg, jparams):
    slots, max_new = 2, 5
    jsteps, jouts = _jax_engine_run(jcfg, jparams, slots, max_new)
    # the same step inputs into the port's decode step: the same logits
    cache = init_lm_cache(cfg, slots, 64, device="cpu")
    first_tie = None
    for i, (tokens, pos, want, active) in enumerate(jsteps):
        got, cache = lm_decode_step(params, cache, torch.tensor(tokens.tolist()),
                                    torch.tensor(pos.tolist()), cfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_bf16_tol(want),
                                   err_msg=f"step {i}")
        # a pick can differ only where the top-2 margin is within twice the
        # logits' difference (none where they are equal: both take the first
        # index of a tie)
        diff = float(np.abs(got.numpy() - want)[np.asarray(active)].max(initial=0.0))
        top2 = np.sort(want, axis=-1)[:, -2:]
        margins = (top2[:, 1] - top2[:, 0])[np.asarray(active)]
        if first_tie is None and margins.size and margins.min() < 2 * diff:
            first_tie = i
    # the port's own engine takes the same inputs up to the first near tie
    eng = ServeEngine(cfg, params, slots=slots, max_seq=64, device="cpu")
    inputs = []
    real_step = eng.step

    def step():
        inputs.append((list(eng.cur_tok), list(eng.pos)))
        return real_step()

    eng.step = step
    reqs = [Request(rid=i, prompt=list(p), max_new=max_new) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    last = len(jsteps) - 1 if first_tie is None else first_tie
    for i in range(last + 1):
        assert inputs[i] == (jsteps[i][0].tolist(), jsteps[i][1].tolist()), f"step {i}"
    if first_tie is None:
        assert [r.out for r in reqs] == jouts
        assert len(inputs) == len(jsteps)


def test_engine_matches_jax_engine(small_model):
    _engine_vs_jax(*small_model)


def _model(name):
    jcfg = jsmoke(jget_arch(name))
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return smoke_config(get_arch(name)), params, jcfg, jparams


@pytest.mark.parametrize("name", ["zamba2-2.7b", "xlstm-125m"])
def test_recurrent_engine_matches_jax_engine(name):
    _engine_vs_jax(*_model(name))


# --------------------------------------------------------------------- 3.
def test_wire_delta_matches_jax(small_model):
    cfg, params, jcfg, jparams = small_model
    wf = JPackedInt(bits=8)
    key = jax.random.PRNGKey(7)
    alpha = jnp.float32(1000.0)
    deltas = jax.tree.map(
        lambda p: 1e-3 * jax.random.normal(jax.random.fold_in(key, p.size), p.shape), jparams)
    words = jax.tree.map(lambda d: wf.pack(wf.encode(d, alpha, key, n_workers=1), n_workers=1),
                         deltas)
    jeng = JServeEngine(jcfg, jparams, slots=2, max_seq=64)
    jeng.apply_wire_delta(words, jax.tree.map(lambda _: alpha, deltas), wf)
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cpu")
    eng.apply_wire_delta(params_from_jax(jax.tree.map(np.asarray, words), "cpu"),
                         torch.tensor(1000.0), PackedInt(bits=8))
    want = params_from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    assert sorted(want) == sorted(eng.params)
    for k, v in want.items():
        assert eng.params[k].dtype == v.dtype
        assert torch.equal(eng.params[k], v), k


# --------------------------------------------------------------------- 4.
def _slot_state(cache, slot):
    """One slot's recurrent state, every layer's, as float32 numpy."""
    return np.concatenate([np.asarray(v, np.float32)[:, slot].ravel() for k, v in
                           sorted(cache.items()) if k.startswith("blocks/")])


def test_recurrent_slot_state_is_shared_with_the_batch():
    cfg, params, jcfg, jparams = _model("xlstm-125m")
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cpu")
    eng.submit(Request(rid=0, prompt=[3, 141, 59], max_new=2))
    eng._admit()  # slot 0 prefills
    before = _slot_state(eng.cache, 0)
    eng.submit(Request(rid=1, prompt=[53, 5], max_new=2))
    eng._admit()  # slot 1 prefills: slot 0 steps twice more
    assert not np.array_equal(_slot_state(eng.cache, 0), before)
    # JAX's engine does the same
    jeng = JServeEngine(jcfg, jparams, slots=2, max_seq=64)
    jeng.submit(JRequest(rid=0, prompt=[3, 141, 59], max_new=2))
    jeng._admit()
    jbefore = _slot_state(_flat(jeng.cache), 0)
    jeng.submit(JRequest(rid=1, prompt=[53, 5], max_new=2))
    jeng._admit()
    assert not np.array_equal(_slot_state(_flat(jeng.cache), 0), jbefore)
    # a request admitted into a used slot starts from the state left in it
    eng.run()
    left = _slot_state(eng.cache, 0)
    assert np.abs(left).max() > 0
    seen = []
    real_step = eng.step

    def step():
        seen.append(_slot_state(eng.cache, 0))
        return real_step()

    eng.step = step
    eng.submit(Request(rid=2, prompt=[7, 8], max_new=2))
    eng.run()
    np.testing.assert_array_equal(seen[0], left)


def test_serve_cli_and_the_card_by_default(small_model, capsys):
    """The CLI serves on the CPU when asked; the engine runs on the card
    unless asked for the CPU, and raises without one."""
    for arch in ("granite-8b", "zamba2-2.7b", "xlstm-125m"):
        serve.main(["--arch", arch, "--requests", "3", "--max-new", "4", "--device", "cpu"])
        assert "[serve] 3 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="does not serve the encoder-decoder"):
        serve.main(["--arch", "seamless-m4t-medium", "--device", "cpu"])
    assert [len(p) for p in serve.prompts(6, 256)] == [4, 5, 6, 7, 4, 5]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine runs on it")
    cfg, params, _, _ = small_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
