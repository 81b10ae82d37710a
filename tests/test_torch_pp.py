"""Port vs JAX: pipeline parallelism (``repro_torch.parallel.pp``) on a
stage group of gloo ranks against the JAX package's ``pipeline_forward``
on a forced 4-device stage mesh.

Cases (the same numpy inputs in both packages):

- ``tanh``: the reference test's (``tests/test_distributed.py``): 8 layers
  of tanh(h @ w), d 16, microbatches of 4 rows, 6 of them, 4 stages;
- ``few_micro``: 2 microbatches on 4 stages (fewer than the stages);
- ``two_stages``: 2 stages on the 2-rank subgroup {0, 1} (and the same
  pipeline on {2, 3}, whose ranks run it too);
- ``rank4``: x of rank 4, (n_micro, mb, T, d);
- ``granite``: the granite-8b smoke config's decoder layer at 8 layers, 2
  a stage, float32, through JAX's ``_dense_layer`` and the port's
  ``_layer`` on the same params (``params_from_jax``).

Each case holds the forward's last stage and the gradients of Σ out² (the
stage's slice of the params, stage 0's input) to:

- the sequential layer stack in JAX at the reference test's rtol 1e-4 and
  atol 1e-5 (the port's pipeline and JAX's, both);
- the port's own sequential loop over the microbatches, bit for bit: the
  same float32 ops on the same shapes, the per-microbatch gradients summed
  in the pipeline's order (last microbatch first);

and checks the stages that are not last output zeros, and that the input
gradient of those stages is zero. JAX's side runs on a mesh whose axis is
``AxisType.Auto`` and reads ``np.asarray(out)`` before slicing: the
reference test's own mesh gives the axis the Explicit type under JAX 0.9,
where its final reshape-and-index raises (ROADMAP's reference behaviours);
``pipeline_forward`` itself is exact there. One more case shows that ranks
whose loss does not reach their ring sends (the stages that are not last
weighing their output by zero) still finish the backward, with the same
gradients.

One JAX forced-mesh subprocess runs beside one 4-rank gloo spawn.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch, smoke_config  # noqa: E402
from repro_torch.models.common import SINGLE  # noqa: E402
from repro_torch.models.transformer import _layer, params_from_jax, resolve_dims  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel import pipeline_forward  # noqa: E402
from repro_torch.parallel.pp import bubble_fraction  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5  # the reference test's, against the sequential stack
GRANITE_L, GRANITE_T = 8, 8
# case: (n_layers, n_stages, n_micro, x's shape after the microbatch axis)
CASES = {
    "tanh": (8, 4, 6, (4, 16)),
    "few_micro": (8, 4, 2, (4, 16)),
    "two_stages": (8, 2, 6, (4, 16)),
    "rank4": (8, 4, 3, (2, 5, 16)),
    "granite": (GRANITE_L, 4, 3, (2, GRANITE_T, 64)),
}


def _granite_cfg():
    return dataclasses.replace(smoke_config(get_arch("granite-8b")), n_layers=GRANITE_L)


def _inputs():
    rng = np.random.default_rng(5)
    out = {}
    for case, (n_layers, _, n_micro, xs) in CASES.items():
        x = rng.standard_normal((n_micro, *xs)).astype(np.float32)
        if case == "granite":
            out[case] = dict(x=x)  # the params from JAX's init, in the subprocess
        else:
            w = (rng.standard_normal((n_layers, xs[-1], xs[-1])) * 0.2).astype(np.float32)
            out[case] = dict(x=x, w=w)
    return out


_JAX = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh, PartitionSpec as P
from repro.configs import get_arch, smoke_config
from repro.models.common import Axes
from repro.models.transformer import _dense_layer, init_lm_params, resolve_dims
from repro.parallel.collectives import shard_map
from repro.parallel.pp import pipeline_forward
import dataclasses

inp = pickle.load(open({inp!r}, "rb"))
CASES = {cases!r}
cfg = dataclasses.replace(smoke_config(get_arch("granite-8b")), n_layers={gl})
dims = resolve_dims(cfg, 1, 1)

def tanh_layer(w, h):
    return jnp.tanh(h @ w)

def granite_layer(p, h):
    pos = jnp.broadcast_to(jnp.arange(h.shape[1]), h.shape[:2])
    return _dense_layer(p, h, pos, Axes(), cfg, dims)

out = {{}}
for case, (L, S, NM, xs) in CASES.items():
    a = inp[case]
    x = jnp.asarray(a["x"])
    if case == "granite":
        params = init_lm_params(jax.random.PRNGKey(3), cfg)["layers"]
        out["granite_params"] = jax.tree.map(np.asarray, params)
        layer = granite_layer
    else:
        params = jnp.asarray(a["w"])
        layer = tanh_layer
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",), axis_types=(AxisType.Auto,))
    f = shard_map(lambda w, xm: pipeline_forward(layer, w, xm, axis="stage", n_stages=S),
                  mesh=mesh, in_specs=(P("stage"), P()), out_specs=P("stage"),
                  check_vma=False)
    staged = np.asarray(jax.jit(f)(params, x)).reshape(S, *x.shape)

    def seq(params, x):
        def one(h):
            for l in range(L):
                h = layer(jax.tree.map(lambda v: v[l], params), h)
            return h
        return jnp.stack([one(x[m]) for m in range(NM)])

    def pipe_loss(params, x):
        return jnp.sum(f(params, x).reshape(S, *x.shape)[S - 1] ** 2)

    def seq_loss(params, x):
        return jnp.sum(seq(params, x) ** 2)

    g_pipe = jax.jit(jax.grad(pipe_loss, argnums=(0, 1)))(params, x)
    g_seq = jax.jit(jax.grad(seq_loss, argnums=(0, 1)))(params, x)
    out[case] = dict(staged=staged, seq=np.asarray(jax.jit(seq)(params, x)),
                     g_pipe=jax.tree.map(np.asarray, g_pipe),
                     g_seq=jax.tree.map(np.asarray, g_seq))
pickle.dump(out, open({out!r}, "wb"))
print("JAX_OK")
"""


def _tanh_layer(w, h):
    return torch.tanh(h @ w)


def _granite_layer_fn():
    cfg = _granite_cfg()
    dims = resolve_dims(cfg, 1, 1)

    def layer(lp, h):
        pos = torch.arange(h.shape[1]).expand(h.shape[0], h.shape[1])
        return _layer(lp, h, pos, cfg, dims, SINGLE)

    return layer


def _flat_granite(params_np):
    return params_from_jax(params_np, "cpu")


def _stage_slice(params, s, per):
    if isinstance(params, torch.Tensor):
        return params[s * per:(s + 1) * per].clone()
    return {k: v[s * per:(s + 1) * per].clone() for k, v in params.items()}


def _leaves(params):
    return [params] if isinstance(params, torch.Tensor) else list(params.values())


def _run_case(group, stage, layer, params, x, n_stages, last_only_loss=False):
    """The stage's forward, then the backward of Σ out² (the stages that are
    not last weigh it by zero with ``last_only_loss``): output, the stage's
    param gradients, the input gradient."""
    per = _leaves(params)[0].shape[0] // n_stages
    mine = _stage_slice(params, stage, per)
    for v in _leaves(mine):
        v.requires_grad_(True)
    xm = x.clone().requires_grad_(True)
    out = pipeline_forward(layer, mine, xm, group=group, n_stages=n_stages)
    loss = (out ** 2).sum()
    if last_only_loss and stage != n_stages - 1:
        loss = loss * 0.0
    loss.backward()
    grads = mine.grad if isinstance(mine, torch.Tensor) else {k: v.grad for k, v in mine.items()}
    return dict(out=out.detach(), grads=grads, gx=xm.grad)


def _pp_rank(group, rank, inputs, granite_params):
    pair = [coll.new_group([0, 1]), coll.new_group([2, 3])][rank // 2]
    coll.reset_tp_counts()
    res = {}
    for case, (_, n_stages, _, _) in CASES.items():
        x = torch.from_numpy(inputs[case]["x"])
        if case == "granite":
            layer, params = _granite_layer_fn(), _flat_granite(granite_params)
        else:
            layer, params = _tanh_layer, torch.from_numpy(inputs[case]["w"])
        g, stage = (pair, rank % 2) if n_stages == 2 else (group, rank)
        res[case] = _run_case(g, stage, layer, params, x, n_stages)
        if case == "tanh":
            res["tanh_last_only_loss"] = _run_case(g, stage, layer, params, x, n_stages,
                                                   last_only_loss=True)
    res["ring_calls"] = coll.tp_counts().get("ppermute_ring", 0)
    return res


def _sequential(layer, params, x):
    """The port's own loop: each microbatch through every layer in turn, its
    gradients of Σ out² summed last microbatch first (the pipeline's
    backward order)."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in (
        params.items() if isinstance(params, dict) else [("w", params)])}
    xr = x.clone().requires_grad_(True)
    outs, g_sum, g_x = [None] * x.shape[0], None, torch.zeros_like(x)
    n_layers = next(iter(leaves.values())).shape[0]
    for m in reversed(range(x.shape[0])):
        h = xr[m]
        for i in range(n_layers):
            lp = leaves["w"][i] if not isinstance(params, dict) else {
                k: v[i] for k, v in leaves.items()}
            h = layer(lp, h)
        outs[m] = h.detach()
        gs = torch.autograd.grad((h ** 2).sum(), [xr, *leaves.values()])
        g_x += gs[0]
        g = dict(zip(leaves, gs[1:]))
        g_sum = g if g_sum is None else {k: g_sum[k] + g[k] for k in g}
    grads = g_sum["w"] if not isinstance(params, dict) else g_sum
    return torch.stack(outs), grads, g_x


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    inputs = _inputs()
    inp, out = str(tmp / "inp.pkl"), str(tmp / "jax.pkl")
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    script = _JAX.format(inp=inp, out=out, cases=CASES, gl=GRANITE_L)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        # the granite params come from JAX's init: wait for them first
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "JAX_OK" in stdout, stderr[-4000:]
    with open(out, "rb") as f:
        jax_out = pickle.load(f)
    ranks = run_ranks(_pp_rank, 4, args=(inputs, jax_out["granite_params"]), timeout_s=300)
    return inputs, jax_out, ranks


def _case_ranks(ranks, case):
    n_stages = CASES[case][1]
    return [r[case] for r in ranks[:n_stages]]


def _port_params(case, inputs, jax_out):
    if case == "granite":
        return _granite_layer_fn(), _flat_granite(jax_out["granite_params"])
    return _tanh_layer, torch.from_numpy(inputs[case]["w"])


def _jax_grads(case, g):
    """JAX's gradient tree with the port's leaf names."""
    return _flat_granite(g) if case == "granite" else torch.from_numpy(g)


def _close(a, b, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol)


def _per_leaf(a, b, fn):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            fn(a[k], b[k])
    else:
        fn(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_forward_matches_the_sequential_stack_and_jax(pp_run, case):
    inputs, jax_out, ranks = pp_run
    n_stages = CASES[case][1]
    rs = _case_ranks(ranks, case)
    j = jax_out[case]
    seq = torch.from_numpy(j["seq"])
    last = rs[-1]["out"]
    _close(last, seq)  # the port's pipeline against JAX's sequential stack
    _close(torch.from_numpy(j["staged"][n_stages - 1]), seq)  # and JAX's own pipeline
    _close(last, torch.from_numpy(j["staged"][n_stages - 1]))
    for r in rs[:-1]:
        assert torch.count_nonzero(r["out"]) == 0  # valid on the last stage only
    layer, params = _port_params(case, inputs, jax_out)
    own, _, _ = _sequential(layer, params, torch.from_numpy(inputs[case]["x"]))
    assert torch.equal(last, own)  # the port's own loop, bit for bit
    if case == "two_stages":  # the other pair ran the same pipeline
        assert torch.equal(ranks[3][case]["out"], last)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_gradients_match_the_sequential_stack_and_jax(pp_run, case):
    inputs, jax_out, ranks = pp_run
    n_stages, rs = CASES[case][1], _case_ranks(ranks, case)
    layer, params = _port_params(case, inputs, jax_out)
    _, own_g, own_gx = _sequential(layer, params, torch.from_numpy(inputs[case]["x"]))
    j_seq = _jax_grads(case, jax_out[case]["g_seq"][0])
    j_pipe = _jax_grads(case, jax_out[case]["g_pipe"][0])
    per = _leaves(params)[0].shape[0] // n_stages

    def rel_close(a, b):  # atol scaled to the leaf: gradients are not O(1)
        _close(a, b, atol=ATOL * max(float(b.abs().max()), 1.0))

    for s, r in enumerate(rs):
        _per_leaf(r["grads"], _stage_slice(own_g, s, per),
                  lambda a, b: (a.shape == b.shape and torch.equal(a, b)) or pytest.fail(
                      f"stage {s}: gradient not bit-equal to the port's own loop"))
        _per_leaf(r["grads"], _stage_slice(j_seq, s, per), rel_close)
        _per_leaf(_stage_slice(j_pipe, s, per), _stage_slice(j_seq, s, per), rel_close)
    assert torch.equal(rs[0]["gx"], own_gx)
    rel_close(rs[0]["gx"], torch.from_numpy(jax_out[case]["g_seq"][1]))
    rel_close(torch.from_numpy(jax_out[case]["g_pipe"][1]),
              torch.from_numpy(jax_out[case]["g_seq"][1]))
    for r in rs[1:]:
        assert torch.count_nonzero(r["gx"]) == 0  # only stage 0 reads x


def test_ranks_whose_loss_does_not_reach_their_sends_finish_the_backward(pp_run):
    _, _, ranks = pp_run
    for r in ranks:  # every rank returned, with the full loss's gradients
        a, b = r["tanh_last_only_loss"], r["tanh"]
        assert torch.equal(a["out"], b["out"]) and torch.equal(a["grads"], b["grads"])
        assert torch.equal(a["gx"], b["gx"])


def test_one_ring_send_a_tick_each_way(pp_run):
    _, _, ranks = pp_run
    ticks = {case: n_micro + n_stages - 1 for case, (_, n_stages, n_micro, _) in CASES.items()}
    ticks["tanh_last_only_loss"] = ticks["tanh"]
    assert all(r["ring_calls"] == 2 * sum(ticks.values()) for r in ranks)
    assert bubble_fraction(6, 4) == 3 / 9


def test_the_pipeline_refuses_the_local_backend_and_a_wrong_stage_count():
    with pytest.raises(ValueError, match="stage group"):
        pipeline_forward(_tanh_layer, torch.zeros(2, 3, 3), torch.zeros(1, 2, 3), group=None,
                         n_stages=1)
    with pytest.raises(ValueError, match="stage group"):
        coll.ppermute_ring(torch.zeros(3), None)
