"""Port vs JAX: the paper's other compressors on a 2 × 2 data × model grid
(tensor parallelism; the float and sparse ones: QSGD on its two wires,
NatSGD, TopK and IntSGD on the sparse ``topk8`` gather wire). The JAX
side is ``build_train_step`` on its ``("data", "model")`` mesh (forced 4
CPU devices, one subprocess); the port's is ``build_train_step(grid=...)``
on four gloo ranks (one spawn), each rank given its shard of JAX's global
state before every step. The subprocess writes each corner's records as
it finishes it, and the ranks take them up as they come, so the two run
side by side. JAX runs the exact step once a config for the baselines
(it reads no compressor state of theirs; IntSGD's α it does) and goes on
from it with each baseline's compressed steps: one compile fewer a
corner.

Corners: granite-8b smoke at 2 layers, seq 32, global batch 4, float32
params from ``PRNGKey(0)``, the ZeRO-1 route with SGD (momentum 0.9) at a
constant lr 0.1, clip 1.0, 3 steps (one exact, two compressed), step key
``PRNGKey(i)``. Each step is checked twice, as in
``tests/test_torch_slice_tp.py``: (1) each rank's own loss and gradients
at JAX's params are held to its JAX device's (loss rtol 2e-2, gradients
within 3e-2 relative L2: the two packages' bf16 forwards round
differently; the ssm family's forward runs in float32 in both packages,
as in ``tests/test_torch_slice_tp_recurrent.py``: loss rtol 2e-6, each
gradient leaf within 1e-4 relative L2, the sLSTM's time loop summing six
layers' float32 rounding in another order); (2) JAX's gradients, caught on each device inside its
jitted step, are handed to the port's step, and the result is compared
with JAX's:

- the loss within rtol 1e-6 and max_int bit-equal (0 for the float
  compressors; IntSGD on ``topk8``: the wire's clip 254 reached);
- the gathered params and error feedback at the tolerance that
  ``tests/test_torch_baselines.py`` holds the same compressor to at
  tp = 1 (``TOL``): QSGD and NatSGD rtol 1e-6 (their norms and means
  through reductions in another order), TopK bit-equal in its error
  feedback (selection and the scatter-add in worker order) and rtol 1e-6
  in the params (the clip factor's global norm is summed in another
  order), SignSGD and TopK 10x looser on their second compressed step
  (from the carried residual, as at tp = 1), IntSGD on ``topk8`` the
  port's α within rtol 1e-6 of JAX's and, given JAX's α and JAX's rounding uniforms (its jitted α is one float32
  ULP off the same formula run eagerly, and its TopKInt rounds with
  ``jax.random`` where the port's encode kernel uses the counter PRNG; on
  the sparse wire one rounding across its threshold changes which K
  coordinates are sent), params and residual within 2e-6, max_int
  bit-equal;
- the data replicas of each shard bit-identical, and every replicated
  leaf (the norms' weights) bit-identical across the model group, its
  error feedback too, after every step.

The reference's TP behaviours are pinned here. QSGD's levels on each
shard are scaled by that shard's own norm (the global leaf is decoded with
two norms), and TopK keeps k of each shard (k = k_frac × the local size).
QSGD's and NatSGD's uniforms are drawn per (data index, leaf) over the
local shape: both model ranks of a replica use the same array (the port's
``counter_uniform`` over local indices with the same seed has the same
property); for the comparison the ranks swap ``counter_uniform`` for
JAX's own draws, as ``tests/test_torch_baselines.py`` does at tp = 1.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.launch.step as tstep  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core import compressor as tcomp  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.step import build_train_step  # noqa: E402
from repro_torch.models.common import gather_shards  # noqa: E402
from repro_torch.models.transformer import params_from_jax, zero1_state_from_jax  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402
from repro_torch.wire.topk import TopKInt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, STEPS, LR = 32, 4, 3, 0.1
GRID = (2, 2)  # (data, model)
WAIT_S = 400.0
# name: (arch, layers, compressor, make_compressor arguments)
CORNERS = {
    "qsgd": ("granite-8b", 2, "qsgd", {}),
    "qsgd-packed8": ("granite-8b", 2, "qsgd", {"wire": "packed8"}),
    "natsgd": ("granite-8b", 2, "natsgd", {}),
    "topk": ("granite-8b", 2, "topk", {}),
    "intsgd-topk8": ("granite-8b", 2, "intsgd", {"bits": 8, "wire": "topk8:16"}),
}
# compressor: (rtol, atol as a fraction of the largest |value|) of the params,
# and of the error feedback (None: the compressor keeps none)
TOL = {
    "none": ((1e-6, 1e-6), None),
    "allgather_sgd": ((1e-6, 1e-6), None),
    "qsgd": ((1e-6, 1e-6), None),
    "natsgd": ((1e-6, 1e-6), None),
    "signsgd": ((1e-6, 1e-6), (1e-6, 1e-6)),
    "topk": ((1e-6, 1e-6), (0.0, 0.0)),
    "powersgd": ((1e-4, 1e-4), (1e-4, 1e-4)),
    "intsgd": ((2e-6, 2e-6), (2e-6, 2e-6)),
}
# the families whose forward runs in float32 in both packages here: the
# xLSTM's bf16 gradients differ between the packages by more than the
# slices' bf16 tolerance at tp = 2 (8.7 % relative L2 on the smoke grid), so
# its own-gradient check is float32's, as tests/test_torch_slice_tp_recurrent.py's
F32_FAMILIES = ("ssm",)
# the error-feedback baselines held 10x looser on their second round (from the
# carried residual) at tp = 1, and so here on step 2
SECOND_ROUND = ("signsgd", "topk")
# the compressors whose uniforms come from jax.random in the JAX package: QSGD's
# and NatSGD's, and IntSGD's on the gather wire (JAX's TopKInt rounds with
# jax.random, the port's with the encode kernel's counter PRNG, which
# tests/test_torch_topk.py holds to JAX's kernel stream)
UNIFORM = ("qsgd", "natsgd", "intsgd")

_JAX = """
import dataclasses, os, pickle, time, types
import jax, jax.numpy as jnp, numpy as np
from jax import lax
import repro.launch.step as jstep
from repro.configs import ShapeConfig, get_arch, smoke_config
from repro.core.compressor import IntSGD, _leaf_keys, make_compressor
from repro.core.scaling import AlphaState
from repro.kernels import ops
from repro.launch import specs as jspecs
from repro.models.transformer import init_lm_params
from repro.optim import sgd
from repro.optim.schedules import constant

corners, batches, out_dir, seq, batch, steps, lr, uniform_names = pickle.load(open({inp!r}, "rb"))
wait_s = {wait}
f32_families = {f32!r}

def key_of(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

def flat(tree):
    return {{key_of(path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}

def plain(x):
    if isinstance(x, AlphaState):
        return types.SimpleNamespace(r=plain(x.r), step=plain(x.step))
    if isinstance(x, dict):
        return {{k: plain(v) for k, v in x.items()}}
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    return None if x is None else np.asarray(x)

grads, alphas = {{}}, {{}}
fb = jstep._forward_backward

def spy_fb(layout, loss_fn, params, batch):
    if layout.cfg.family in f32_families:  # the forward in float32
        loss_fn = lambda p, b, axes, cfg, dtype, fn=loss_fn: fn(p, b, axes, cfg, dtype=jnp.float32)
    loss, g = fb(layout, loss_fn, params, batch)
    jax.debug.callback(lambda l, t, d, m: grads.__setitem__((int(d), int(m)), (float(l), flat(t))),
                       loss, g, lax.axis_index("data"), lax.axis_index("model"))
    return loss, g

jstep._forward_backward = spy_fb
enc = IntSGD.encode_ints

def spy_enc(self, *a, **kw):
    ints, al = enc(self, *a, **kw)
    jax.debug.callback(lambda t, d, m: alphas.__setitem__((int(d), int(m)), flat(t)), al,
                       lax.axis_index("data"), lax.axis_index("model"))
    return ints, al

IntSGD.encode_ints = spy_enc

exact = {{}}  # (arch, layers) -> a baseline's exact step: (params, opt_state, its record)

def jbatch(b):
    return {{"tokens": jnp.asarray(b[0], jnp.int32), "labels": jnp.asarray(b[1], jnp.int32)}}

for name, (arch, layers, comp, kw, n_dp, tp) in corners.items():
    cfg = dataclasses.replace(smoke_config(get_arch(arch)), n_layers=layers)
    mesh = jax.make_mesh((n_dp, tp), ("data", "model"))
    pos = {{d.id: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}}

    def per_device(tree):
        out = {{}}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            for sh in leaf.addressable_shards:
                out.setdefault(pos[sh.device.id], {{}})[key_of(path)] = np.asarray(sh.data)[0]
        return out

    jc = make_compressor(comp, **kw)
    jo = sgd(momentum=0.9)
    art = jstep.build_train_step(cfg, mesh, ShapeConfig("tp", seq, batch, "train"),
                                 compressor=jc, base_opt=jo, lr_schedule=constant(lr),
                                 param_dtype=jnp.float32, fused=False, clip_norm=1.0,
                                 donate=False)
    params = init_lm_params(jax.random.PRNGKey(0), cfg, tp=tp, n_shards=1, dtype=jnp.float32)
    n_leaves = len(jax.tree.leaves(params))
    local = [tuple(s.shape) for s in jax.tree.leaves(jspecs.param_shapes(cfg, tp, tp))]
    params = jax.device_put(params, art.in_shardings[0])
    opt_state, comp_state = jstep.build_init_state(cfg, mesh, compressor=jc, base_opt=jo,
                                                   fused=False)(params)
    recs = []
    for i in range(steps):
        before = plain((params, opt_state, comp_state))
        q_before = per_device(comp_state["q"]) if comp == "powersgd" else None
        k = jax.random.PRNGKey(i)
        akey = jax.random.fold_in(k, 1)
        wkeys = [jax.random.split(jax.random.fold_in(akey, d), n_leaves) for d in range(n_dp)]
        seeds = [[int(ops.seed_from_key(s)) for s in wk] for wk in wkeys]
        uniforms = {{}}
        if i and comp in uniform_names:
            uniforms = {{(d, j): np.asarray(jax.random.uniform(wkeys[d][j], local[j], jnp.float32))
                        for d in range(n_dp) for j in range(n_leaves)}}
        grads.clear(); alphas.clear()
        if i == 0 and comp != "intsgd" and (arch, layers) in exact:
            # the exact step reads no compressor state but IntSGD's α (the
            # baselines' observe_update keeps theirs): the config's first one
            params, opt_state, same = exact[(arch, layers)]
        else:
            fn = art.jitted["exact"] if i == 0 else art.jitted["compressed"]
            params, opt_state, comp_state, loss, metrics = fn(
                params, opt_state, comp_state, jnp.int32(i), k, jbatch(batches[i]))
            jax.effects_barrier()
            same = dict(grads=dict(grads), loss=float(loss), max_int=float(metrics[0]),
                        params=flat(params))
            if i == 0 and comp != "intsgd":
                exact[(arch, layers)] = (params, opt_state, same)
        recs.append(dict(before=before, q_before=q_before, seeds=seeds, uniforms=uniforms,
                         alphas=dict(alphas), comp=plain(comp_state),
                         q_after=per_device(comp_state["q"]) if comp == "powersgd" else None,
                         **same))
    tmp = os.path.join(out_dir, name + ".tmp")
    pickle.dump(recs, open(tmp, "wb"))
    os.rename(tmp, os.path.join(out_dir, name + ".pkl"))
"""


def batches():
    """The three steps' global batches (seed 5, as ``test_torch_slice_tp.py``'s)."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (BATCH, SEQ))
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        out.append((toks, labels))
    return out


def corner_cfg(arch, layers):
    return dataclasses.replace(smoke_config(get_arch(arch)), n_layers=layers)


def wait_load(path):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"no {path} after {WAIT_S} s")
        time.sleep(0.2)
    with open(path, "rb") as fh:
        return pickle.load(fh)


def rel_l2(got, want):
    num = sum(float(torch.sum((got[k].double() - torch.from_numpy(want[k]).double()) ** 2))
              for k in got)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in got)
    return (num / den) ** 0.5


def per_worker(comp, state):
    """The per-worker error-feedback tree of a compressor's state (the
    rank's (1, ...) rows), or None."""
    if comp in ("topk", "signsgd"):
        return state
    if comp == "powersgd":
        return state["err"]
    if comp == "intsgd":
        return state["ef"]
    return None


def corner_rank(grid, corners, name, recs, batches):
    """One rank of one corner: per step, its own forward at JAX's params,
    then the step with JAX's gradients (and QSGD's and NatSGD's uniforms)
    handed in, from JAX's state (PowerSGD's Q: the rank's own JAX
    device's)."""
    arch, layers, comp, kw, n_dp, tp = corners[name]
    cfg = corner_cfg(arch, layers)
    shard = specs.tp_shard(cfg, tp, grid.tp_index)
    art = build_train_step(
        cfg, ShapeConfig("tp", SEQ, BATCH, "train"), n_workers=n_dp,
        compressor=make_compressor(comp, **kw), base_opt=sgd(momentum=0.9),
        lr_schedule=constant(LR), param_dtype=torch.float32, clip_norm=1.0, device="cpu",
        grid=grid)
    me = (grid.dp_index, grid.tp_index)
    fb, uniform, aggregate = tstep._forward_backward, tcomp.counter_uniform, tcomp.QSGD.aggregate
    loss_for = tstep._loss_fn_for
    alphas_of, encode = tcomp.IntSGD._alphas, TopKInt.encode
    seen = {}

    def jax_round(self, x, alpha, seed, *, n_workers, stochastic=True, amax=None):
        # JAX's TopKInt encode: stochastic rounding with its own uniforms
        v = x.to(torch.float32) * alpha
        lo = torch.floor(v)
        u = torch.from_numpy(seen["uniforms"][divmod(int(seed), 100)])
        lim = self.clip_limit(n_workers)
        r = torch.clamp(lo + (u < v - lo).to(torch.float32), -lim, lim).to(torch.int32)
        amax.copy_(torch.maximum(amax, r.abs().max().to(amax.dtype)))
        return r

    def jax_alphas(self, state, names, eta, n, dims):  # the port's α kept, JAX's used
        seen["alphas"] = {k: float(v) for k, v in alphas_of(self, state, names, eta, n,
                                                            dims).items()}
        return {k: torch.tensor(seen["jax_alphas"][k]) for k in names}

    def spy_aggregate(self, *a, **k):  # QSGD's decoded mean, kept
        ghat, state, m = aggregate(self, *a, **k)
        seen["ghat"] = {key: v.clone() for key, v in ghat.items()}
        return ghat, state, m

    out = []
    for i, rec in enumerate(recs):
        p0, o0, c0 = rec["before"]
        params = params_from_jax(p0, "cpu", shard=shard)
        opt_state, comp_state = zero1_state_from_jax(o0, c0, "cpu", rank=grid.dp_index,
                                                     shard=shard)
        q_from_jax = None
        if comp == "powersgd":  # the layout's Q, then the device's own
            q_from_jax = {k: v.clone() for k, v in comp_state["q"].items()}
            comp_state["q"] = {k: torch.from_numpy(rec["q_before"][me][k].copy())
                               for k in comp_state["q"]}
        batch = {"tokens": torch.from_numpy(batches[i][0]), "labels": torch.from_numpy(
            batches[i][1])}
        jloss, jgrads = rec["grads"][me]
        if cfg.family in F32_FAMILIES:  # the forward in float32, as the JAX side's
            tstep._loss_fn_for = lambda c: (lambda p, b, c, dtype, **k: loss_for(c)(
                p, b, c, dtype=torch.float32, **k))
        try:
            own_loss, own = fb(art.layout, params,
                               tstep._microbatch(batch, grid.dp_index, n_dp))
        finally:
            tstep._loss_fn_for = loss_for
        assert set(own) == set(jgrads) and all(own[k].shape == jgrads[k].shape for k in own)
        handed = {k: torch.from_numpy(jgrads[k]) for k in own}
        seeds = torch.tensor(rec["seeds"], dtype=torch.int32)
        if rec["uniforms"]:  # seed 100·d + j stands for (data index d, leaf j)
            seeds = torch.tensor([[100 * d + j for j in range(len(own))] for d in range(n_dp)],
                                 dtype=torch.int32)
            table = rec["uniforms"]
            tcomp.counter_uniform = lambda shape, seed, device: torch.from_numpy(
                table[divmod(int(seed), 100)].copy())
            TopKInt.encode = jax_round
        tstep._forward_backward = lambda layout, p, b: (torch.tensor(jloss), dict(handed))
        tcomp.QSGD.aggregate = spy_aggregate
        seen.clear()
        seen["uniforms"] = rec["uniforms"]
        if rec["alphas"]:
            seen["jax_alphas"] = rec["alphas"][me]
            tcomp.IntSGD._alphas = jax_alphas
        try:
            fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
            params, opt_state, comp_state, loss, metrics = fn(
                params, opt_state, comp_state, i, batch, seeds)
        finally:
            tstep._forward_backward, tcomp.counter_uniform = fb, uniform
            tcomp.QSGD.aggregate, tcomp.IntSGD._alphas = aggregate, alphas_of
            TopKInt.encode = encode
        ef = per_worker(comp, comp_state)
        out.append(dict(own_loss=float(own_loss), jloss=jloss, grad_err=rel_l2(own, jgrads),
                        own=own,
                        loss=float(loss), max_int=float(metrics[0]),
                        alphas=seen.get("alphas", {}),
                        params={k: v.clone() for k, v in params.items()},
                        ef=None if ef is None else {k: v.clone() for k, v in ef.items()},
                        q=None if comp != "powersgd" else dict(comp_state["q"]),
                        q_from_jax=q_from_jax, ghat=seen.get("ghat")))
    return out


def ranks_fn(group, rank, corners, out_dir, batches):
    grid = make_debug_mesh(*GRID)
    return {name: corner_rank(grid, corners, name,
                              wait_load(os.path.join(out_dir, name + ".pkl")), batches)
            for name in corners}


def run_both(tmp, corners, ranks=ranks_fn, extra=(), jax_tail=""):
    """The JAX subprocess and the port's 4-rank spawn side by side: ``(ref,
    ranks)``, ``ref`` each corner's JAX records by name. ``corners``:
    name -> (arch, layers, compressor, kwargs, n_dp, tp); ``extra`` goes
    after the spawn's standard arguments; ``jax_tail`` runs in the JAX
    subprocess after the corners."""
    out_dir = str(tmp)
    bs = batches()
    inp = os.path.join(out_dir, "in.pkl")
    with open(inp, "wb") as fh:
        pickle.dump((corners, bs, out_dir, SEQ, BATCH, STEPS, LR, UNIFORM), fh)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    script = (_JAX.format(inp=inp, wait=WAIT_S, f32=F32_FAMILIES) + jax_tail
              + '\nprint("JAX_TP_BASELINES_OK")\n')
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        got = run_ranks(ranks, 4, args=(corners, out_dir, bs, *extra))
        stdout, stderr = proc.communicate(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "JAX_TP_BASELINES_OK" in stdout, stderr[-4000:]
    ref = {}
    for name in corners:
        with open(os.path.join(out_dir, name + ".pkl"), "rb") as fh:
            ref[name] = pickle.load(fh)
    return ref, got


def _close(got: np.ndarray, want: np.ndarray, tol, what):
    rtol, atol = tol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * float(np.abs(want).max()),
                               err_msg=what)


def check_corner(ref, ranks, corners, name):
    """Every check of the module docstring on one corner."""
    arch, layers, comp, kw, n_dp, tp = corners[name]
    cfg = corner_cfg(arch, layers)
    spec = specs.infer_param_specs(cfg, tp)[2]
    rep = [k for k, d in spec.items() if d is None]
    for i, want in enumerate(ref[name]):
        where = f"{name} step {i}"
        p_tol, ef_tol = TOL[comp]
        if i >= 2 and comp in SECOND_ROUND:  # from the carried residual: 10x
            p_tol, ef_tol = ((10 * r, 10 * a) for r, a in (p_tol, ef_tol))
        got = [r[name][i] for r in ranks]
        for rank, g in enumerate(got):
            if cfg.family in F32_FAMILIES:
                np.testing.assert_allclose(g["own_loss"], g["jloss"], rtol=2e-6, err_msg=where)
                jgrads = want["grads"][divmod(rank, tp)][1]
                for k, v in g["own"].items():
                    err = rel_l2({k: v}, jgrads)
                    assert err < 1e-4, (where, rank, k, err)
            else:
                np.testing.assert_allclose(g["own_loss"], g["jloss"], rtol=2e-2, err_msg=where)
                assert g["grad_err"] < 3e-2, (where, rank, g["grad_err"])
            np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-6, err_msg=where)
            assert g["max_int"] == want["max_int"], (where, rank, g["max_int"], want["max_int"])
        if want["alphas"]:
            jal = want["alphas"][(0, 0)]
            for g in got:
                for k, v in g["alphas"].items():
                    np.testing.assert_allclose(v, jal[k], rtol=1e-6, err_msg=f"{where} {k}")
        # the dp replicas of each shard, and each replicated leaf across the
        # model group, bit-identical
        for rank in range(n_dp * tp):
            a, b = got[rank], got[rank % tp]
            assert all(torch.equal(a["params"][k], b["params"][k]) for k in spec), (where, rank)
            m0 = got[rank - rank % tp]
            assert all(torch.equal(a["params"][k], m0["params"][k]) for k in rep), (where, rank)
            if a["ef"] is not None:
                assert all(torch.equal(a["ef"][k], m0["ef"][k]) for k in rep), (where, rank)
        # the gathered params and error feedback against JAX's global arrays
        full = gather_shards([g["params"] for g in got[:tp]], spec)
        assert set(full) == set(want["params"])
        for k, p in full.items():
            _close(p.numpy(), want["params"][k], p_tol, f"{where} params {k}")
        if ef_tol is not None and i > 0:
            jef = params_from_jax(per_worker(comp, want["comp"]), "cpu")
            for d in range(n_dp):
                ef = gather_shards([g["ef"] for g in got[d * tp:(d + 1) * tp]], spec, lead=1)
                for k, v in ef.items():
                    _close(v.numpy(), jef[k][d:d + 1].numpy(), ef_tol,
                           f"{where} ef {k} replica {d}")


def jax_corners():
    return {name: (arch, layers, comp, kw, *GRID)
            for name, (arch, layers, comp, kw) in CORNERS.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    corners = jax_corners()
    ref, ranks = run_both(tmp_path_factory.mktemp("tp_baselines"), corners)
    return corners, ref, ranks


@pytest.mark.parametrize("name", list(CORNERS))
def test_tp_baseline_step_matches_jax(runs, name):
    corners, ref, ranks = runs
    check_corner(ref, ranks, corners, name)


def test_reference_losses_at_step_2(runs):
    """JAX's step-2 losses on this grid (the first compressed step's update
    seen): every compressor's own, none equal to another's."""
    _, ref, _ = runs
    losses = {name: ref[name][2]["loss"] for name in CORNERS}
    for name, recs in ref.items():
        assert recs[0]["loss"] == ref["qsgd"][0]["loss"], name  # step 0 is exact
        assert all(np.isfinite(r["loss"]) for r in recs), name
    np.testing.assert_allclose(losses["qsgd"], losses["qsgd-packed8"], rtol=1e-6)
    assert len({round(v, 6) for k, v in losses.items() if k != "qsgd-packed8"}) == 4


def test_qsgd_decodes_each_shard_with_its_own_norm(runs):
    """A reference behaviour at tp > 1: QSGD scales each shard's levels by
    that shard's own norm, so the global leaf is decoded with tp norms.
    On the step-1 decode of ``layers/mlp/w_down`` (sharded on its rows):
    each rank's ĝ equals a numpy evaluation with the shard's norm and
    JAX's uniforms (rtol 1e-6, tp = 1's tolerance), and the same with the
    whole leaf's norm differs from it by more than 1e-2 relative."""
    corners, ref, ranks = runs
    rec, leaf = ref["qsgd"][1], "layers/mlp/w_down"
    j = sorted(rec["params"]).index(leaf)
    for m in range(GRID[1]):
        shards = [rec["grads"][(d, m)][1][leaf].astype(np.float32) for d in range(GRID[0])]
        whole = [np.sqrt(sum(np.sum(rec["grads"][(d, t)][1][leaf].astype(np.float64) ** 2)
                             for t in range(GRID[1]))) for d in range(GRID[0])]

        def decode(norms):
            out = []
            for d, g in enumerate(shards):
                scaled = np.abs(g) / np.float32(norms[d]) * 64
                lo = np.floor(scaled)
                q = lo + (rec["uniforms"][(d, j)] < scaled - lo)
                out.append(q * np.sign(g) * (np.float32(norms[d]) / 64))
            return (out[0] + out[1]) / 2

        own = decode([np.sqrt(np.sum(g.astype(np.float64) ** 2)) + 1e-30 for g in shards])
        for d in range(GRID[0]):
            got = ranks[d * GRID[1] + m]["qsgd"][1]["ghat"][leaf].numpy()
            np.testing.assert_allclose(got, own, rtol=1e-6, atol=1e-6 * np.abs(own).max())
            other = decode(whole)
            assert np.linalg.norm(other - got) > 1e-2 * np.linalg.norm(got), (m, d)


def test_topk_keeps_k_of_each_shard(runs):
    """A reference behaviour at tp > 1: TopK keeps k = k_frac × the local
    size on each shard. After step 1 (the error feedback was zero before
    it) each data replica's residual on each shard is zero at exactly k
    coordinates of nonzero gradient (the sent ones), in JAX's global array
    and in the port's rows alike."""
    _, ref, ranks = runs
    rec = ref["topk"][1]
    spec = specs.infer_param_specs(corner_cfg("granite-8b", 2), 2)[2]
    jef = params_from_jax(rec["comp"], "cpu")
    for k, v in jef.items():
        if spec[k] is None:
            continue
        local = v.shape[1 + spec[k]] // GRID[1]
        for d in range(GRID[0]):
            for m in range(GRID[1]):
                live = torch.from_numpy(rec["grads"][(d, m)][1][k]) != 0
                kk = max(1, int(0.01 * live.numel()))
                part = v[d].narrow(spec[k], m * local, local)
                assert int(((part == 0) & live).sum()) == kk, (k, d, m)
                mine = ranks[d * GRID[1] + m]["topk"][1]["ef"][k][0]
                assert int(((mine == 0) & live).sum()) == kk, (k, d, m)
