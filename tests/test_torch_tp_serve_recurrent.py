"""Port vs JAX: the serve path of the hybrid, ssm and encdec families at
tp = 2, on a 2 × 2 (data × model) grid (zamba2-2.7b, xlstm-125m and
seamless-m4t-medium smoke configs: 1 of 2 Mamba2 heads, 2 of 4 xLSTM
heads, 2 of 4 attention heads a rank).

1. The decode step at float32 activations and cache, 8 teacher-forced
   steps of a global batch of 4 (seamless's cross cache prefilled from 16
   frames first): each rank's vocab-local logits, its ``tp_greedy`` tokens
   and every cache leaf against the JAX package's ``lm_decode_step`` or
   ``encdec_prefill`` + ``encdec_decode_step`` inside a ``shard_map``
   whose cache specs the test writes itself (the reference's table with
   each recurrent ``h`` state's own batch and head axes), at rtol 1e-5 and
   atol 1e-5 of the largest |value| (the same products summed in another
   order), the int32 leaves and the tokens equal.
2. ``build_serve_step``'s prefill (bf16, as served): each rank's
   vocab-local logits against the JAX package's jitted prefill within 2e-2
   of the largest logit.
3. ``build_serve_step``'s decode (bf16): each sequence's greedy stream
   against the JAX package's jitted ``build_serve_step`` decode, up to the
   first step whose top-2 gap in the JAX teacher's bf16 logits is under
   2e-2 of the largest logit. The reference's own serve step is measured
   against its ``shard_map`` teacher (its cache table puts a stacked
   ``h``'s data and model axes on the layer axes, ROADMAP's reference
   behaviours): the streams are equal, so the port is held to the served
   one.
4. The sequence-sharded decode (a global batch of 1 under 2 data replicas,
   16 slots split 8 a shard, 12 steps): the hybrid's shared-block KV cache
   sharded over the data group, its recurrent states whole on each shard;
   the encoder-decoder's self-attention cache sharded and its cross cache
   a whole copy on each shard (the reference's cross attention has no
   ``axes.sp`` branch: each shard's ``encdec_prefill`` fills its own copy).
   Each against JAX's ``shard_map`` teacher, the unsharded tp = 2 decode of
   the same batch, and for seamless the tp = 1 decode.
5. seamless computes the same function at every tp: its tp = 2 logits (and
   JAX's) equal the port's tp = 1 decode of the same global params.

The JAX side runs in one subprocess on a forced 4-device (2, 2) mesh while
the port's runs on one 4-rank gloo spawn.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.step import build_serve_step  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.common import Axes  # noqa: E402
from repro_torch.models.decode import init_lm_cache, lm_decode_step, tp_greedy  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("zamba2-2.7b", "xlstm-125m", "seamless-m4t-medium")
SP_ARCHS = ("zamba2-2.7b", "seamless-m4t-medium")
B, S, STEPS = 4, 16, 8  # global batch, slots, decode steps
T_SRC = S  # seamless's frames: its cross cache fills the serve step's S slots
SP_S, SP_STEPS = 16, 12  # the sequence-sharded decode: 8 slots a shard
PROMPT_T = 5  # the prefill's prompt length
NEAR_TIE = 2e-2  # of the largest |logit|: the bf16 streams' near-tie bound


def _cfg(arch):
    return smoke_config(get_arch(arch))


def _encdec(cfg):
    return cfg.family == "encdec"


def _global_params(arch):
    """The global params padded for tp = 2, float32, from a seeded draw."""
    cfg, gen = _cfg(arch), torch.Generator().manual_seed(7)
    init = encdec.init_encdec_params if _encdec(cfg) else init_lm_params
    return init(cfg, generator=gen, device="cpu", dtype=torch.float32, tp=2)


def _inputs():
    rng = np.random.default_rng(13)
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        a = dict(params={k: v.numpy() for k, v in _global_params(arch).items()},
                 tokens=rng.integers(0, 256, (STEPS, B)).astype(np.int32),
                 prompt=rng.integers(0, 256, (B, PROMPT_T)).astype(np.int32),
                 sp_tokens=rng.integers(0, 256, (SP_STEPS, 1)).astype(np.int32))
        if _encdec(cfg):
            a["frames"] = rng.standard_normal((B, T_SRC, cfg.frontend_dim)).astype(np.float32)
            a["sp_frames"] = rng.standard_normal((1, T_SRC, cfg.frontend_dim)).astype(
                np.float32)
        out[arch] = a
    return out


_JAX = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import ShapeConfig, get_arch, smoke_config
from repro.launch import specs as jspecs
from repro.launch.step import build_serve_step
from repro.models.common import Axes
from repro.models.decode import init_lm_cache, lm_decode_step, tp_greedy
from repro.models.encdec import encdec_decode_step, encdec_prefill, init_encdec_cache
from repro.parallel.collectives import sharded_jit

inp = pickle.load(open({inp!r}, "rb"))
B, S, STEPS, SP_S, SP_STEPS = {consts!r}
mesh = jax.make_mesh((2, 2), ("data", "model"))
TP = Axes(tp="model", tp_size=2)
SP = Axes(tp="model", tp_size=2, sp=("data",), sp_sizes=(2,))

def nest(flat):
    out = {{}}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {{}})
        d[last] = jnp.asarray(v)
    return out

def flat(tree):
    return {{"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}

def own_specs(cache, seq_sharded):
    # the reference's table, with each "h" state's own batch and head axes
    # (the table leaves h's rank open and labels a stacked state's layer axes)
    table = jspecs.cache_pspecs(cache, dp=("data",), seq_sharded=seq_sharded)

    def fix(path, leaf, spec):
        if path[-1].key != "h":
            return spec
        extra = leaf.ndim - (4 if path[0].key == "mamba" else 3)
        parts = [None] * leaf.ndim
        if not seq_sharded:
            parts[extra] = "data"
        parts[extra + 1] = "model"
        return P(*parts)

    return jax.tree_util.tree_map_with_path(fix, cache, table)

def empty_cache(cfg, b, s, dtype, n_shards=1):
    if cfg.family == "encdec":
        return init_encdec_cache(cfg, 2, n_shards, b, s, s, dtype)
    return init_lm_cache(cfg, 2, n_shards, b, s, dtype)

def prefilled(cfg, params, cache, cspecs, frames, axes, seq_sharded, dtype):
    # every shard's encoder run and cross cache (a whole copy on a sequence shard)
    fspec = P() if seq_sharded else P("data")
    pspecs = jspecs.infer_param_specs(cfg, 2)[2]
    fill = sharded_jit(lambda p, f: encdec_prefill(p, f, {{}}, axes, cfg, dtype)["cross"],
                       mesh, (pspecs, fspec), cspecs["cross"])
    return dict(cache, cross=fill(params, jnp.asarray(frames)))

def teacher(cfg, params, axes, b, s, tokens, seq_sharded, dtype, frames=None, first=None):
    # teacher-forced on tokens, or greedy from first
    cache = empty_cache(cfg, b, s, dtype)
    cspecs = own_specs(cache, seq_sharded)
    if frames is not None:
        cache = prefilled(cfg, params, cache, cspecs, frames, axes, seq_sharded, dtype)
    pspecs = jspecs.infer_param_specs(cfg, 2)[2]
    tok = P() if seq_sharded else P("data")
    lspec = P(None, "model") if seq_sharded else P("data", "model")
    step = encdec_decode_step if cfg.family == "encdec" else lm_decode_step

    def body(p, c, t, q):
        logits, c = step(p, c, t, q, axes, cfg, dtype=dtype)
        return logits, tp_greedy(logits, axes), c

    fn = sharded_jit(body, mesh, (pspecs, cspecs, tok, tok), (lspec, tok, cspecs))
    logits, toks, t = [], [], first
    for i in range(STEPS if tokens is None else len(tokens)):
        t = jnp.asarray(tokens[i] if tokens is not None else t)
        lg, t, cache = fn(params, cache, t, jnp.full((b,), i, jnp.int32))
        logits.append(np.asarray(lg))
        toks.append(np.asarray(t))
    return dict(logits=np.stack(logits), toks=np.stack(toks), cache=flat(cache))

def served(cfg, params, first, frames):
    # the reference's build_serve_step decode on its own cache table: each
    # rank's empty local cache tiled over the table's data and model axes
    art = build_serve_step(cfg, mesh, ShapeConfig("s", S, B, "decode"))
    local = empty_cache(cfg, B // 2, S, jnp.bfloat16, n_shards=2)
    table = jspecs.cache_pspecs(local, dp=("data",), seq_sharded=False)
    cache = jax.tree.map(lambda x, sp: jnp.tile(x, [1 if a is None else 2 for a in
                                                    tuple(sp) + (None,) * x.ndim][:x.ndim]),
                         local, table)
    assert jax.tree.map(lambda x: x.shape, cache) == jax.tree.map(lambda x: x.shape,
                                                                  art.arg_structs[1])
    if frames is not None:
        cache = prefilled(cfg, params, cache, table, frames, TP, False, jnp.bfloat16)
    stream, tok = [], jnp.asarray(first)
    for i in range(STEPS):
        tok, cache = art.jitted["decode"](params, cache, tok, jnp.full((B,), i, jnp.int32))
        stream.append(np.asarray(tok))
    return np.stack(stream)

out = {{}}
for arch, a in inp.items():
    cfg = smoke_config(get_arch(arch))
    enc = cfg.family == "encdec"
    params = nest(a["params"])
    pb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    frames = a.get("frames")
    out[arch] = teacher(cfg, params, TP, B, S, a["tokens"], False, jnp.float32, frames)
    first = a["prompt"][:, 0]
    bf = teacher(cfg, pb, TP, B, S, None, False, jnp.bfloat16, frames, first=first)
    out[arch]["teacher_stream"], out[arch]["teacher_logits"] = bf["toks"], bf["logits"]
    out[arch]["stream"] = served(cfg, pb, first, frames)
    t_pre = S if enc else a["prompt"].shape[1]
    pre = build_serve_step(cfg, mesh, ShapeConfig("s", t_pre, B, "prefill"))
    batch = ({{"frames": jnp.asarray(frames, jnp.bfloat16)}} if enc
             else {{"tokens": jnp.asarray(a["prompt"])}})
    out[arch]["prefill"] = np.asarray(pre.jitted["prefill"](pb, batch))
    if cfg.family in ("hybrid", "encdec"):
        out[arch]["sp"] = teacher(cfg, params, SP, 1, SP_S, a["sp_tokens"], True, jnp.float32,
                                  a.get("sp_frames"))
pickle.dump(out, open({outp!r}, "wb"))
print("JAX_SERVE_OK")
"""


def _rank_axes(grid, sp=False):
    kw = dict(sp=grid.data_group, sp_size=grid.n_dp, sp_index=grid.dp_index) if sp else {}
    return Axes(group=grid.model_group, tp_size=grid.tp, tp_index=grid.tp_index, **kw)


def _teacher(cfg, params, axes, b, s, tokens, rows, frames=None, tp=2):
    """Teacher-forced float32 decode of ``tokens``' ``rows`` (the cross
    cache prefilled from ``frames`` first): each step's logits, greedy
    tokens, and the cache."""
    if _encdec(cfg):
        cache = encdec.init_encdec_cache(cfg, b, s, s, device="cpu", dtype=torch.float32,
                                         tp=tp, n_shards=tp)
        cache = encdec.encdec_prefill(params, torch.from_numpy(frames), cache, cfg,
                                      torch.float32, axes)
        step = encdec.encdec_decode_step
    else:
        cache = init_lm_cache(cfg, b, s, device="cpu", dtype=torch.float32, tp=tp, n_shards=tp)
        step = lm_decode_step
    logits, toks = [], []
    for i, t in enumerate(tokens):
        lg, cache = step(params, cache, torch.from_numpy(t)[rows].long(), torch.full((b,), i),
                         cfg, torch.float32, axes)
        logits.append(lg)
        toks.append(tp_greedy(lg, axes))
    return dict(logits=torch.stack(logits), toks=torch.stack(toks), cache=cache)


def _ranks(group, rank, inp):
    grid = make_debug_mesh(2, 2)
    out = {}
    for arch, a in inp.items():
        cfg = _cfg(arch)
        enc = _encdec(cfg)
        params = specs.tp_shard(cfg, 2, grid.tp_index).tree(
            {k: torch.from_numpy(v) for k, v in a["params"].items()})
        rows = slice(grid.dp_index * B // 2, (grid.dp_index + 1) * B // 2)
        frames = a["frames"][rows] if enc else None
        out[arch] = _teacher(cfg, params, _rank_axes(grid), B // 2, S, a["tokens"], rows, frames)
        pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
        pre = build_serve_step(cfg, grid, ShapeConfig("s", S if enc else PROMPT_T, B, "prefill"),
                               device="cpu")
        batch = ({"frames": torch.from_numpy(a["frames"]).to(torch.bfloat16)} if enc
                 else {"tokens": torch.from_numpy(a["prompt"]).long()})
        out[arch]["prefill"] = pre.steps["prefill"](pb, batch)
        art = build_serve_step(cfg, grid, ShapeConfig("s", S, B, "decode"), device="cpu")
        cache = art.init_cache()
        out[arch]["cache_shapes"] = (art.cache_shapes, {k: tuple(v.shape)
                                                        for k, v in cache.items()})
        if enc:
            cache = encdec.encdec_prefill(pb, torch.from_numpy(a["frames"][art.rows]), cache,
                                          cfg, axes=art.axes)
        tok, stream = torch.from_numpy(a["prompt"][:, 0]).long(), []
        for i in range(STEPS):
            nxt, cache = art.steps["decode"](pb, cache, tok, torch.full((B,), i))
            tok = tok.clone()
            tok[art.rows] = nxt  # the rows this rank decodes; the others it never reads
            stream.append(nxt)
        out[arch]["stream"] = torch.stack(stream)
        if arch in SP_ARCHS:
            sp_frames = a.get("sp_frames")
            coll.reset_tp_counts()
            out[arch]["sp"] = _teacher(cfg, params, _rank_axes(grid, sp=True), 1, SP_S // 2,
                                       a["sp_tokens"], slice(0, 1), sp_frames)
            out[arch]["sp_counts"] = coll.tp_counts()
            out[arch]["sp_whole"] = _teacher(cfg, params, _rank_axes(grid), 1, SP_S,
                                             a["sp_tokens"], slice(0, 1), sp_frames)
            art = build_serve_step(cfg, grid, ShapeConfig("s", SP_S, 1, "decode"),
                                   dtype=torch.float32, device="cpu")
            cache, toks = art.init_cache(), []
            if enc:
                cache = encdec.encdec_prefill(params, torch.from_numpy(sp_frames), cache, cfg,
                                              torch.float32, art.axes)
            for i, t in enumerate(a["sp_tokens"]):
                nxt, cache = art.steps["decode"](params, cache, torch.from_numpy(t).long(),
                                                 torch.full((1,), i))
                toks.append(nxt)
            out[arch]["sp_serve"] = (art.seq_sharded, art.s_local, torch.stack(toks))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve_recurrent")
    inp = _inputs()
    inp_path, out_path = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp_path, "wb") as fh:
        pickle.dump(inp, fh)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    script = _JAX.format(inp=inp_path, outp=out_path, consts=(B, S, STEPS, SP_S, SP_STEPS))
    # the JAX side compiles while the port's ranks run
    jax_proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = run_ranks(_ranks, 4, args=(inp,))
        stdout, stderr = jax_proc.communicate(timeout=420)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0 and "JAX_SERVE_OK" in stdout, stderr[-4000:]
    with open(out_path, "rb") as fh:
        return inp, ranks, pickle.load(fh)


def _close(got, want, what, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=what)


def _local(want, tp_index, rows):
    """A rank's vocab-local slice of global logits (..., B, V)."""
    v = want.shape[-1] // 2
    return want[..., rows, tp_index * v:(tp_index + 1) * v]


def _check_cache(arch, got, want, c_specs, tp_index, rows=None, shard=None):
    """Every leaf of a rank's cache ``got`` against its slice of the global
    cache ``want`` (by its ``CacheSpec``: its ``rows``, or on a sequence
    shard its ``shard``'s slots, and its model index's heads)."""
    assert set(got) == set(want), arch
    for k, v in got.items():
        sp, w = c_specs[k], want[k]
        if sp.data is not None:
            n = v.shape[sp.data]
            start = rows.start if shard is None else shard * n
            w = np.take(w, range(start, start + n), axis=sp.data)
        if sp.model is not None:
            n = v.shape[sp.model]
            w = np.take(w, range(tp_index * n, (tp_index + 1) * n), axis=sp.model)
        assert w.shape == tuple(v.shape), (arch, k, w.shape, tuple(v.shape))
        if v.dtype == torch.int32:
            assert np.array_equal(v.numpy(), w), (arch, k)
        else:
            _close(v, w, f"{arch} cache {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_decode_step_matches_jax_shard_map(runs, arch):
    _, ranks, jout = runs
    cfg, want = _cfg(arch), jout[arch]
    c_specs = specs.cache_pspecs(specs.cache_shapes(cfg, 2, 2, B // 2, S), seq_sharded=False)
    for rank, r in enumerate(ranks):
        dp, tpi = divmod(rank, 2)
        rows = slice(dp * B // 2, (dp + 1) * B // 2)
        got = r[arch]
        _close(got["logits"], _local(want["logits"], tpi, rows), f"{arch} logits")
        assert np.array_equal(got["toks"].numpy(), want["toks"][:, rows]), arch
        _check_cache(arch, got["cache"], want["cache"], c_specs, tpi, rows=rows)
    # the TP members of a replica pick the same tokens
    assert torch.equal(ranks[0][arch]["toks"], ranks[1][arch]["toks"])
    declared, built = ranks[0][arch]["cache_shapes"]  # the serve step's cache
    assert declared == built and declared == specs.cache_shapes(cfg, 2, 2, B // 2, S)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(runs, arch):
    _, ranks, jout = runs
    jw = jout[arch]["prefill"]
    for rank, r in enumerate(ranks):
        dp, tpi = divmod(rank, 2)
        w = _local(jw, tpi, slice(dp * B // 2, (dp + 1) * B // 2))
        got = r[arch]["prefill"]
        assert got.shape == w.shape and torch.isfinite(got).all(), arch
        assert np.abs(got.numpy() - w).max() <= 2e-2 * np.abs(jw).max(), (arch, rank)


@pytest.mark.parametrize("arch", ("zamba2-2.7b", "xlstm-125m"))
def test_reference_serve_step_stream_equals_its_shard_map_teacher(runs, arch):
    """The JAX package's ``build_serve_step`` labels a stacked ``h``
    state's layer axes with the data and model axes; each device's local
    state still has its own shape and values, so its bf16 greedy stream
    equals the ``shard_map`` teacher's on the test's own table (ROADMAP's
    reference behaviours): the port's stream is held to the served one."""
    _, _, jout = runs
    assert np.array_equal(jout[arch]["stream"], jout[arch]["teacher_stream"]), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serve_step_matches_jax_up_to_the_first_near_tie(runs, arch):
    inp, ranks, jout = runs
    lg = jout[arch]["teacher_logits"][..., :_cfg(arch).vocab]  # (steps, B, V) bf16 teacher
    top = np.sort(lg, axis=-1)[..., -2:]
    gaps = (top[..., 1] - top[..., 0]) / np.abs(lg).max(axis=-1)
    port = torch.cat([ranks[0][arch]["stream"], ranks[2][arch]["stream"]], dim=1)
    assert torch.equal(ranks[0][arch]["stream"], ranks[1][arch]["stream"])
    assert torch.equal(ranks[2][arch]["stream"], ranks[3][arch]["stream"])
    compared = 0
    for row in range(B):  # each sequence up to its first near tie
        n = next((i for i in range(STEPS) if gaps[i, row] < NEAR_TIE), STEPS)
        assert np.array_equal(port[:n, row].numpy(), jout[arch]["stream"][:n, row]), (arch, row)
        compared += n
    # random smoke weights put near ties early in some sequences: at least one
    # compared token a sequence on average
    assert compared >= B, f"{arch}: near ties leave {compared} tokens to compare"


def _tp1_decode(arch, tokens, frames):
    """The port's tp = 1 float32 decode of the global params, teacher-forced."""
    cfg, params = _cfg(arch), _global_params(arch)
    b = tokens.shape[1]
    return _teacher(cfg, params, Axes(), b, S, tokens, slice(0, b), frames, tp=1)["logits"]


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_sequence_sharded_decode_matches_jax(runs, arch):
    inp, ranks, jout = runs
    cfg, want = _cfg(arch), jout[arch]["sp"]
    c_specs = specs.cache_pspecs(specs.cache_shapes(cfg, 2, 2, 1, SP_S // 2),
                                 seq_sharded=True)
    n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else cfg.dec_layers
    for rank, r in enumerate(ranks):
        dp, tpi = divmod(rank, 2)
        got = r[arch]["sp"]
        _close(got["logits"], _local(want["logits"], tpi, slice(0, 1)), f"{arch} sp logits")
        assert np.array_equal(got["toks"].numpy(), want["toks"]), arch
        _check_cache(arch, got["cache"], want["cache"], c_specs, tpi, shard=dp)
        # the same function as the unsharded tp = 2 decode of the same batch
        _close(got["logits"], r[arch]["sp_whole"]["logits"].numpy(), f"{arch} sp vs whole", 1e-4)
        # shard dp holds positions [8·dp, 8·dp + 8) of its self-attention cache
        kv_pos = got["cache"]["attn/kv_pos" if cfg.attn_every else "self/kv_pos"]
        n = SP_S // 2
        assert torch.equal(kv_pos[:, 0, :min(SP_STEPS - n * dp, n)],
                           torch.arange(n * dp, min(SP_STEPS, n * dp + n),
                                        dtype=torch.int32).expand(n_attn, -1)), (arch, rank)
        # one pmax and two psums over the data group an attention and step
        counts = r[arch]["sp_counts"]
        assert counts.get("pmax_sp") == SP_STEPS * n_attn, counts
        assert counts.get("psum_sp") == 2 * SP_STEPS * n_attn, counts
        seq_sharded, s_local, toks = r[arch]["sp_serve"]
        assert seq_sharded and s_local == n
        assert torch.equal(toks[:, 0], got["toks"][:, 0]), arch
    if _encdec(cfg):  # the same function as tp = 1
        ref = _tp1_decode(arch, inp[arch]["sp_tokens"], inp[arch]["sp_frames"])
        v = ref.shape[-1] // 2
        for rank, r in enumerate(ranks):
            tpi = rank % 2
            _close(r[arch]["sp"]["logits"], ref[..., tpi * v:(tpi + 1) * v].numpy(),
                   "seamless sp vs tp = 1", 1e-4)


def test_encdec_tp2_logits_equal_tp1(runs):
    """seamless computes the same function at every tp: the grid's logits
    (the port's ranks' and JAX's) against the port's tp = 1 decode."""
    inp, ranks, jout = runs
    arch = "seamless-m4t-medium"
    ref = _tp1_decode(arch, inp[arch]["tokens"], inp[arch]["frames"]).numpy()
    np.testing.assert_allclose(jout[arch]["logits"], ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    for rank, r in enumerate(ranks):
        dp, tpi = divmod(rank, 2)
        _close(r[arch]["logits"], _local(ref, tpi, slice(dp * B // 2, (dp + 1) * B // 2)),
               f"seamless rank {rank} vs tp = 1")
