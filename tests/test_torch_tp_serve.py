"""Port vs JAX: the serve path at tp = 2, on a 2 × 2 (data × model) grid.

1. The decode cache's shapes and specs (``specs.cache_shapes``,
   ``cache_pspecs``, ``batch_pspecs``) against the JAX package's, for
   every decoder-only family and the encoder-decoder at tp in {1, 2},
   batch- and sequence-sharded.
2. ``lm_decode_step`` at tp = 2 on the granite-8b and deepseek-v2-lite-16b
   smoke configs (GQA and MLA, the SwiGLU and ``moe_ep``), float32
   activations and cache, 8 teacher-forced steps of a global batch of 4:
   each rank's vocab-local logits, its cache and its ``tp_greedy`` tokens
   against the JAX package's ``lm_decode_step`` (``dtype=float32``) inside
   its ``shard_map``, at rtol 1e-5 (the same products summed in another
   order), the tokens equal.
3. ``build_serve_step`` (bf16, as served): the prefill's vocab-local logits
   against the JAX package's jitted prefill (and, for granite, the tp = 1
   forward of the same global params) within 2e-2 of the largest logit,
   and the decode's
   greedy streams against the JAX package's jitted ``build_serve_step``
   decode and the port's tp = 1 decode, each sequence equal up to the first
   step whose tp = 1 top-2 gap is under 2e-2 of the largest logit (bf16 sums in
   another order may swap a near tie; JAX's jitted bf16 decode sits a few
   bf16 ULPs from an un-jitted one).
4. The sequence-sharded decode (a global batch of 1 under 2 data
   replicas, 16 slots split 8 a shard, 12 steps so that writes land on both
   shards): the logits against the tp = 1 decode of the same params and
   against JAX's ``attention_decode`` ``axes.sp`` branch under
   ``shard_map``; ``pmax_sp``/``psum_sp`` counted.
5. MLA on a sequence-sharded cache: the JAX package's ``build_serve_step``
   writes every position past S_loc into each shard's last slot (the
   history there is lost, ROADMAP's reference behaviours); the port
   refuses it by name.
6. ``tp_greedy`` on constructed logits with a tie across the vocab shards:
   the tied ids are summed, in both packages.
7. The engine's replicated ``mesh=`` route: every rank's tokens agree and
   equal the single-process engine's.

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
from repro_torch.models.common import Axes  # noqa: E402
from repro_torch.models.decode import init_lm_cache, lm_decode_step, tp_greedy  # noqa: E402
from repro_torch.models.transformer import init_lm_params, lm_forward, lm_logits  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-8b", "deepseek-v2-lite-16b")
B, S, STEPS = 4, 16, 8  # global batch, slots, decode steps
SP_S, SP_STEPS = 16, 12  # the sequence-sharded decode: 8 slots a shard
MLA_S, MLA_STEPS = 8, 6
PROMPT_T = 5  # the prefill's prompt length
NEAR_TIE = 2e-2  # of the largest |logit|: the bf16 streams' near-tie bound
TIE_LOGITS = np.array([[-1, 3, 0, 0, 0, 0, 3, 0],  # 3 at id 1 (shard 0) and 6 (shard 1)
                       [0, 0, 5, 0, 1, 1, 1, 1],  # on shard 0 alone
                       [4, 0, 0, 4, 0, 4, 0, 0]],  # twice on shard 0, once on 1
                      dtype=np.float32)


def _cfg(arch):
    return smoke_config(get_arch(arch))


def _global_params(arch):
    """The global params padded for tp = 2, float32, from a seeded draw."""
    return init_lm_params(_cfg(arch), generator=torch.Generator().manual_seed(5),
                          device="cpu", dtype=torch.float32, tp=2)


def _inputs():
    rng = np.random.default_rng(11)
    return {arch: dict(params={k: v.numpy() for k, v in _global_params(arch).items()},
                       tokens=rng.integers(0, 256, (STEPS, B)).astype(np.int32),
                       prompt=rng.integers(0, 256, (B, PROMPT_T)).astype(np.int32),
                       sp_tokens=rng.integers(0, 256, (SP_STEPS, 1)).astype(np.int32))
            for arch in ARCHS}


_JAX = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import ShapeConfig, get_arch, smoke_config
from repro.launch import specs as jspecs
from repro.launch.step import build_serve_step
from repro.models.common import Axes
from repro.models.decode import init_lm_cache, lm_decode_step, tp_greedy
from repro.parallel.collectives import sharded_jit

inp = pickle.load(open({inp!r}, "rb"))
B, S, STEPS, SP_S, SP_STEPS, MLA_S, MLA_STEPS = {consts!r}
mesh = jax.make_mesh((2, 2), ("data", "model"))

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

def teacher(cfg, params, axes, b, s, tokens, seq_sharded):
    cache = init_lm_cache(cfg, 2, 1, b, s, jnp.float32)
    cspecs = jspecs.cache_pspecs(cache, dp=("data",), seq_sharded=seq_sharded)
    pspecs = jspecs.infer_param_specs(cfg, 2)[2]
    tok = P() if seq_sharded else P("data")
    lspec = P(None, "model") if seq_sharded else P("data", "model")

    def body(p, c, t, q):
        logits, c = lm_decode_step(p, c, t, q, axes, cfg, dtype=jnp.float32)
        return logits, tp_greedy(logits, axes), c

    fn = sharded_jit(body, mesh, (pspecs, cspecs, tok, tok), (lspec, tok, cspecs))
    logits, toks = [], []
    for i in range(len(tokens)):
        lg, tk, cache = fn(params, cache, jnp.asarray(tokens[i]), jnp.full((b,), i, jnp.int32))
        logits.append(np.asarray(lg))
        toks.append(np.asarray(tk))
    return dict(logits=np.stack(logits), toks=np.stack(toks), cache=flat(cache))

out = {{}}
for arch, a in inp["archs"].items():
    cfg = smoke_config(get_arch(arch))
    params = nest(a["params"])
    axes = Axes(tp="model", tp_size=2)
    out[arch] = teacher(cfg, params, axes, B, S, a["tokens"], False)
    # the served step (bf16), its greedy stream from the prompts' last token
    art = build_serve_step(cfg, mesh, ShapeConfig("s", S, B, "decode"))
    fn = art.jitted["decode"]
    pb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    cache = init_lm_cache(cfg, 2, 1, B, S)
    stream, tok = [], jnp.asarray(a["prompt"][:, 0])
    for i in range(STEPS):
        tok, cache = fn(pb, cache, tok, jnp.full((B,), i, jnp.int32))
        stream.append(np.asarray(tok))
    out[arch]["stream"] = np.stack(stream)
    pre = build_serve_step(cfg, mesh, ShapeConfig("s", a["prompt"].shape[1], B, "prefill"))
    out[arch]["prefill"] = np.asarray(pre.jitted["prefill"](pb, {{"tokens": jnp.asarray(
        a["prompt"])}}))
    if cfg.kv_lora:
        # MLA under a sequence-sharded cache: what the reference's cache holds
        art = build_serve_step(cfg, mesh, ShapeConfig("s", MLA_S, 1, "decode"))
        cache = init_lm_cache(cfg, 2, 1, 1, MLA_S)
        for i in range(MLA_STEPS):
            _, cache = art.jitted["decode"](pb, cache, jnp.asarray(a["sp_tokens"][i]),
                                            jnp.full((1,), i, jnp.int32))
        out["mla_sp_kv_pos"] = np.asarray(cache["layers"]["kv_pos"])
    else:
        out["sp"] = teacher(cfg, params, Axes(tp="model", tp_size=2, sp=("data",),
                                              sp_sizes=(2,)),
                            1, SP_S, a["sp_tokens"], True)

tie = sharded_jit(lambda l: tp_greedy(l, Axes(tp="model", tp_size=2)), mesh,
                  (P(None, "model"),), P())
out["tie"] = np.asarray(tie(jnp.asarray(inp["tie"])))
pickle.dump(out, open({outp!r}, "wb"))
print("JAX_SERVE_OK")
"""


def _rank_axes(grid, sp=False):
    kw = dict(sp=grid.data_group, sp_size=grid.n_dp, sp_index=grid.dp_index) if sp else {}
    return Axes(group=grid.model_group, tp_size=grid.tp, tp_index=grid.tp_index, **kw)


def _teacher(cfg, params, axes, b, s, tokens, rows):
    cache = init_lm_cache(cfg, b, s, device="cpu", dtype=torch.float32, tp=2, n_shards=2)
    logits, toks = [], []
    for i, t in enumerate(tokens):
        lg, cache = lm_decode_step(params, cache, torch.from_numpy(t)[rows].long(),
                                   torch.full((b,), i), cfg, torch.float32, axes)
        logits.append(lg)
        toks.append(tp_greedy(lg, axes))
    return dict(logits=torch.stack(logits), toks=torch.stack(toks), cache=cache)


def _ranks(group, rank, inp):
    grid = make_debug_mesh(2, 2)
    out = {}
    for arch, a in inp.items():
        cfg = _cfg(arch)
        shard = specs.tp_shard(cfg, 2, grid.tp_index)
        params = shard.tree({k: torch.from_numpy(v) for k, v in a["params"].items()})
        rows = slice(grid.dp_index * B // 2, (grid.dp_index + 1) * B // 2)
        out[arch] = _teacher(cfg, params, _rank_axes(grid), B // 2, S, a["tokens"], rows)
        pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
        pre = build_serve_step(cfg, grid, ShapeConfig("s", PROMPT_T, B, "prefill"),
                               device="cpu")
        out[arch]["prefill"] = pre.steps["prefill"](pb, {"tokens": torch.from_numpy(
            a["prompt"]).long()})
        art = build_serve_step(cfg, grid, ShapeConfig("s", S, B, "decode"), device="cpu")
        cache, tok, stream = art.init_cache(), torch.from_numpy(a["prompt"][:, 0]).long(), []
        out[arch]["cache_shapes"] = (art.cache_shapes, {k: tuple(v.shape)
                                                        for k, v in cache.items()})
        for i in range(STEPS):
            nxt, cache = art.steps["decode"](pb, cache, tok, torch.full((B,), i))
            tok = tok.clone()
            tok[art.rows] = nxt  # the rows this rank decodes; the others it never reads
            stream.append(nxt)
        out[arch]["stream"] = torch.stack(stream)
        out[arch]["rows"] = (art.rows.start, art.rows.stop)
        if cfg.kv_lora:
            try:
                build_serve_step(cfg, grid, ShapeConfig("s", MLA_S, 1, "decode"), device="cpu")
                out["mla_sp"] = None
            except NotImplementedError as e:
                out["mla_sp"] = str(e)
        else:
            coll.reset_tp_counts()
            out["sp"] = _teacher(cfg, params, _rank_axes(grid, sp=True), 1, SP_S // 2,
                                 a["sp_tokens"], slice(0, 1))
            out["sp_counts"] = coll.tp_counts()
            art = build_serve_step(cfg, grid, ShapeConfig("s", SP_S, 1, "decode"),
                                   dtype=torch.float32, device="cpu")
            cache, toks = art.init_cache(), []
            for i, t in enumerate(a["sp_tokens"]):
                nxt, cache = art.steps["decode"](params, cache, torch.from_numpy(t).long(),
                                                 torch.full((1,), i))
                toks.append(nxt)
            out["sp_serve"] = (art.seq_sharded, art.s_local, torch.stack(toks))
    v_loc = TIE_LOGITS.shape[1] // 2
    tie = torch.from_numpy(TIE_LOGITS[:, grid.tp_index * v_loc:(grid.tp_index + 1) * v_loc])
    out["tie"] = tp_greedy(tie, _rank_axes(grid))
    # the replicated engine: every rank serves the same requests, whole params
    cfg = _cfg("granite-8b")
    full = {k: torch.from_numpy(v) for k, v in inp["granite-8b"]["params"].items()}
    out["engine"] = _engine(cfg, full, mesh=group)
    return out


def _engine(cfg, params, mesh=None):
    """Three requests through two slots: each request's tokens."""
    eng = ServeEngine(cfg, params, slots=2, max_seq=32, device="cpu", mesh=mesh)
    reqs = [Request(rid=r, prompt=[3 + r, 7, 11 + r], max_new=5) for r in range(3)]
    for req in reqs:
        eng.submit(req)
    eng.run()
    return [req.out for req in reqs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")
    inp = _inputs()
    inp_path, out_path = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp_path, "wb") as fh:
        pickle.dump({"archs": inp, "tie": TIE_LOGITS}, fh)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    script = _JAX.format(inp=inp_path, outp=out_path,
                         consts=(B, S, STEPS, SP_S, SP_STEPS, MLA_S, MLA_STEPS))
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


# ---------------------------------------------------------------------------
# 1. the cache's shapes and specs, from shapes only
# ---------------------------------------------------------------------------

CACHE_ARCHS = ("granite-8b", "deepseek-v2-lite-16b", "mixtral-8x22b", "h2o-danube-3-4b",
               "internvl2-2b", "zamba2-2.7b", "xlstm-125m", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", CACHE_ARCHS)
@pytest.mark.parametrize("seq_sharded", (False, True))
def test_cache_shapes_and_specs_match_jax(arch, seq_sharded):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_arch as jget_arch, smoke_config as jsmoke
    from repro.launch import specs as jspecs

    jcfg, cfg = jsmoke(jget_arch(arch)), _cfg(arch)
    for tp in (1, 2):
        for n_shards in (1, tp):
            got = specs.cache_shapes(cfg, tp, n_shards, 2, 8)
            want = {"/".join(p.key for p in path): v for path, v in
                    jax.tree_util.tree_flatten_with_path(
                        jspecs.cache_shapes(jcfg, tp, n_shards, 2, 8))[0]}
            assert got == {k: tuple(v.shape) for k, v in want.items()}
        local = jspecs.cache_shapes(jcfg, tp, tp, 2, 8)
        jp = jspecs.cache_pspecs(local, dp=("data",), seq_sharded=seq_sharded)
        jp = {"/".join(p.key for p in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(jp, is_leaf=lambda x: isinstance(x, P))[0]}
        tps = specs.cache_pspecs(specs.cache_shapes(cfg, tp, tp, 2, 8), seq_sharded=seq_sharded)
        for k, spec in tps.items():
            if k.endswith("/h"):  # the JAX table counts the stacked axes as the state's own
                lead = len(got[k]) - (4 if k.startswith("mamba/") else 3)
                assert spec == (None if seq_sharded else lead, lead + 1), k
                continue
            parts = list(jp[k]) + [None] * (len(got[k]) - len(jp[k]))
            assert spec.data == next((i for i, a in enumerate(parts) if a == "data"), None), k
            assert spec.model == next((i for i, a in enumerate(parts) if a == "model"), None), k
    batch = {"tokens": (4, 8)}
    assert specs.batch_pspecs(batch, seq_sharded=seq_sharded) == {
        "tokens": None if seq_sharded else 0}


# ---------------------------------------------------------------------------
# 2-7. the runs
# ---------------------------------------------------------------------------

def _local_logits(want, grid_dp, tp_index, rows):
    v = want.shape[-1] // 2
    return want[..., rows, tp_index * v:(tp_index + 1) * v]


def _close(got, want, what, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_decode_step_matches_jax_shard_map(runs, arch):
    inp, ranks, jout = runs
    cfg = _cfg(arch)
    want = jout[arch]
    c_specs = specs.cache_pspecs(specs.cache_shapes(cfg, 2, 2, B // 2, S), seq_sharded=False)
    for rank, r in enumerate(ranks):
        dp, tpi = divmod(rank, 2)
        rows = slice(dp * B // 2, (dp + 1) * B // 2)
        got = r[arch]
        _close(got["logits"], _local_logits(want["logits"], dp, tpi, rows), f"{arch} logits")
        assert np.array_equal(got["toks"].numpy(), want["toks"][:, rows]), arch
        for k, v in got["cache"].items():
            w = want["cache"][k]
            sp = c_specs[k]
            w = np.take(w, range(rows.start, rows.stop), axis=sp.data)
            if sp.model is not None:
                n = v.shape[sp.model]
                w = np.take(w, range(tpi * n, (tpi + 1) * n), axis=sp.model)
            if v.dtype == torch.int32:
                assert np.array_equal(v.numpy(), w), (arch, k)
            else:
                _close(v, w, f"{arch} cache {k}")
    # the TP members of a replica pick the same tokens
    assert torch.equal(ranks[0][arch]["toks"], ranks[1][arch]["toks"])
    declared, built = ranks[0][arch]["cache_shapes"]  # the serve step's cache
    assert declared == built and declared == specs.cache_shapes(cfg, 2, 2, B // 2, S)


def _tp1_stream(arch, prompt0):
    """The tp = 1 bf16 greedy stream of the same global params and each
    step's top-2 gap over the largest |logit|."""
    cfg = _cfg(arch)
    params = {k: v.to(torch.bfloat16) for k, v in _global_params(arch).items()}
    cache = init_lm_cache(cfg, B, S, device="cpu")
    tok, stream, gaps = torch.from_numpy(prompt0).long(), [], []
    for i in range(STEPS):
        lg, cache = lm_decode_step(params, cache, tok, torch.full((B,), i), cfg)
        lg = lg[:, :cfg.vocab]
        top = torch.topk(lg, 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]) / lg.abs().max())
        tok = tp_greedy(lg)
        stream.append(tok)
    return torch.stack(stream), torch.stack(gaps)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serve_step_matches_jax_up_to_the_first_near_tie(runs, arch):
    inp, ranks, jout = runs
    ref, gaps = _tp1_stream(arch, inp[arch]["prompt"][:, 0])
    port = torch.cat([ranks[0][arch]["stream"], ranks[2][arch]["stream"]], dim=1)
    assert torch.equal(ranks[0][arch]["stream"], ranks[1][arch]["stream"])
    assert torch.equal(ranks[2][arch]["stream"], ranks[3][arch]["stream"])
    compared = 0
    for row in range(B):  # each sequence up to its first near tie
        n = next((i for i in range(STEPS) if gaps[i, row] < NEAR_TIE), STEPS)
        assert np.array_equal(port[:n, row].numpy(), jout[arch]["stream"][:n, row]), (arch, row)
        assert torch.equal(port[:n, row], ref[:n, row]), (arch, row)
        compared += n
    assert compared >= STEPS, f"{arch}: near ties leave {compared} tokens to compare"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax_and_the_tp1_forward(runs, arch):
    """Against the JAX package's jitted prefill (bf16) and, for the dense
    config, the tp = 1 forward of the same params (the MoE block's capacity
    is counted on each rank's slice of the tokens under ``moe_ep``, so its
    drops differ from tp = 1's, in both packages)."""
    inp, ranks, jout = runs
    cfg = _cfg(arch)
    jw = jout[arch]["prefill"]
    v = jw.shape[-1] // 2
    for rank, r in enumerate(ranks):
        dp, tpi = divmod(rank, 2)
        w = jw[dp * B // 2:(dp + 1) * B // 2, tpi * v:(tpi + 1) * v]
        assert np.abs(r[arch]["prefill"].numpy() - w).max() <= 2e-2 * np.abs(jw).max()
    if cfg.family == "moe":
        return
    params = {k: v.to(torch.bfloat16) for k, v in _global_params(arch).items()}
    prompt = torch.from_numpy(inp[arch]["prompt"]).long()
    with torch.no_grad():  # each data replica's rows alone: the MoE capacity counts them
        want = torch.cat([lm_logits(params, lm_forward(params, {"tokens": rows}, cfg)[:, -1:],
                                    cfg)[:, 0] for rows in prompt.split(B // 2)])
    v = want.shape[-1] // 2
    for rank, r in enumerate(ranks):
        dp, tpi = divmod(rank, 2)
        w = want[dp * B // 2:(dp + 1) * B // 2, tpi * v:(tpi + 1) * v]
        assert r[arch]["prefill"].shape == w.shape
        assert (r[arch]["prefill"] - w).abs().max() <= 2e-2 * want.abs().max(), (arch, rank)


def test_sequence_sharded_decode_matches_tp1_and_jax(runs):
    inp, ranks, jout = runs
    cfg = _cfg("granite-8b")
    params = _global_params("granite-8b")
    cache = init_lm_cache(cfg, 1, SP_S, device="cpu", dtype=torch.float32)
    ref = []
    for i, t in enumerate(inp["granite-8b"]["sp_tokens"]):
        lg, cache = lm_decode_step(params, cache, torch.from_numpy(t).long(), torch.full((1,), i),
                                   cfg, torch.float32)
        ref.append(lg)
    ref = torch.stack(ref)
    v = ref.shape[-1] // 2
    for rank, r in enumerate(ranks):
        dp, tpi = divmod(rank, 2)
        got = r["sp"]["logits"]
        _close(got, jout["sp"]["logits"][..., tpi * v:(tpi + 1) * v], "sp logits vs JAX")
        _close(got, ref[..., tpi * v:(tpi + 1) * v].numpy(), "sp logits vs tp = 1", 1e-4)
        assert np.array_equal(r["sp"]["toks"].numpy(), jout["sp"]["toks"])
        # shard dp holds positions [8·dp, 8·dp + 8): both shards were written
        kv_pos = r["sp"]["cache"]["layers/kv_pos"]
        assert torch.equal(kv_pos[:, 0, :SP_STEPS - 8 * dp if dp else 8],
                           torch.arange(8 * dp, min(SP_STEPS, 8 * dp + 8),
                                        dtype=torch.int32).expand(cfg.n_layers, -1))
        # one pmax and two psums over the data group a layer and step
        assert r["sp_counts"] == {"pmax_sp": SP_STEPS * cfg.n_layers,
                                  "psum_sp": 2 * SP_STEPS * cfg.n_layers,
                                  **{k: v for k, v in r["sp_counts"].items()
                                     if not k.endswith("_sp")}}
        seq_sharded, s_local, toks = r["sp_serve"]
        assert seq_sharded and s_local == SP_S // 2
        assert torch.equal(toks[:, 0], r["sp"]["toks"][:, 0])


def test_mla_on_sequence_shards_is_refused_where_the_reference_overwrites(runs):
    _, ranks, jout = runs
    # the reference: every shard writes position p at clip(p, 0, 3); the
    # positions past 3 overwrite slot 3 and positions 3, 4 are gone
    kv_pos = jout["mla_sp_kv_pos"]  # (L, 1, MLA_S), global: shard 0's slots then 1's
    for shard in range(2):
        assert kv_pos[0, 0, 4 * shard:4 * shard + 4].tolist() == [0, 1, 2, MLA_STEPS - 1]
    for r in ranks:
        assert r["mla_sp"] is not None and "sequence-sharded" in r["mla_sp"]


def test_tp_greedy_sums_the_ids_tied_across_vocab_shards(runs):
    _, ranks, jout = runs
    assert jout["tie"].tolist() == [1 + 6, 2, 0 + 5]
    for r in ranks:
        assert r["tie"].tolist() == jout["tie"].tolist()
    # at tp = 1 it is the argmax, ties to the first index
    assert tp_greedy(torch.from_numpy(TIE_LOGITS)).tolist() == [1, 2, 0]


def test_replicated_engine_tokens_agree_with_one_process(runs):
    inp, ranks, _ = runs
    full = {k: torch.from_numpy(v) for k, v in inp["granite-8b"]["params"].items()}
    want = _engine(_cfg("granite-8b"), full)
    for r in ranks:
        assert r["engine"] == want
