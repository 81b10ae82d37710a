"""The port on real processes: a ``torch.distributed`` (gloo) process group
of 4 ranks, spawned by ``repro_torch.parallel.spawn``, against the local
n-worker backend and against the JAX package's 4-device mesh.

1. The collectives, each bit for bit against the local backend's function:
   saturated packed8 fields and int32 words that wrap mod 2^32, int8 dense
   lanes at their extremes, a float payload refused, the bucketed wire equal
   to the serial one (dense8 and packed8, a ragged tail, several bucket
   sizes), pmax, pmax_global, the rank-ordered gathers and means (the mean's
   exchange and gather on ragged, multi-chunk, tiny and bf16 leaves).
2. Three train steps of granite-8b (smoke widths, 2 layers, seq 32, global
   batch 4) on 4 ranks against the local backend at n = 4, same seed: bit
   for bit on the losses, every rank's params after every step, α, max_int,
   each rank's ZeRO-1 master row against the local row w, and IntDIANA's
   h_local row and h_global. Four corners: ZeRO-1 SGD/IntSGD/packed8;
   ZeRO-1 AdamW/IntDIANA/dense8 with 2 pipelined microbatches (each
   microbatch's reduce async); fused SGD/IntSGD/packed8 on the bucketed
   wire; fused AdamW/IntSGD/dense8. The ranks and their local reference run
   one intra-op thread each (CPU BLAS results can depend on the count).
3. ZeRO-1 SGD/IntSGD/packed8 on 4 ranks against JAX's ``build_train_step``
   on its real (4, 1) mesh (``conftest.run_forced_mesh``), from the same
   weights, batches and per-worker encode seeds (the JAX side derives them
   in its subprocess with ``ops.seed_from_key`` over ``fold_worker_key``):
   losses within rtol 2e-2 and max_int within ±1 (XLA's and PyTorch's bf16
   forward round differently); dense8 and packed8 bit-identical on the
   ranks.
4. The CLI under ``torch.distributed.run`` with 2 processes, and its
   refusal of a ``--workers`` that is not the world size; ``dense16``
   refused on a 2-rank group, naming ``packed16``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.comm import CommCtx  # noqa: E402
from repro_torch.core.compressor import leaf_seeds, make_compressor  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMData  # noqa: E402
from repro_torch.launch.step import build_init_state, build_train_step  # noqa: E402
from repro_torch.launch.train import OPTIMIZERS  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_lm_params, params_from_jax, zero1_state_from_jax,
)
from repro_torch.optim.schedules import constant, warmup_wrap  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402
from repro_torch.wire import DenseInt, PackedInt, WireTransportError  # noqa: E402

N, SEQ, BATCH, STEPS = 4, 32, 4, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    return dataclasses.replace(smoke_config(get_arch("granite-8b")), n_layers=2)


class _one_thread:
    """The local reference at the ranks' thread count."""

    def __enter__(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.threads)


def _equal_trees(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# 1. the collectives
# ---------------------------------------------------------------------------

def _images():
    """Each worker's integer images of three ragged leaves, within the
    §5.1 clip of an 8-bit wire at n = 4 (lim 31), saturated at ±lim in
    their first two quarters."""
    rng = np.random.default_rng(11)
    shapes = {"a": (7, 33), "b": (101,), "c": (3, 5, 17)}
    out = []
    for _ in range(N):
        img = {}
        for k, s in shapes.items():
            v = rng.integers(-31, 32, s).astype(np.int32).reshape(-1)
            q = v.size // 4
            v[:q], v[q:2 * q] = 31, -31
            img[k] = torch.from_numpy(v.reshape(s))
        out.append(img)
    return out


def _wrap_words():
    """int32 words whose 4-worker sum wraps: 2^30 each (sum 2^32 = 0), the
    int32 extremes, and random full-range words."""
    rng = np.random.default_rng(12)
    out = []
    for _ in range(N):
        v = rng.integers(-(2**31), 2**31, 257, dtype=np.int64).astype(np.int32)
        v[:3] = (2**30, 2**31 - 1, -(2**31))
        out.append({"w": torch.from_numpy(v)})
    return out


def _float_tree(seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in (("x", (9, 7)), ("y", (13,)))}


def _edge_tree(seed):
    """Leaves the rank-ordered mean pads to 4 equal pieces: a ragged one (not
    a multiple of 4), one over a chunk at the default chunk size (its last
    chunk 3 elements), one of fewer elements than ranks, and a bf16 one."""
    rng = np.random.default_rng(seed)
    shapes = {"ragged": (17, 59), "multi": (coll.ORDERED_GATHER_CHUNK + 3,), "tiny": (3,),
              "bf16": (7, 9)}
    out = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for k, s in shapes.items()}
    out["bf16"] = out["bf16"].to(torch.bfloat16)
    return out


BUCKETS = (1, 64, 1000, 1 << 16)
WIRES = {"dense8": DenseInt(8), "packed8": PackedInt(8)}


def _collectives(group, rank, images, words, floats, edges):
    """Every collective on the group (or, with group None, the local
    backend over all n workers)."""
    mine = (lambda xs: [xs[rank]]) if group is not None else (lambda xs: xs)
    ctx = CommCtx(n_workers=N) if group is None else CommCtx.on_group(group)
    out = {"words_wrap": coll.psum_wire_words(mine(words), group)}
    for name, wf in WIRES.items():
        packed = [{k: wf.pack(v, n_workers=N) for k, v in img.items()} for img in images]
        out[f"{name}_words"] = coll.psum_wire_words(mine(packed), group)
        out[f"{name}_psum"] = ctx.psum_wire(mine(images), wf)
        for b in BUCKETS:
            ring = dataclasses.replace(ctx, overlap="ring", bucket_words=b)
            out[f"{name}_ring{b}"] = ring.psum_wire(mine(images), wf)
    try:
        coll.psum_wire_words(mine([{"f": t["x"]} for t in floats]), group)
        out["float_refused"] = False
    except TypeError as e:
        out["float_refused"] = "carries no floats" in str(e)
    out["pmax"] = ctx.pmax(mine(floats))
    out["pmax_global"] = ctx.pmax_global(mine(floats))
    out["pmean_ordered"] = ctx.pmean(mine(floats), ordered=True)
    chunk = coll.ORDERED_GATHER_CHUNK
    coll.ORDERED_GATHER_CHUNK = 5  # a leaf gathered in ragged chunks
    out["pmean_ordered_chunked"] = ctx.pmean(mine(floats), ordered=True)
    coll.ORDERED_GATHER_CHUNK = chunk
    out["pmean_ordered_edges"] = ctx.pmean(mine(edges), ordered=True)
    # the small leaves over several chunks of 64 ("multi" would take 2^18)
    coll.ORDERED_GATHER_CHUNK = 64
    small = [{k: v for k, v in e.items() if k != "multi"} for e in edges]
    out["pmean_ordered_edges_chunk64"] = ctx.pmean(mine(small), ordered=True)
    coll.ORDERED_GATHER_CHUNK = chunk
    out["pmean"] = ctx.pmean(mine(floats))
    out["gather"] = ctx.all_gather(mine(floats))
    out["loss"] = ctx.mean_scalars(t["y"][0] for t in mine(floats))
    rows = torch.stack([t["y"][:12] for t in floats])  # (n, per)
    out["rows"] = coll.all_gather_rows(rows if group is None else rows[rank:rank + 1], group)
    return out


@pytest.fixture(scope="module")
def collectives_run():
    images, words = _images(), _wrap_words()
    floats = [_float_tree(20 + w) for w in range(N)]
    edges = [_edge_tree(30 + w) for w in range(N)]
    ranks = run_ranks(_collectives, N, args=(images, words, floats, edges))
    return ranks, _collectives(None, 0, images, words, floats, edges), images


def test_packed8_saturated_fields_and_int32_words_wrap_across_ranks(collectives_run):
    ranks, local, images = collectives_run
    want_wrap = sum(w["w"].to(torch.int64) for w in _wrap_words())
    assert int(local["words_wrap"]["w"][0]) == 0  # 4 · 2^30 wraps to 0
    for r in ranks:
        assert _equal_trees(r["words_wrap"], local["words_wrap"])
        assert torch.equal(r["words_wrap"]["w"].to(torch.int64),
                           ((want_wrap + 2**31) % 2**32) - 2**31)
        assert _equal_trees(r["packed8_words"], local["packed8_words"])
        words_sum, int_sum = r["packed8_psum"]
        assert _equal_trees(words_sum, local["packed8_psum"][0])
        assert all(v.dtype == torch.int32 for v in words_sum.values())
        # the psum law: unpack(Σ words) == Σ images, saturated fields too
        assert _equal_trees(int_sum, {k: sum(i[k] for i in images).to(torch.int32)
                                      for k in images[0]})
        assert all(int(v.abs().max()) == 124 for v in int_sum.values())


def test_int8_dense_lanes_at_their_extremes_across_ranks(collectives_run):
    ranks, local, _ = collectives_run
    for r in ranks:
        words_sum, int_sum = r["dense8_psum"]
        assert all(v.dtype == torch.int8 for v in words_sum.values())
        assert _equal_trees(words_sum, local["dense8_psum"][0])
        assert _equal_trees(int_sum, local["dense8_psum"][1])
        assert all(int(v.max()) == 124 and int(v.min()) == -124 for v in words_sum.values())


def test_float_payload_on_the_wire_raises_on_the_group(collectives_run):
    ranks, local, _ = collectives_run
    assert local["float_refused"] and all(r["float_refused"] for r in ranks)


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("bucket_words", BUCKETS)
def test_bucketed_wire_equals_serial_across_ranks(collectives_run, wire, bucket_words):
    ranks, local, _ = collectives_run
    serial = local[f"{wire}_psum"]
    assert _equal_trees(local[f"{wire}_ring{bucket_words}"][0], serial[0])
    for r in ranks:
        words_sum, int_sum = r[f"{wire}_ring{bucket_words}"]
        assert _equal_trees(words_sum, serial[0]) and _equal_trees(int_sum, serial[1])


def test_pmax_gathers_and_means_in_rank_order(collectives_run):
    ranks, local, _ = collectives_run
    floats = [_float_tree(20 + w) for w in range(N)]
    assert _equal_trees(local["pmax"], {k: torch.stack([f[k] for f in floats]).amax(0)
                                        for k in floats[0]})
    for r in ranks:
        for key in ("pmax", "pmax_global", "pmean_ordered", "gather"):
            assert _equal_trees(r[key], local[key]), key
        assert _equal_trees(r["pmean_ordered_chunked"], local["pmean_ordered"])
        assert torch.equal(r["loss"], local["loss"]) and torch.equal(r["rows"], local["rows"])
        # the library's float order: equal up to reassociation
        for k, v in r["pmean"].items():
            torch.testing.assert_close(v, local["pmean"][k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("chunk", ["default", "chunk64"])
def test_ordered_mean_pads_ragged_multi_chunk_and_tiny_leaves(collectives_run, chunk):
    ranks, local, _ = collectives_run
    key = "pmean_ordered_edges" + ("" if chunk == "default" else "_chunk64")
    want = {k: v for k, v in local["pmean_ordered_edges"].items() if k in local[key]}
    assert _equal_trees(local[key], want)  # the local sum is not chunked
    assert want["bf16"].dtype == torch.float32 and want["ragged"].numel() > 64
    if chunk == "default":
        assert want["multi"].numel() > coll.ORDERED_GATHER_CHUNK
    for r in ranks:
        assert _equal_trees(r[key], want), key


# ---------------------------------------------------------------------------
# 2. the whole step, 4 ranks against the local backend at n = 4
# ---------------------------------------------------------------------------

CORNERS = {
    # name: (optimizer, compressor, wire, fused, microbatches, overlap)
    "zero1-sgd-intsgd-packed8": ("sgd", "intsgd8_packed", "packed8", False, 1, "off"),
    "zero1-adamw-intdiana-dense8-m2": ("adamw", "intdiana", "dense8", False, 2, "off"),
    "fused-sgd-intsgd-packed8-ring": ("sgd", "intsgd8_packed", "packed8", True, 1, "ring"),
    "fused-adamw-intsgd-dense8": ("adamw", "intsgd8", "dense8", True, 1, "off"),
}


def _drive(group, corner):
    """STEPS steps of ``corner`` with N workers: one per rank on ``group``,
    or all N in turn with ``group`` None. Per step: loss, max_int, α, the
    params; at the end the ZeRO-1 master rows and IntDIANA's shifts."""
    opt, comp_name, wire, fused, micro, overlap = CORNERS[corner]
    cfg = _cfg()
    shape = ShapeConfig("dist", SEQ, BATCH * micro, "train")
    comp = make_compressor(comp_name, **({"bits": 8, "wire": wire} if comp_name == "intdiana"
                                         else {}))
    base_opt = OPTIMIZERS[opt]()
    art = build_train_step(
        cfg, shape, n_workers=N, compressor=comp, base_opt=base_opt,
        lr_schedule=warmup_wrap(constant(0.3 if opt == "sgd" else 3e-4), 5), fused=fused,
        clip_norm=1.0, microbatches=micro, param_dtype=torch.float32, device="cpu",
        group=group, overlap=overlap, bucket_words=4096,
    )
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    opt_state, comp_state = build_init_state(params, n_workers=N, compressor=comp,
                                             base_opt=base_opt, fused=fused, group=group)
    seed_gen = torch.Generator().manual_seed(3)
    data = SyntheticLMData(cfg.vocab, SEQ, shape.global_batch, seed=3)
    records = []
    for i in range(STEPS):
        seeds = leaf_seeds(seed_gen, N, len(art.layout.names), "cpu", micro)
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        params, opt_state, comp_state, loss, (max_int, _, alphas, max_local) = fn(
            params, opt_state, comp_state, i, data.batch(i, 0, device="cpu"), seeds)
        records.append({"loss": loss, "max_int": max_int, "max_local_int": max_local,
                        "alpha": dict(alphas), "params": dict(params)})
    end = {}
    if not fused:
        end["master"] = opt_state["master"]
    if comp_name == "intdiana":
        end["h_local"], end["h_global"] = comp_state["h_local"], comp_state["h_global"]
    return records, end


def _drive_rank(group, rank, corner):
    return _drive(group, corner)


@pytest.mark.parametrize("corner", sorted(CORNERS))
def test_four_ranks_match_the_local_backend_bit_for_bit(corner):
    ranks = run_ranks(_drive_rank, N, args=(corner,))
    with _one_thread():
        local, local_end = _drive(None, corner)
    assert local[-1]["max_int"] > 0
    for rank, (recs, end) in enumerate(ranks):
        for step, (got, want) in enumerate(zip(recs, local)):
            where = f"rank {rank} step {step}"
            assert torch.equal(got["loss"], want["loss"]), where
            assert torch.equal(got["max_int"], want["max_int"]), where
            # each rank's own |image| max, pmax-ed over the ranks
            assert torch.equal(got["max_local_int"], want["max_local_int"]), where
            assert _equal_trees(got["alpha"], want["alpha"]), where
            assert _equal_trees(got["params"], want["params"]), where
        if "master" in local_end:  # the rank's own row, bit-equal to row w
            assert all(v.shape[0] == 1 for v in end["master"].values())
            assert _equal_trees(end["master"], {k: v[rank:rank + 1]
                                                for k, v in local_end["master"].items()})
        if "h_local" in local_end:
            assert _equal_trees(end["h_local"], {k: v[rank:rank + 1]
                                                 for k, v in local_end["h_local"].items()})
            assert _equal_trees(end["h_global"], local_end["h_global"])
            assert any(bool(v.any()) for v in end["h_global"].values())


# ---------------------------------------------------------------------------
# 3. against the JAX package on its real 4-device mesh
# ---------------------------------------------------------------------------

_JAX_MESH = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig, get_arch, smoke_config
from repro.core.compressor import IntSGD, _leaf_keys
from repro.kernels import ops
from repro.launch.step import build_init_state, build_train_step
from repro.models.transformer import init_lm_params
from repro.optim import sgd
from repro.optim.schedules import constant, warmup_wrap
from repro.wire import PackedInt
import dataclasses

N, SEQ, BATCH, STEPS = {N}, {SEQ}, {BATCH}, {STEPS}
mesh = jax.make_mesh((N, 1), ("data", "model"))
cfg = dataclasses.replace(smoke_config(get_arch("granite-8b")), n_layers=2)
comp = IntSGD(bits=8, wire=PackedInt(8, use_kernels=True), use_kernels=True)
opt = sgd(momentum=0.9, weight_decay=1e-4)
art = build_train_step(cfg, mesh, ShapeConfig("t", SEQ, BATCH, "train"), compressor=comp,
                       base_opt=opt, lr_schedule=warmup_wrap(constant(0.3), 5),
                       param_dtype=jnp.float32, fused=False, clip_norm=1.0, donate=False)
key = jax.random.PRNGKey(0)
params = init_lm_params(key, cfg, tp=1, n_shards=1, dtype=jnp.float32)
params0 = jax.tree.map(np.asarray, params)
params = jax.device_put(params, art.in_shardings[0])
opt_state, comp_state = build_init_state(cfg, mesh, compressor=comp, base_opt=opt,
                                         fused=False)(params)
opt0, comp0 = jax.tree.map(np.asarray, opt_state), jax.tree.map(np.asarray, comp_state)
rng = np.random.default_rng(5)
out = dict(params0=params0, opt0=opt0, comp0=comp0, batches=[], seeds=[], losses=[],
           max_ints=[])
for i in range(STEPS):
    toks = rng.integers(0, 256, (BATCH, SEQ))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    k = jax.random.fold_in(key, i)
    akey = jax.random.fold_in(k, 1)
    # worker w's encode keys: fold_worker_key(akey) = fold_in(akey, w), then
    # one split per leaf in tree order
    out["seeds"].append([[int(ops.seed_from_key(s)) for s in
                          jax.tree.leaves(_leaf_keys(jax.random.fold_in(akey, w), params0))]
                         for w in range(N)])
    fn = art.jitted["exact"] if i == 0 else art.jitted["compressed"]
    batch = {{"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}}
    params, opt_state, comp_state, loss, metrics = fn(
        params, opt_state, comp_state, jnp.int32(i), k, batch)
    out["batches"].append((toks, labels))
    out["losses"].append(float(loss))
    out["max_ints"].append(float(metrics[0]))
with open({path!r}, "wb") as fh:
    pickle.dump(out, fh)
print("JAX_MESH_OK")
"""


def _jax_weights_rank(group, rank, ref, wire):
    """The JAX run's weights, state, batches and seeds through the port's
    ZeRO-1 step on this rank (rank None: all N workers locally)."""
    cfg = _cfg()
    comp = make_compressor({"packed8": "intsgd8_packed", "dense8": "intsgd8"}[wire])
    base_opt = OPTIMIZERS["sgd"]()
    art = build_train_step(
        cfg, ShapeConfig("t", SEQ, BATCH, "train"), n_workers=N, compressor=comp,
        base_opt=base_opt, lr_schedule=warmup_wrap(constant(0.3), 5), clip_norm=1.0,
        param_dtype=torch.float32, device="cpu", group=group,
    )
    params = params_from_jax(ref["params0"], "cpu")
    opt_state, comp_state = zero1_state_from_jax(ref["opt0"], ref["comp0"], "cpu", rank=rank)
    losses, max_ints = [], []
    for i, (toks, labels) in enumerate(ref["batches"]):
        fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
        batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
        seeds = torch.tensor(ref["seeds"][i], dtype=torch.int32)  # (N, n_leaves)
        params, opt_state, comp_state, loss, metrics = fn(
            params, opt_state, comp_state, i, batch, seeds)
        losses.append(loss)
        max_ints.append(metrics[0])
    return {"losses": losses, "max_ints": max_ints, "params": params}


def _jax_wires_rank(group, rank, ref):
    return {w: _jax_weights_rank(group, rank, ref, w) for w in ("packed8", "dense8")}


def test_four_ranks_match_the_jax_four_device_mesh(tmp_path):
    from conftest import run_forced_mesh

    path = str(tmp_path / "jax_mesh.pkl")
    out = run_forced_mesh(_JAX_MESH.format(N=N, SEQ=SEQ, BATCH=BATCH, STEPS=STEPS, path=path))
    assert "JAX_MESH_OK" in out
    with open(path, "rb") as fh:
        ref = pickle.load(fh)
    ref["comp0"] = _alpha_state_to_dict(ref["comp0"])
    ranks = run_ranks(_jax_wires_rank, N, args=(ref,))
    for rank, r in enumerate(ranks):
        got = r["packed8"]
        losses = [float(v) for v in got["losses"]]
        max_ints = [float(v) for v in got["max_ints"]]
        np.testing.assert_allclose(losses, ref["losses"], rtol=2e-2)
        assert all(abs(a - b) <= 1 for a, b in zip(max_ints, ref["max_ints"])), (
            rank, max_ints, ref["max_ints"])
        assert max_ints[0] == 0 and all(0 < v <= 124 for v in max_ints[1:])
        # the same integer image on either wire: bit-identical runs
        dense = r["dense8"]
        assert all(torch.equal(a, b) for a, b in zip(dense["losses"], got["losses"]))
        assert _equal_trees(dense["params"], got["params"])
        assert _equal_trees(got["params"], ranks[0]["packed8"]["params"])


def _alpha_state_to_dict(state):
    """The JAX AlphaState as the port's converter reads it (attributes r and
    step), without unpickling the JAX package's class in the ranks."""
    return _Alpha(r=state.r, step=state.step)


@dataclasses.dataclass
class _Alpha:
    r: object
    step: object


# ---------------------------------------------------------------------------
# 4. the CLI under torch.distributed.run, and the refusals
# ---------------------------------------------------------------------------

def test_cli_under_torchrun_two_processes():
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--arch", "granite-8b", "--smoke",
           "--layers", "2", "--steps", "2", "--workers", "2", "--batch", "2", "--seq", "8",
           "--compressor", "intsgd8_packed", "--wire", "packed8", "--overlap", "ring",
           "--bucket-words", "1000", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    # rank 0 alone prints the step lines
    assert r.stdout.count("step     0") == 1 and r.stdout.count("step     1") == 1, r.stdout


def test_cli_refuses_workers_other_than_the_world_size(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one process per worker"):
        train.main(["--arch", "granite-8b", "--smoke", "--workers", "3", "--device", "cpu"])
    with pytest.raises(ValueError, match="one process per worker"):
        train.main(["--arch", "granite-8b", "--smoke", "--data", "4", "--device", "cpu"])


def _dense16_rank(group, rank):
    comp = make_compressor("intsgd", bits=16, wire="dense16")
    kw = dict(n_workers=2, compressor=comp, base_opt=OPTIMIZERS["sgd"](),
              lr_schedule=constant(0.1), device="cpu", group=group)
    try:
        build_train_step(_cfg(), ShapeConfig("t", SEQ, BATCH, "train"), **kw)
        refused = None
    except WireTransportError as e:
        refused = str(e)
    comp16 = make_compressor("intsgd", bits=16, wire="packed16")
    build_train_step(_cfg(), ShapeConfig("t", SEQ, BATCH, "train"), **dict(kw, compressor=comp16))
    return refused


def test_dense16_is_refused_on_a_process_group_naming_packed16():
    for msg in run_ranks(_dense16_rank, 2):
        assert msg is not None and "packed16" in msg and "int16" in msg
    # the local backend sums int16 lanes itself, so it keeps dense16
    build_train_step(_cfg(), ShapeConfig("t", SEQ, BATCH, "train"), n_workers=2,
                     compressor=make_compressor("intsgd", bits=16, wire="dense16"),
                     base_opt=OPTIMIZERS["sgd"](), lr_schedule=constant(0.1), device="cpu")
