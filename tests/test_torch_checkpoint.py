"""The port's checkpoint store and the train loop's resume.

1. The JAX package's store cases (``tests/test_checkpoint.py``) on
   ``repro_torch.checkpoint.CheckpointStore``: round trip, keep-last-k GC,
   the async writer, no ``.tmp`` directory after publish, a structure or
   shape mismatch rejected, a given step restored; and a write's error
   raised by ``wait()``.
2. Across the packages: a float32 params tree written by the JAX store is
   read by the port's, and the other way round (the same "/"-joined keys,
   manifest and files); a bf16 tree round-trips through the port's store
   (its bit pattern).
3. Resume on the CPU is bit-identical to an uninterrupted run: 4 straight
   steps against 2, a save, a resume and 2 more, the step-4 checkpoints
   (params, optimizer and compressor state) equal array for array, for
   fused SGD/IntSGD/packed8 and ZeRO-1 AdamW/IntDIANA/dense8 (α state,
   h_local, h_global, AdamW's rows and count).
4. The global layout: 4 gloo ranks save step 2 and the local backend
   resumes it, and 4 ranks resume the local backend's step 2; each run's
   step-4 checkpoint equals the uninterrupted local run's.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.configs import get_arch as jget_arch, smoke_config as jsmoke  # noqa: E402
from repro.models.transformer import init_lm_params as jinit  # noqa: E402
from repro_torch.checkpoint import CheckpointStore, flatten_state  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.core.scaling import AlphaState  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models.transformer import init_lm_params, params_from_jax  # noqa: E402
from repro_torch.parallel.spawn import run_ranks  # noqa: E402

N = 4


def _tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g) * scale, "b": torch.ones(4)},
        "step_scalar": torch.tensor(scale, dtype=torch.float32),
        "alpha": AlphaState(r=torch.tensor(0.5), step=torch.tensor(3, dtype=torch.int32)),
        "t": (torch.arange(3, dtype=torch.int32),),
    }


def _equal(a, b):
    fa, fb = flatten_state(a), flatten_state(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


def test_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), async_writes=False)
    tree = _tree(0)
    store.save(5, tree, extra={"loss": 1.25})
    got, extra, step = store.restore(_tree(9, scale=2.0))
    assert step == 5 and extra["loss"] == 1.25
    assert _equal(got, tree) and isinstance(got["alpha"], AlphaState)
    assert isinstance(got["t"], tuple)
    keys = json.load(open(tmp_path / "step_0000000005" / "manifest.json"))["arrays"]
    assert sorted(keys) == ["alpha/.r", "alpha/.step", "params/b", "params/w",
                            "step_scalar", "t/0"]


def test_keep_last_k_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), keep_last=2, async_writes=False)
    for s in [1, 2, 3, 4]:
        store.save(s, _tree(s, scale=s))
    assert store.all_steps() == [3, 4]
    got, _, step = store.restore(_tree(0))
    assert step == 4
    assert float(got["step_scalar"]) == 4.0


def test_async_writer(tmp_path):
    store = CheckpointStore(str(tmp_path), async_writes=True)
    tree = _tree(7)
    store.save(0, tree)
    tree["params"]["w"].add_(1.0)  # the snapshot was taken when save returned
    for s in (1, 2):
        store.save(s, _tree(s, scale=s))
    store.wait()
    assert store.latest_step() == 2
    got, _, _ = store.restore(_tree(0), step=0)
    assert _equal(got, _tree(7))
    store.close()


def test_async_write_error_raised_on_wait(tmp_path):
    store = CheckpointStore(str(tmp_path), async_writes=True)
    os.makedirs(tmp_path / "step_0000000003.tmp" / "manifest.json")  # cannot be written
    store.save(3, _tree(0))
    with pytest.raises(IsADirectoryError):
        store.wait()
    store.close()


def test_no_tmp_dirs_visible_after_publish(tmp_path):
    store = CheckpointStore(str(tmp_path), async_writes=False)
    store.save(1, _tree(0))
    names = os.listdir(tmp_path)
    assert not any(n.endswith(".tmp") for n in names)


@pytest.mark.parametrize("bad", ["structure", "shape"])
def test_mismatch_rejected(tmp_path, bad):
    store = CheckpointStore(str(tmp_path), async_writes=False)
    tree = _tree(0)
    store.save(1, tree)
    if bad == "structure":
        like = {"different": torch.zeros(3)}
    else:
        like = {k: v for k, v in tree.items()}
        like["params"] = {k: torch.zeros((7, *v.shape)) for k, v in tree["params"].items()}
    with pytest.raises(ValueError):
        store.restore(like)


def test_restore_latest_of_many(tmp_path):
    store = CheckpointStore(str(tmp_path), keep_last=10, async_writes=False)
    for s in [10, 20, 30]:
        store.save(s, _tree(s, scale=float(s)))
    got, _, step = store.restore(_tree(0), step=20)
    assert step == 20 and float(got["step_scalar"]) == 20.0
    assert store.restore(_tree(0))[2] == 30


def _jax_params():
    return jinit(jax.random.PRNGKey(3), jsmoke(jget_arch("qwen2.5-32b")))


def test_jax_checkpoint_read_by_the_port(tmp_path):
    jparams = _jax_params()
    JStore(str(tmp_path), async_writes=False).save(6, {"params": jparams}, extra={"a": 1})
    cfg = smoke_config(get_arch("qwen2.5-32b"))
    like = {"params": init_lm_params(cfg, generator=torch.Generator().manual_seed(0),
                                     device="cpu")}
    got, extra, step = CheckpointStore(str(tmp_path), async_writes=False).restore(like)
    want = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert step == 6 and extra == {"a": 1}
    assert _equal(got["params"], want) and "layers/attn/bq" in want


def test_port_checkpoint_read_by_jax(tmp_path):
    jparams = _jax_params()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    CheckpointStore(str(tmp_path), async_writes=False).save(2, {"params": params})
    like = {"params": jax.tree.map(jnp.zeros_like, jparams)}
    got, _, step = JStore(str(tmp_path), async_writes=False).restore(like)
    assert step == 2
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves({"params": jparams})):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(33, 7, generator=g).to(torch.bfloat16)
    x[0, :3] = torch.tensor([float("inf"), -0.0, float("nan")])
    tree = {"p": x, "m": torch.randn(5, generator=g)}
    store = CheckpointStore(str(tmp_path), async_writes=False)
    store.save(1, tree)
    meta = json.load(open(tmp_path / "step_0000000001" / "manifest.json"))["arrays"]["p"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [33, 7]
    got, _, _ = store.restore({"p": torch.zeros(33, 7, dtype=torch.bfloat16),
                               "m": torch.zeros(5)})
    assert got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(got["m"], tree["m"])


# (fused, optimizer, compressor, wire)
CORNERS = {
    "fused-sgd-intsgd-packed8": (True, "sgd", "intsgd8_packed", "packed8"),
    "zero1-adamw-intdiana-dense8": (False, "adamw", "intdiana", "dense8"),
}


def _cfg():
    return dataclasses.replace(smoke_config(get_arch("qwen2.5-32b")), n_layers=2)


def _run(corner, directory, steps, *, resume=False, group=None):
    fused, opt, comp, wire = CORNERS[corner]
    store = CheckpointStore(directory, group=group)
    _, hist = train_loop(
        _cfg(), ShapeConfig("ckpt", 16, 2 * N, "train"), n_workers=N, compressor=comp,
        wire=wire, steps=steps, lr=0.3 if opt == "sgd" else 3e-4, log_every=100, seed=2,
        fused=fused, opt=opt, device="cpu", group=group, ckpt=store, ckpt_every=2,
        resume=resume,
    )
    store.close()
    return [r["loss"] for r in hist]


def _arrays(directory, step):
    d = os.path.join(directory, f"step_{step:010d}")
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    return {k: (m["dtype"], np.load(os.path.join(d, m["file"])))
            for k, m in manifest["arrays"].items()}


def _same_checkpoint(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k][0] == b[k][0], k
        np.testing.assert_array_equal(a[k][1], b[k][1], err_msg=k)


class _one_thread:
    """The local runs at the spawned ranks' intra-op thread count."""

    def __enter__(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.threads)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Each corner's uninterrupted 4-step local run: its losses and its
    checkpoint directory (steps 2 and 4)."""
    out = {}
    with _one_thread():
        for corner in CORNERS:
            d = str(tmp_path_factory.mktemp(corner))
            out[corner] = (_run(corner, d, 4), d)
    return out


@pytest.mark.parametrize("corner", list(CORNERS))
def test_resume_is_bit_identical_on_the_cpu(straight, tmp_path, corner):
    losses, ref = straight[corner]
    d = str(tmp_path)
    with _one_thread():
        first = _run(corner, d, 2)
        assert CheckpointStore(d, async_writes=False).all_steps() == [2]
        second = _run(corner, d, 4, resume=True)
    assert first + second == losses
    _same_checkpoint(_arrays(d, 2), _arrays(ref, 2))
    _same_checkpoint(_arrays(d, 4), _arrays(ref, 4))
    keys = set(_arrays(d, 4))
    if corner.startswith("zero1"):
        assert {"opt/base/count", "comp/alpha/.r", "comp/alpha/.step"} <= keys
        assert any(k.startswith("comp/h_local/") for k in keys)
        assert any(k.startswith("comp/h_global/") for k in keys)
        assert any(k.startswith("opt/master/") for k in keys)
    else:
        assert {"comp/.r", "comp/.step"} <= keys and any(k.startswith("opt/mom/") for k in keys)


def _rank_checkpoints(group, rank, corner, save_dir, resume_dir):
    """Ranks: steps 0-1 saved at 2 into ``save_dir``; then steps 2-3
    resumed from ``resume_dir``'s step 2 and saved at 4 there."""
    _run(corner, save_dir, 2, group=group)
    _run(corner, resume_dir, 4, resume=True, group=group)
    return rank


def test_ranks_checkpoint_resumes_on_the_local_backend_and_back(straight, tmp_path):
    corner = "zero1-adamw-intdiana-dense8"
    losses, ref = straight[corner]
    by_ranks, for_ranks = str(tmp_path / "by_ranks"), str(tmp_path / "for_ranks")
    with _one_thread():
        _run(corner, for_ranks, 2)  # the local backend's step 2, for the ranks
    assert run_ranks(_rank_checkpoints, N, args=(corner, by_ranks, for_ranks)) == [0, 1, 2, 3]
    # the ranks' step 2 is the local backend's, gathered: every row
    _same_checkpoint(_arrays(by_ranks, 2), _arrays(ref, 2))
    _same_checkpoint(_arrays(for_ranks, 4), _arrays(ref, 4))
    with _one_thread():
        assert _run(corner, by_ranks, 4, resume=True) == losses[2:]
    _same_checkpoint(_arrays(by_ranks, 4), _arrays(ref, 4))
    master = _arrays(by_ranks, 2)["opt/master/embed"][1]
    assert master.shape[0] == N
