"""Port vs JAX: the dry run as a per-rank shape check
(``repro_torch.launch.dryrun``) against the JAX package's
``build_train_step`` and ``build_serve_step`` on the production meshes of
512 forced CPU devices (data 16 × model 16, and pod 2 × data 16 × model
16), built but not lowered, in one subprocess (the JAX dry run sets its
device count when imported).

For every runnable cell on both layouts, with IntSGD and SGD(0.9, wd 1e-4)
on the ZeRO-1 route as the JAX dry run builds them:

- each argument group's bytes on one rank against the sum over its leaves
  of ``in_shardings[i].shard_shape(arg_structs[i].shape)`` in JAX: the
  params, the ZeRO-1 state, the compressor state and the cache equal. The
  port lays some state out otherwise (ZeRO-1's rows, the compressor's α
  state), so these groups are held by bytes only;
- the params' local shape and dtype, leaf by leaf by name;
- the batch, tokens and positions leaf by leaf: the same shapes, the token
  ids and positions int64 in the port where JAX's are int32 (what the
  port's embedding and decode take), so those leaves hold twice JAX's
  bytes and the others equal them;
- the step and the key are not compared: the port's step index is a host
  int, and in place of JAX's PRNG key the port's step takes the (n_dp,
  n_leaves) int32 encode seeds drawn from it on the host;
- ``model_flops_per_chip`` equal.

And ``get_shape`` and ``runnable_cells`` against JAX's, and the CLI's
``--all`` and a single cell's line.
"""
import json
import math
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import SHAPES, get_arch, get_shape, runnable_cells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = (False, True)  # multi_pod
TOKEN_LEAVES = ("tokens", "labels", "pos")

_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import math, pickle
import jax, numpy as np
from repro.configs import SHAPES, get_arch, get_shape, runnable_cells
from repro.core import make_compressor
from repro.launch.dryrun import model_flops_per_chip
from repro.launch.mesh import make_production_mesh
from repro.launch.step import build_serve_step, build_train_step
from repro.optim import sgd
from repro.optim.schedules import constant

def name(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

def local(structs, shardings):
    leaves = jax.tree_util.tree_flatten_with_path(structs)[0]
    shards = jax.tree.leaves(shardings)
    assert len(leaves) == len(shards)
    return {{name(p): (tuple(sh.shard_shape(st.shape)), str(st.dtype))
            for (p, st), sh in zip(leaves, shards)}}

out = dict(cells=runnable_cells(),
           shapes={{k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()}},
           layouts={{}})
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    rec = {{}}
    for a, s, runnable in runnable_cells():
        if not runnable:
            continue
        cfg, shape = get_arch(a), get_shape(s)
        if shape.kind == "train":
            art = build_train_step(cfg, mesh, shape, compressor=make_compressor("intsgd"),
                                   base_opt=sgd(momentum=0.9, weight_decay=1e-4),
                                   lr_schedule=constant(0.1))
            groups = ("params", "opt", "comp", "step", "key", "batch")
        else:
            art = build_serve_step(cfg, mesh, shape)
            groups = (("params", "batch") if shape.kind == "prefill"
                      else ("params", "cache", "tokens", "pos"))
        rec[a, s] = dict(groups={{g: local(st, sh) for g, st, sh in
                                 zip(groups, art.arg_structs, art.in_shardings)}},
                         flops=model_flops_per_chip(cfg, shape, mesh.size),
                         n_chips=mesh.size)
    out["layouts"][multi] = rec
pickle.dump(out, open({out!r}, "wb"))
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "jax.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _JAX.format(out=out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "JAX_OK" in r.stdout, r.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _jax_bytes(leaves):
    return sum(math.prod(s) * _itemsize(d) for s, d in leaves.values())


def _itemsize(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4, "int32": 4, "uint32": 4, "int64": 8, "int8": 1}[dtype]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _ports(jax_cells):
    """Every runnable cell on both layouts: (multi_pod, arch, shape, the
    port's groups, JAX's record)."""
    for multi in LAYOUTS:
        for (a, s), rec in jax_cells["layouts"][multi].items():
            port = dryrun.arg_shapes(get_arch(a), get_shape(s), pods=2 if multi else 1)
            yield multi, a, s, port, rec


def test_shapes_and_runnable_cells_match_jax(jax_cells):
    assert runnable_cells() == jax_cells["cells"]
    assert sum(r for *_, r in runnable_cells()) == 34
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} \
        == jax_cells["shapes"]
    for k in SHAPES:
        assert get_shape(k) == SHAPES[k]
    with pytest.raises(ValueError, match="unknown shape"):
        get_shape("train_1m")


@pytest.mark.parametrize("group", ["params", "opt", "comp", "cache"])
def test_state_bytes_per_rank_equal_jax_shard_shapes(jax_cells, group):
    seen = 0
    for multi, a, s, port, rec in _ports(jax_cells):
        if group not in rec["groups"]:
            assert group not in port, (a, s)
            continue
        seen += 1
        assert port[group]["bytes"] == _jax_bytes(rec["groups"][group]), (multi, a, s, group)
    assert seen >= 20


def test_params_local_shapes_and_dtypes_equal_jax_by_name(jax_cells):
    for multi, a, s, port, rec in _ports(jax_cells):
        want = rec["groups"]["params"]
        got = {k: (s_, _dtype_name(d)) for k, (s_, d) in port["params"]["leaves"].items()}
        assert got == want, (multi, a, s)


def test_inputs_per_rank_match_jax_leaf_by_leaf(jax_cells):
    for multi, a, s, port, rec in _ports(jax_cells):
        for group in ("batch", "tokens", "pos"):
            if group not in rec["groups"]:
                continue
            # a group that is one array has the one leaf of its own name
            want = {k or group: v for k, v in rec["groups"][group].items()}
            got = port[group]["leaves"]
            assert got.keys() == want.keys(), (a, s, group)
            for k, (shape, dtype) in got.items():
                assert shape == want[k][0], (multi, a, s, k)
                if k in TOKEN_LEAVES:  # int64 ids and positions, JAX's int32
                    assert (dtype, want[k][1]) == (torch.int64, "int32")
                else:
                    assert _dtype_name(dtype) == want[k][1]
            doubled = sum(math.prod(v[0]) * _itemsize(v[1]) for k, v in want.items()
                          if k in TOKEN_LEAVES)
            assert port[group]["bytes"] == _jax_bytes(want) + doubled


def test_model_flops_per_chip_equal_jax(jax_cells):
    for multi in LAYOUTS:
        for (a, s), rec in jax_cells["layouts"][multi].items():
            assert dryrun.model_flops_per_chip(get_arch(a), get_shape(s), rec["n_chips"]) \
                == rec["flops"], (multi, a, s)


def test_cli_all_gives_a_line_a_cell_and_records_errors(tmp_path, monkeypatch, capsys):
    out = tmp_path / "cells.jsonl"
    dryrun.main(["--all", "--multi-pod", "--out", str(out)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [json.loads(x) for x in out.read_text().splitlines()] == lines
    assert [(r["arch"], r["shape"]) for r in lines] == [
        (a, s) for a, s, runnable in runnable_cells() if runnable]
    for r in lines:
        assert "error" not in r and r["multi_pod"] and r["grid"]["ranks"] == 512
        assert r["activations"] == "not counted" and r["card"]
        assert r["args_gib_per_rank"] == pytest.approx(sum(r["gib_per_rank"].values()))
    granite = next(r for r in lines if (r["arch"], r["shape"]) == ("granite-8b", "train_4k"))
    assert granite["args_fit_card"] and set(granite["gib_per_rank"]) == {
        "params", "opt", "comp", "step", "seeds", "batch"}
    # one cell; a failing cell records its error and the sweep goes on
    monkeypatch.setattr(dryrun, "arg_shapes", lambda *a, **k: 1 / 0)
    dryrun.main(["--arch", "xlstm-125m", "--shape", "train_4k"])
    (rec,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rec["error"].startswith("ZeroDivisionError")
    dryrun.main(["--arch", "granite-8b", "--shape", "long_500k"])
    assert "skipped" in json.loads(capsys.readouterr().out)
