"""Import hygiene of the port: ``repro_torch`` (and ``chip_smoke.py``) never
import ``jax`` or the JAX package ``repro``, and the entry points refuse to
run without a card unless the caller asks for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PKG = os.path.join(SRC, "repro_torch")

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)|from\s+(jax|jaxlib|repro)\b(?!_torch))",
    re.M,
)


def _port_modules():
    import repro_torch

    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.launch.train" in mods and "repro_torch.kernels.ops" in mods
    assert "repro_torch.optim.adamw" in mods and "repro_torch.wire.dense" in mods
    assert "repro_torch.parallel.spawn" in mods and "repro_torch.wire.bucketing" in mods
    assert "repro_torch.core.simulate" in mods and "repro_torch.core.rounding" in mods
    assert "repro_torch.data.logreg" in mods
    assert "repro_torch.checkpoint.store" in mods and "repro_torch.launch.inputs" in mods
    assert "repro_torch.configs.qwen2_5_32b" in mods
    assert "repro_torch.launch.mesh" in mods and "repro_torch.launch.specs" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_no_jax_or_repro_import_in_port_sources():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            hits = _FORBIDDEN.findall(fh.read())
        assert not hits, (path, hits)
    assert _FORBIDDEN.search("from repro.core import x") and _FORBIDDEN.search("import jax.numpy")
    assert not _FORBIDDEN.search("from repro_torch.core import x")


def test_entry_points_need_the_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.core.compressor import make_compressor
    from repro_torch.launch import train
    from repro_torch.launch.step import build_train_step
    from repro_torch.optim.schedules import constant
    from repro_torch.optim.sgd import sgd

    cfg = smoke_config(get_arch("granite-8b"))
    shape = ShapeConfig("t", 8, 2, "train")
    kw = dict(n_workers=2, compressor=make_compressor("intsgd8_packed"),
              base_opt=sgd(0.9), lr_schedule=constant(0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(cfg, shape, **kw)
    build_train_step(cfg, shape, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_loop(cfg, shape, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "granite-8b", "--smoke", "--steps", "1", "--fused"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "granite-8b", "--smoke", "--steps", "1", "--fused",
                    "--opt", "adamw", "--compressor", "intdiana", "--wire", "dense8"])


def test_cli_runs_on_the_cpu_and_refuses_what_is_not_ported(capsys, tmp_path):
    from repro_torch.launch import train

    train.main(["--arch", "granite-8b", "--smoke", "--steps", "2", "--workers", "2",
                "--batch", "2", "--seq", "8", "--compressor", "intsgd8_packed",
                "--wire", "packed8", "--fused", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0" in out and "step     1" in out
    base = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--fused",
            "--compressor", "intsgd8_packed"]
    # ported since: --model > 1 runs under torchrun on a data x model grid,
    # and refuses to run without one
    with pytest.raises(ValueError, match="torchrun.*data x model"):
        train.main(base + ["--model", "2"])
    # ported since: --ckpt-dir and --resume (a save every 20 steps, as JAX's)
    ckpt = ["--ckpt-dir", str(tmp_path), "--workers", "2", "--batch", "2", "--seq", "8"]
    train.main(base + ckpt + ["--steps", "20"])
    assert sorted(os.listdir(tmp_path)) == ["step_0000000020"]
    train.main(base + ckpt + ["--steps", "21", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 20" in out and "step    20" in out
    # ported since: the bucketed wire, and --data as the data-parallel degree
    train.main(base + ["--overlap", "ring", "--bucket-words", "1000", "--data", "2",
                       "--steps", "2", "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert "step     1" in out
    with pytest.raises(ValueError, match="disagree"):
        train.main(base + ["--workers", "2", "--data", "4"])
    # the JAX package's refusal: the fused route consumes one image per step
    with pytest.raises(ValueError, match="use the zero1 route"):
        train.main(base + ["--microbatches", "2"])
    # AdamW, IntDIANA and the dense wire run (ported); a width-free
    # compressor name takes the wire's width
    train.main(base[:-1] + ["intdiana", "--wire", "dense8", "--opt", "adamw", "--steps", "2",
                            "--workers", "2", "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert "step     1" in out and "max_int" in out
    # without --fused: the ZeRO-1 route, with pipelined microbatches and
    # the uncompressed baseline
    zero1 = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--steps", "2",
             "--workers", "2", "--batch", "4", "--seq", "8"]
    train.main(zero1 + ["--compressor", "intsgd8_packed", "--wire", "packed8",
                        "--microbatches", "2"])
    train.main(zero1 + ["--compressor", "none"])
    out = capsys.readouterr().out
    assert out.count("step     1") == 2 and "bits 32" in out
    with pytest.raises(ValueError, match="not divisible into 3 microbatches"):
        train.main(zero1 + ["--microbatches", "3"])
