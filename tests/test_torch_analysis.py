"""The port's static auditors (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

Four groups:

  * the pure functions bit for bit against JAX, in this process: the
    interval domain on derandomized hypothesis draws, the §5.1 chain proof
    field by field over the reference's chain grid and its degenerate
    points, the clip limits;
  * ``spec_for_step`` field by field against the JAX step's ``audit_spec``
    (one JAX subprocess on a forced 4-device mesh), the dp axes mapped:
    the JAX step's ("data", "model") with tp = 1 is the port's "data";
  * every W-rule case of ``tests/test_analysis.py`` on a recorded trace,
    by name, firing the same rule id or passing clean — the reference's red
    cases held to what they state (a clip is found, the psum scales
    exactly), and ``build_train_step(verify="static")`` on the meta device
    over a small grid of real steps;
  * the C-rule linter over the port, torch-free.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import REPO, run_forced_mesh

from repro.analysis import intervals as jiv
from repro.analysis import wire_audit as jwa
from repro_torch.analysis import intervals as iv
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis import trace as tr
from repro_torch.analysis import wire_audit as wa
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
from repro_torch.core.compressor import make_compressor
from repro_torch.kernels import ops
from repro_torch.launch.step import build_train_step
from repro_torch.launch.train import OPTIMIZERS
from repro_torch.optim.schedules import constant
from repro_torch.parallel import collectives as coll
from repro_torch.wire import make_wire_format

from hypothesis import given, settings, strategies as st

SRC = os.path.join(REPO, "src")
N = 4  # the specs' workers, and the local backend's


def _spec(**kw):
    base = dict(dp_axes=("data",), axis_sizes={"data": N}, n_workers=N,
                wire_kind="dense", bits=8)
    base.update(kw)
    return wa.WireSpec(**base)


def _psum(x):
    """The local backend's integer all-reduce of ``x`` over N workers."""
    return coll.psum_wire_words([{"w": x}] * N)["w"]


def _audit(fn, *args, spec=None, **kw):
    _, trace = tr.record(fn, *args)
    return wa.audit_trace(trace, spec or _spec(), **kw)


F32 = torch.linspace(-3, 3, 4 * 256).reshape(4, 256)


# ---------------------------------------------------------------------------
# the pure functions against JAX
# ---------------------------------------------------------------------------
def _ival(a, b):
    return (min(a, b), max(a, b))


_ENDS = st.integers(min_value=-10**6, max_value=10**6)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(a=st.tuples(_ENDS, _ENDS), b=st.tuples(_ENDS, _ENDS),
       s=st.integers(min_value=0, max_value=12), c=st.integers(min_value=-9, max_value=9))
def test_interval_arithmetic_equals_jax(a, b, s, c):
    def both(f):
        """f over the port's domain and JAX's: the same interval, or the
        same exception (a clamp whose bounds miss x is empty: both refuse)."""
        out = []
        for m in (iv, jiv):
            x, y = m.Interval(*_ival(*a)), m.Interval(*_ival(*b))
            try:
                r = f(m, x, y)
                out.append((r.lo, r.hi, r.bounded, r.mag))
            except AssertionError:
                out.append("empty")
        assert out[0] == out[1], out

    both(lambda m, x, y: x.add(y))
    both(lambda m, x, y: x.sub(y))
    both(lambda m, x, y: x.mul(y))
    both(lambda m, x, y: x.neg())
    both(lambda m, x, y: x.scale(c))
    both(lambda m, x, y: x.union(y))
    both(lambda m, x, y: x.shl(m.Interval(0, s)))
    both(lambda m, x, y: x.clamp(m.Interval.point(-s), m.Interval.point(s)))
    both(lambda m, x, y: m.TOP.clamp(y, y))
    x, jx = iv.Interval(*_ival(*a)), jiv.Interval(*_ival(*a))
    assert x.contains(b[0]) == jx.contains(b[0])
    arr = np.asarray([a[0], b[1], c])
    assert iv.Interval.from_value(arr) == iv.Interval(*dataclasses.astuple(
        jiv.Interval.from_value(arr)))


def test_clip_limits_equal_jax():
    for bits in (4, 8, 16, 32):
        assert iv.int_range_max(bits) == jiv.int_range_max(bits)
        for n in (1, 2, 3, 4, 8, 12, 64, 127, 128, 257, 4096):
            assert iv.safe_clip_limit(n, bits) == jiv.safe_clip_limit(n, bits)
            for kind in ("dense", "packed", "topk"):
                assert (iv.declared_clip_limit(kind, n, bits)
                        == jiv.declared_clip_limit(kind, n, bits))


_CHAIN_GRID = [
    (kind, bits, n, M)
    for kind, bits in (("dense", 4), ("dense", 8), ("dense", 16), ("dense", 32),
                       ("packed", 4), ("packed", 8), ("packed", 16))
    for n in (1, 2, 4)
    for M in (1, 3)
    if iv.safe_clip_limit(n * M, bits) > 0
]
_DEGENERATE = [("dense", 8, 257, 1), ("packed", 4, 4, 3), ("dense", 4, 8, 1),
               ("packed", 8, 128, 1), ("topk", 8, 4, 2)]


def _proof_fields(p):
    return (p.kind, p.bits, p.n_workers, p.n_accum, p.lim,
            {k: (s.lo, s.hi) for k, s in p.stages.items()}, p.violations)


@pytest.mark.parametrize("kind,bits,n,M", _CHAIN_GRID + _DEGENERATE)
def test_chain_proof_equals_jax(kind, bits, n, M):
    assert _proof_fields(iv.wire_chain_proof(kind, bits, n, M)) == _proof_fields(
        jiv.wire_chain_proof(kind, bits, n, M))
    loose = iv.safe_clip_limit(n, bits) or 1  # an observed clip that forgot M
    assert _proof_fields(iv.wire_chain_proof(kind, bits, n, M, lim=loose)) == _proof_fields(
        jiv.wire_chain_proof(kind, bits, n, M, lim=loose))


def _concrete_chain(kind, bits, n, M, seed, size=64):
    """encode-range images -> M-accumulate -> the port's pack -> the word
    sum in the payload's type -> the port's unpack."""
    wf = make_wire_format(f"{kind}{bits}")
    rng = np.random.default_rng(seed)
    lim = iv.safe_clip_limit(n * M, bits)
    imgs = rng.integers(-lim, lim + 1, size=(n, M, size))
    accum = imgs.sum(axis=1)
    words = [wf.pack(torch.as_tensor(a, dtype=torch.int32), n_workers=n) for a in accum]
    summed = coll.psum_wire_words([{"w": w} for w in words])["w"]
    image = wf.unpack(summed, (size,), n_summed=n).numpy()
    return int(np.abs(imgs).max()), int(np.abs(accum).max()), image, accum.sum(axis=0)


@pytest.mark.parametrize("kind,bits,n,M", _CHAIN_GRID)
def test_chain_proof_sound_vs_concrete(kind, bits, n, M):
    proof = iv.wire_chain_proof(kind, bits, n, M)
    assert proof.ok, proof.violations
    enc, acc, image, true = _concrete_chain(kind, bits, n, M, seed=bits * 100 + n * 10 + M)
    assert enc <= proof.stages["encode"].mag and acc <= proof.stages["accum"].mag
    np.testing.assert_array_equal(image, true)
    assert proof.stages["image_sum"].contains(int(image.min()))
    assert proof.stages["image_sum"].contains(int(image.max()))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(cfg=st.sampled_from(_CHAIN_GRID), seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_chain_proof_sound_property(cfg, seed):
    proof = iv.wire_chain_proof(*cfg)
    enc, acc, image, true = _concrete_chain(*cfg, seed)
    assert enc <= proof.stages["encode"].mag and acc <= proof.stages["accum"].mag
    np.testing.assert_array_equal(image, true)
    assert proof.stages["image_sum"].contains(int(image.min()))


# ---------------------------------------------------------------------------
# spec_for_step against the JAX step's audit_spec
# ---------------------------------------------------------------------------
# (codec, overlap, microbatches, fused): fused at M = 1 where the codec can,
# the ZeRO-1 route otherwise
_SPEC_POINTS = [
    (codec, ov, m, fused)
    for codec in ("packed8", "dense8", "topk8:64")
    for ov in ("off", "ring")
    for m in (1, 2)
    for fused in (False, True)
    if not (fused and (m > 1 or codec.startswith("topk")))
]


@pytest.fixture(scope="module")
def jax_specs():
    out = run_forced_mesh(textwrap.dedent(f"""
        import dataclasses, json
        import jax
        from repro.configs import ShapeConfig, get_arch, smoke_config
        from repro.core import make_compressor
        from repro.launch.step import build_train_step
        from repro.optim import sgd
        from repro.optim.schedules import constant
        from repro.wire import make_wire_format

        mesh = jax.make_mesh((4, 1), ("data", "model"))
        for codec, ov, m, fused in {_SPEC_POINTS!r}:
            # the port's encode always takes the kernel route
            wf = dataclasses.replace(make_wire_format(codec), use_kernels=True)
            art = build_train_step(
                smoke_config(get_arch("granite-8b")), mesh, ShapeConfig("t", 32, 4 * m, "train"),
                compressor=make_compressor("intsgd", bits=wf.bits, wire=wf),
                base_opt=sgd(momentum=0.9), lr_schedule=constant(0.1), tp_override=1,
                fused=fused, overlap=ov, microbatches=m)
            print("SPEC", json.dumps([codec, ov, m, fused, art.audit_spec.to_dict()]))
        """))
    specs = {}
    for line in out.splitlines():
        if line.startswith("SPEC "):
            codec, ov, m, fused, d = json.loads(line[5:])
            specs[(codec, ov, m, fused)] = d
    return specs


def _port_step(codec, *, overlap="off", m=1, fused=False, arch="granite-8b", device="cpu",
               verify="off", n=N):
    wf = make_wire_format(codec)
    return build_train_step(
        smoke_config(get_arch(arch)), ShapeConfig("t", 32, n * m, "train"), n_workers=n,
        compressor=make_compressor("intsgd", bits=wf.bits, wire=codec),
        base_opt=OPTIMIZERS["sgd"](), lr_schedule=constant(0.1), param_dtype=torch.float32,
        fused=fused, microbatches=m, device=device, overlap=overlap, verify=verify)


@pytest.mark.parametrize("codec,ov,m,fused", _SPEC_POINTS)
def test_spec_for_step_equals_jax(jax_specs, codec, ov, m, fused):
    want = dict(jax_specs[(codec, ov, m, fused)])
    got = _port_step(codec, overlap=ov, m=m, fused=fused).audit_spec.to_dict()
    # the JAX step's dp axes at tp = 1 are ("data", "model"), the port's
    # data axis their product; the axis sizes are the same grid's
    assert tuple(want.pop("dp_axes")) == ("data", "model")
    assert tuple(got.pop("dp_axes")) == ("data",)
    want["leaf_sizes"] = tuple(want["leaf_sizes"])
    assert got == want


# ---------------------------------------------------------------------------
# W001: a float tensor on a reducing data-axis collective
# ---------------------------------------------------------------------------
def test_w001_raw_float_psum_flagged():
    rep = _audit(lambda x: coll.pmean_tree([{"g": x * 2.0}] * N, N)["g"], F32)
    w = [v for v in rep.violations if v.rule == "W001"]
    assert w and not rep.ok, rep.violations
    assert "float32" in w[0].message and "pmean" in w[0].where


def test_w001_scalar_loss_reduction_allowed():
    rep = _audit(lambda x: coll.pmean_tree([{"loss": torch.mean(x)}] * N, N)["loss"], F32)
    assert rep.ok, rep.violations
    assert rep.stats["scalar_float_reduces"] >= 1


def test_w001_scalar_allowance_boundary():
    assert wa.SCALAR_REDUCE_ALLOWANCE == jwa.SCALAR_REDUCE_ALLOWANCE == 64

    def reduce_n(n):
        return _audit(lambda x: coll.pmax_tree([{"v": x}] * N)["v"], torch.ones(n))

    at_limit = reduce_n(wa.SCALAR_REDUCE_ALLOWANCE)
    assert at_limit.ok and at_limit.stats["scalar_float_reduces"] >= 1
    over = reduce_n(wa.SCALAR_REDUCE_ALLOWANCE + 1)
    assert [v.rule for v in over.violations] == ["W001"]
    assert "65 elements" in over.violations[0].message


def test_w001_bf16_param_all_gather_allowed():
    rep = _audit(lambda x: coll.all_gather_rows(x.to(torch.bfloat16)), F32)
    assert rep.ok, rep.violations  # gathers move data, they don't combine it
    assert rep.stats["dp_collectives"] == 1


def test_w001_undeclared_integer_gather_flagged():
    ints = torch.zeros(N, 256, dtype=torch.int32)
    rep = _audit(lambda x: coll.all_gather_rows(x), ints)
    assert [v.rule for v in rep.violations] == ["W001"]
    assert _audit(lambda x: coll.all_gather_rows(x), ints,
                  spec=_spec(wire_transport="gather")).ok


# ---------------------------------------------------------------------------
# W002: unbounded / overflowing integer wire
# ---------------------------------------------------------------------------
def test_w002_unclipped_int_wire_flagged():
    rep = _audit(lambda x: _psum(torch.round(x * 1000.0).to(torch.int32)), F32,
                 spec=_spec(bits=32))
    w = [v for v in rep.violations if v.rule == "W002"]
    assert w and "not provably bounded" in w[0].message


def test_w002_degenerate_clip_257_contributions_int8():
    proof = iv.wire_chain_proof("dense", 8, 257)
    assert [c for c, _ in proof.violations] == ["degenerate-clip"]
    rep = _audit(lambda x: coll.pmean_tree([{"l": torch.mean(x)}] * N, N)["l"], F32,
                 spec=_spec(n_workers=257, bits=8))
    assert any(v.rule == "W002" and v.where == "chain:degenerate-clip" for v in rep.violations)


def test_w002_forgot_naccum_fails_reproof():
    assert iv.wire_chain_proof("dense", 16, 64, 16).ok
    bad = iv.wire_chain_proof("dense", 16, 64, 16, lim=iv.safe_clip_limit(64, 16))
    assert "lane-overflow" in [c for c, _ in bad.violations]


def test_w002_lane_overflow_loose_clip_flagged():
    # ±127 per worker is fine for n = 1, the spec and the wire say 4
    rep = _audit(lambda x: _psum(torch.clamp(torch.round(x), -127, 127).to(torch.int8)), F32)
    assert any(v.rule == "W002" and "lane" in v.message for v in rep.violations)


def test_w002_observed_clip_looser_than_packed_spec():
    """int32 lanes cannot overflow a dtype check: only the observed-clip
    re-proof catches a clip looser than the packed guard-bit budget."""
    rep = _audit(lambda x: _psum(torch.clamp(torch.round(x), -127, 127).to(torch.int32)), F32,
                 spec=_spec(wire_kind="packed", bits=8))
    assert rep.stats["clips_checked"] >= 1
    assert any(v.rule == "W002" and "looser than the declared" in v.message
               for v in rep.violations)


def test_w002_data_path_clip_not_mistaken_for_wire_clip():
    """A token-id clip positioning a lookup is not the wire's clip: the walk
    follows a gather's source, never its index."""
    def step(x, tok):
        tok = torch.clamp(tok, 0, 255)  # data-path clip, far out of §5.1 range
        emb = torch.index_select(x, 0, tok.reshape(-1) % 4)
        ints = torch.clamp(torch.round(emb), -31, 31).to(torch.int8)  # the wire clip
        return _psum(ints)

    _, trace = tr.record(step, F32, torch.arange(64).reshape(4, 16))
    rep = wa.audit_trace(trace, _spec())
    assert rep.ok, rep.violations  # 31 == clip_limit(4)
    assert rep.stats["clips_checked"] == 1


def test_w002_encode_kernel_lim_is_the_observed_clip():
    wf = make_wire_format("packed8")

    def step(g, n_workers):
        ints = wf.encode(g, torch.tensor(50.0), torch.tensor(7, dtype=torch.int32),
                         n_workers=n_workers)
        return coll.psum_wire_words([{"w": wf.pack(ints, n_workers=N)}] * N)["w"]

    spec = _spec(wire_kind="packed", bits=8, use_kernels=True, n_accum=2)
    _, clean = tr.record(step, F32, N * 2)  # clipped for n·M
    rep = wa.audit_trace(clean, spec)
    assert rep.ok and rep.stats["clips_checked"] == 1, rep.violations
    _, loose = tr.record(step, F32, N)  # forgot M
    rep = wa.audit_trace(loose, spec)
    assert any(v.rule == "W002" and "looser than the declared" in v.message
               for v in rep.violations)


# ---------------------------------------------------------------------------
# W003: the fused route reads packed words, not an image-sized int32
# ---------------------------------------------------------------------------
def _fused_spec(**kw):
    return _spec(wire_kind="packed", bits=8, use_kernels=True, fused=True, **kw)


_P = torch.linspace(-1, 1, 1024)
_SCALARS = torch.tensor([0.01, 1.0, 0.1, 0.9, 0.0])


def test_w003_image_roundtrip_into_kernel_flagged():
    def step(image, param, mom):
        p, m = ops.fused_apply_sgd(image, param, mom, _SCALARS)
        return p + 0.0 * m

    _, trace = tr.record(step, torch.ones(1024, dtype=torch.int32), _P, torch.zeros(1024))
    rep = wa.audit_trace(trace, _fused_spec())
    assert rep.stats["kernel_calls"] >= 1
    assert any(v.rule == "W003" for v in rep.violations), rep.violations


def test_w003_packed_words_into_kernel_clean():
    def step(words, param, mom):
        p, m = ops.fused_unpack_sgd(words, param, mom, _SCALARS, bits=8, n_summed=N)
        return p + 0.0 * m

    _, trace = tr.record(step, torch.zeros(256, dtype=torch.int32), _P, torch.zeros(1024))
    rep = wa.audit_trace(trace, _fused_spec())
    assert not [v for v in rep.violations if v.rule == "W003"], rep.violations


# ---------------------------------------------------------------------------
# suppression, the interval pass, the recorder
# ---------------------------------------------------------------------------
def test_audit_suppress_requires_justification():
    _, trace = tr.record(lambda x: coll.pmean_tree([{"g": x}] * N, N)["g"], F32)
    with pytest.raises(ValueError, match="justification"):
        wa.audit_trace(trace, _spec(), suppress={"W001": "  "})
    with pytest.raises(ValueError, match="unknown rule"):
        wa.audit_trace(trace, _spec(), suppress={"W9": "x"})
    rep = wa.audit_trace(trace, _spec(), suppress={"W001": "toy float wire, measured only"})
    assert rep.ok and rep.suppressed and rep.suppressed[0][0].rule == "W001"


def test_interval_eval_scan_unrolled_exactly():
    # a recorded trace has no scan: the M-microbatch accumulation is M
    # recorded adds, each evaluated exactly
    def f(x):
        c, ys = torch.zeros_like(x), []
        for _ in range(5):
            ys.append(c)
            c = c + x
        return c, torch.stack(ys)

    _, trace = tr.record(f, torch.ones(3))
    out, ys = iv.eval_trace_intervals(trace, [iv.Interval(0.0, 1.0)])
    assert out.hi == 5.0 and ys.hi == 4.0 and out.lo == ys.lo == 0


def test_interval_eval_psum_scales_by_axis_product():
    _, trace = tr.record(_psum, torch.zeros(8, dtype=torch.int32))
    (out,) = iv.eval_trace_intervals(trace, [iv.Interval(-1, 1)])
    assert (out.lo, out.hi) == (-4, 4)


def test_iter_eqns_covers_cond_sibling_subjaxprs():
    # the recorded counterpart: a collective in whichever branch ran is
    # recorded, one node for an outermost shim call (the bucketed psum
    # calls the serial one)
    def f(x, flag):
        if flag:
            return coll.psum_wire_words_bucketed([[x, x]] * N)[0]
        return x

    _, trace = tr.record(f, torch.zeros(8, dtype=torch.int32), True)
    nodes = [n for n in trace.nodes if n.kind == "collective"]
    assert [(n.name, n.axis, n.n_contrib, len(n.leaves)) for n in nodes] == [
        ("psum", "data", N, 2)]


def test_collectives_table_has_pmean():
    assert "pmean" in tr.COLLECTIVES and "pmean" in tr.REDUCING_COLLECTIVES
    _, trace = tr.record(lambda x: coll.pmean_tree([{"g": x}] * N, N), F32)
    assert [n.name for n in trace.nodes if n.kind == "collective"] == ["pmean"]


def test_hooks_cost_one_check_and_keep_no_tensor():
    assert tr.ACTIVE is None
    x = torch.arange(8, dtype=torch.int32)
    _, trace = tr.record(lambda v: _psum(v) + 1, x)
    assert tr.ACTIVE is None
    # the trace holds shapes, dtypes and ids only
    assert not any(isinstance(v, torch.Tensor) for n in trace.nodes
                   for v in (*n.args, *n.kwargs.values()))


# ---------------------------------------------------------------------------
# real steps: the audit on the recorded step, verify="static" on meta
# ---------------------------------------------------------------------------
def test_clean_step_audit_passes():
    art = _port_step("packed8", m=2)
    assert art.audit_spec is not None
    assert art.audit_spec.wire_kind == "packed" and art.audit_spec.n_accum == 2
    rep = wa.audit_step(art)  # recorded on the meta device
    assert rep.ok, rep.violations
    assert rep.stats["int_wire_ops"] >= 1 and rep.stats["clips_checked"] >= 1


def test_build_train_step_verify_static():
    art = _port_step("dense32", verify="static")
    assert art.audit_spec.wire_kind == "dense"
    with pytest.raises(ValueError, match="verify"):
        _port_step("dense32", verify="dynamic")
    none = build_train_step(
        smoke_config(get_arch("granite-8b")), ShapeConfig("t", 32, N, "train"), n_workers=N,
        compressor=make_compressor("none"), base_opt=OPTIMIZERS["sgd"](),
        lr_schedule=constant(0.1), device="cpu")
    assert none.audit_spec is None  # the float-wire baseline declares no wire
    with pytest.raises(ValueError, match="integer wire"):
        build_train_step(
            smoke_config(get_arch("granite-8b")), ShapeConfig("t", 32, N, "train"),
            n_workers=N, compressor=make_compressor("none"), base_opt=OPTIMIZERS["sgd"](),
            lr_schedule=constant(0.1), device="cpu", verify="static")


def test_verify_static_raises_on_a_seeded_violation(monkeypatch):
    # a wire whose encode forgot the microbatches: the observed clip is
    # looser than the declared one, and verify="static" refuses the build
    from repro_torch.core import compressor as comp_mod

    real = comp_mod.IntSGD._encode

    def forgot_m(self, *a, **kw):
        return real(self, *a, **{**kw, "n_accum": 1})

    monkeypatch.setattr(comp_mod.IntSGD, "_encode", forgot_m)
    with pytest.raises(wa.WireAuditError, match="looser than the declared"):
        _port_step("packed8", m=2, device="meta", verify="static")


# the small grid: granite smoke; packed8, dense8 and topk8:64; off and ring;
# M in {1, 2}; fused where the codec can at M = 1
_GRID = [(codec, ov, m, m == 1 and not codec.startswith("topk"))
         for codec in ("packed8", "dense8", "topk8:64") for ov in ("off", "ring")
         for m in (1, 2)]


@pytest.mark.parametrize("codec,ov,m,fused", _GRID)
def test_verify_static_on_meta(codec, ov, m, fused):
    art = _port_step(codec, overlap=ov, m=m, fused=fused, verify="static")
    assert art.audit_spec.n_accum == (1 if codec.startswith("topk") else m)


# ---------------------------------------------------------------------------
# the linter (C-rules)
# ---------------------------------------------------------------------------
def _lint(src, path="src/repro_torch/models/toy.py"):
    return lint_mod.lint_source(textwrap.dedent(src), path)


def test_c001_raw_collective_outside_shim():
    vs = _lint("""
        import torch.distributed as dist

        def f(x):
            dist.all_reduce(x)
        """)
    assert [v.rule for v in vs] == ["C001"]
    assert "parallel.collectives" in vs[0].message
    assert [v.rule for v in _lint("""
        from torch.distributed import reduce_scatter_tensor
        import torch

        def f(o, x):
            torch.distributed.new_group([0, 1])
        """)] == ["C001", "C001"]


def test_c001_shim_module_itself_allowed():
    assert _lint("""
        import torch.distributed as dist

        def psum(x, group):
            dist.all_reduce(x, group=group)
        """, path="src/repro_torch/parallel/collectives.py") == []


def test_c001_suppression_needs_justification():
    assert _lint("""
        import torch.distributed as dist

        def f(x):
            # lint: allow(C001) -- profiling probe, not a wire path
            dist.all_reduce(x)
        """) == []
    bare = _lint("""
        import torch.distributed as dist

        def f(x):
            # lint: allow(C001)
            dist.all_reduce(x)
        """)
    assert any("justification" in v.message for v in bare)


def test_c002_optimizer_must_declare_wire_contract():
    vs = _lint("""
        from repro_torch.optim.base import Optimizer

        opt = Optimizer(init=None, update=None)
        """)
    assert [v.rule for v in vs] == ["C002"]
    assert _lint("""
        from repro_torch.optim.base import Optimizer

        opt = Optimizer(init=None, update=None, dx_scale=1.0, fused_kernel="sgd")
        """) == []


def test_c003_wireformat_subclass_must_live_under_wire():
    src = """
        from repro_torch.wire.base import WireFormat

        class Rogue(WireFormat):
            pass
        """
    assert [v.rule for v in _lint(src)] == ["C003"]
    assert _lint(src, path="src/repro_torch/wire/newcodec.py") == []


def test_repo_is_lint_clean():
    # the port's tree and its tests under the port's rules (the reference's
    # test of the same name lints all of src/ under the JAX rules)
    tests = [os.path.join(REPO, "tests", f) for f in sorted(os.listdir(os.path.join(REPO, "tests")))
             if f.startswith("test_torch_") and f.endswith(".py")]
    assert lint_mod.lint_paths([os.path.join(SRC, "repro_torch")] + tests) == []


def test_lint_cli_is_torch_free():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; import repro_torch.analysis.lint as l; "
         "assert 'torch' not in sys.modules, 'lint imported torch'; "
         "assert l.main([sys.argv[1]]) == 0", os.path.join(SRC, "repro_torch", "analysis")],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stdout + r.stderr


def test_lazy_package_is_torch_free():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; import repro_torch.analysis as a; a.LINT_RULES; "
         "assert 'torch' not in sys.modules"],
        capture_output=True, text=True, env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stderr
