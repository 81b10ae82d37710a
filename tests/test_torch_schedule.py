"""The port's performance auditor — schedule (P) and traffic (T) layers —
against the JAX package's (``tests/test_schedule.py``).

Four groups:

  * PLANTED REGRESSIONS on recorded traces, one per P-rule, each flagged BY
    RULE ID beside its clean twin;
  * the BYTE ACCOUNTANT: the static transport model equals what the port's
    ``Logged`` codec meters and what its ``BucketManifest`` records, and
    JAX's own arithmetic, across every codec × worker count × microbatch
    count where the codec's clip limit is at least 1 (the reference's
    property draws ``packed4`` at n = 8, where the clip limit is 0 and the
    codec refuses: that point is held to the refusal here);
  * T-rule drift on recorded traces (T001 bytes, T002 node and leaf
    counts), and the composed ``full_audit``;
  * the real thing: the port's compressed step recorded on the CPU over a
    small grid (the local backend's 4 workers), W/P/T clean with the
    roofline the overlap design promises, bit-equal to the same step
    unrecorded; and one step on four gloo ranks, recorded on every rank.
"""
import copy
import os

import pytest
import torch

from hypothesis import assume, given, settings, strategies as st

from repro.analysis import traffic as jtr
from repro_torch.analysis import schedule as sched
from repro_torch.analysis import trace as tr
from repro_torch.analysis import traffic as tf
from repro_torch.analysis import wire_audit as wa
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
from repro_torch.core.compressor import leaf_seeds, make_compressor
from repro_torch.kernels import ops
from repro_torch.launch.inputs import materialize_batch
from repro_torch.launch.step import build_init_state, build_train_step
from repro_torch.launch.train import OPTIMIZERS
from repro_torch.models.transformer import init_lm_params
from repro_torch.optim.schedules import constant
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.spawn import run_ranks
from repro_torch.wire import (
    PARAMETRIC_WIRE_FORMATS, WIRE_FORMATS, Logged, WireRangeError, bucketing, make_wire_format,
)

N = 4


def _spec(**kw):
    base = dict(dp_axes=("data",), axis_sizes={"data": N}, n_workers=N,
                wire_kind="dense", bits=8)
    base.update(kw)
    return wa.WireSpec(**base)


def _psum(x):
    return coll.psum_wire_words([{"w": x}] * N)["w"]


def _ints(x):
    return torch.clamp(torch.round(x), -3, 3).to(torch.int32)


def _rules(report):
    return sorted({v.rule for v in report.violations})


def _trace(fn, *args):
    return tr.record(fn, *args)[1]


F32 = torch.linspace(-4, 4, 256)
M16 = torch.linspace(-1, 1, 256).reshape(16, 16)


# ---------------------------------------------------------------------------
# P001: a reduce's result feeding compute a later reduce depends on
# ---------------------------------------------------------------------------
def test_p001_decoded_sum_feeds_next_images_backward():
    def step(x, w):
        s0 = _psum(_ints(x))
        y = s0.to(torch.float32).reshape(16, 16) @ w  # DECODED into image 1's matmul
        s1 = _psum(_ints(y.reshape(-1)))
        return s0.sum() + s1.sum()

    rep = sched.analyze_schedule(_trace(step, F32, M16), _spec())
    p1 = [v for v in rep.violations if v.rule == "P001"]
    assert p1, _rules(rep)
    assert "pipelining is" in p1[0].message


def test_p001_independent_images_clean():
    def step(x, y):
        return _psum(_ints(x)).sum() + _psum(_ints(y)).sum()

    rep = sched.analyze_schedule(_trace(step, F32, F32 * 2), _spec())
    assert "P001" not in _rules(rep)
    assert rep.n_wire_collectives == 2 and rep.n_serialized == 0
    assert rep.interleavable_fraction == 1.0


# ---------------------------------------------------------------------------
# P002: dead / duplicate collectives, cast round-trips
# ---------------------------------------------------------------------------
def test_p002_duplicate_psum_flagged():
    def step(x):
        ints = _ints(x)
        return _psum(ints) + _psum(ints)  # the same sum, twice on the wire

    rep = sched.analyze_schedule(_trace(step, F32), _spec())
    dups = [v for v in rep.violations if v.rule == "P002" and "duplicate" in v.message]
    assert len(dups) == 1, _rules(rep)


def test_p002_dead_collective_flagged():
    def step(x):
        ints = _ints(x)
        _psum(ints)  # never reaches the outputs
        return ints.sum()

    rep = sched.analyze_schedule(_trace(step, F32), _spec())
    assert any(v.rule == "P002" and "dead" in v.message for v in rep.violations), _rules(rep)


def test_p002_in_place_output_is_live():
    # a result written into a step input in place is an output of the step
    def step(x, acc):
        acc.add_(_psum(_ints(x)))

    rep = sched.analyze_schedule(_trace(step, F32, torch.zeros(256, dtype=torch.int32)),
                                 _spec())
    assert not rep.violations, rep.violations


def test_p002_int_cast_roundtrip_flagged():
    def step(x):
        return _psum(_ints(x).to(torch.int16).to(torch.int32))

    rep = sched.analyze_schedule(_trace(step, F32), _spec())
    trips = [v for v in rep.violations if v.rule == "P002" and "round-trip" in v.message]
    assert trips, _rules(rep)
    assert "int16" in trips[0].where


def test_p002_float_mixed_precision_chain_not_flagged():
    def step(x):
        g = (x.to(torch.bfloat16) * 2).to(torch.float32)
        return _psum(_ints(g))

    rep = sched.analyze_schedule(_trace(step, F32), _spec())
    assert "P002" not in _rules(rep)


# ---------------------------------------------------------------------------
# P003: fused-route per-kernel HBM byte budget
# ---------------------------------------------------------------------------
def _fused_spec(**kw):
    return _spec(wire_kind="packed", bits=8, use_kernels=True, fused=True, **kw)


_P = torch.linspace(-1, 1, 1024)
_SCALARS = torch.tensor([0.01, 1.0, 0.1, 0.9, 0.0])


def test_p003_widened_fused_operand_flagged():
    def step(image, param, mom):
        p, m = ops.fused_apply_sgd(image, param, mom, _SCALARS)
        return p + 0.0 * m

    rep = sched.analyze_schedule(
        _trace(step, torch.ones(1024, dtype=torch.int32), _P, torch.zeros(1024)), _fused_spec())
    p3 = [v for v in rep.violations if v.rule == "P003"]
    assert p3, _rules(rep)  # 4096 B for a 1024 B budget
    assert "budget" in p3[0].message


def test_p003_packed_words_within_budget_clean():
    def step(words, param, mom):
        p, m = ops.fused_unpack_sgd(words, param, mom, _SCALARS, bits=8, n_summed=N)
        return p + 0.0 * m

    rep = sched.analyze_schedule(
        _trace(step, torch.zeros(256, dtype=torch.int32), _P, torch.zeros(1024)), _fused_spec())
    assert "P003" not in _rules(rep)


# ---------------------------------------------------------------------------
# schedule classification: serialized vs eligible
# ---------------------------------------------------------------------------
def test_monolithic_psum_is_serialized():
    rep = sched.analyze_schedule(_trace(lambda x: _psum(_ints(x)), F32), _spec())
    assert rep.n_wire_collectives == 1 and rep.n_serialized == 1
    assert rep.hidden_fraction == 0.0 and rep.interleavable_fraction == 0.0


def test_concurrent_dot_makes_collective_hideable():
    def step(x, a, b):
        y = a @ b  # neither feeds nor consumes the reduce: hideable work
        return _psum(_ints(x)).sum() + y.sum()

    m = torch.ones(32, 32)
    rep = sched.analyze_schedule(_trace(step, F32, m, m), _spec())
    assert rep.n_wire_collectives == 1 and rep.n_serialized == 0
    assert rep.hidden_fraction == 1.0
    row = rep.collectives[0]
    assert row["eligible"] and row["concurrent_flops"] >= 2 * 32 * 32 * 32


def test_dot_flops_of_the_matmul_ops():
    def f(a, b, c):
        return (a @ b, torch.bmm(c, c), torch.addmm(a[0], a, b),
                torch.nn.functional.linear(a, b))

    t = _trace(f, torch.ones(8, 16), torch.ones(16, 16), torch.ones(3, 4, 4))
    flops = sorted(sched.dot_flops(n, t) for n in t.nodes if sched.dot_flops(n, t))
    assert flops == sorted([2 * 8 * 16 * 16, 2 * 3 * 4 * 4 * 4, 2 * 8 * 16 * 16,
                            2 * 8 * 16 * 16])


# ---------------------------------------------------------------------------
# the byte accountant == Logged metering == BucketManifest == JAX's arithmetic
# ---------------------------------------------------------------------------
ALL_CODECS = sorted(WIRE_FORMATS) + [f"{p}:{k}" for p in sorted(PARAMETRIC_WIRE_FORMATS)
                                     for k in (8, 32)]


def _lim(codec, n):
    try:
        return make_wire_format(codec).clip_limit(n)
    except WireRangeError:
        return 0


def _meter_logged(codec, leaf_sizes, n, M):
    """M images' worth of pack calls through the port's Logged codec."""
    logged = Logged(make_wire_format(codec))
    for _ in range(M):
        for s in leaf_sizes:
            logged.pack(torch.zeros(s, dtype=torch.int32), n_workers=n)
    return logged.pack_bytes


def _declared(wf, size):
    return tf.payload_bytes(wf.name, wf.bits, size, k=getattr(wf, "k", 0))


# every codec at n in {1, 2, 4, 8} where its clip limit is at least 1 (the
# degenerate points, packed4 and dense4 at n = 8: test_degenerate_codec_refuses)
@pytest.mark.parametrize("codec,n", [(c, n) for c in ALL_CODECS for n in (1, 2, 4, 8)
                                     if _lim(c, n) >= 1])
def test_static_payload_equals_logged_metering(codec, n):
    wf = make_wire_format(codec)
    leaf_sizes, M = (129, 64, 7), 2
    declared = sum(_declared(wf, s) for s in leaf_sizes) * M
    assert declared == _meter_logged(codec, leaf_sizes, n, M)
    for s in leaf_sizes:
        k = getattr(wf, "k", 0)
        assert _declared(wf, s) == wf.wire_bytes(s) == jtr.payload_bytes(wf.name, wf.bits, s, k=k)
        assert (tf.leaf_wire_words(wf.name, wf.bits, s, k=k)
                == jtr.leaf_wire_words(wf.name, wf.bits, s, k=k))
        assert tf.word_itemsize(wf.name, wf.bits) == jtr.word_itemsize(wf.name, wf.bits)


def test_degenerate_codec_refuses():
    # packed4 (and dense4) at n = 8: clip limit 7 // 8 == 0, the
    # WireRangeError condition; the chain proof reports it as a violation
    for codec in ("packed4", "dense4"):
        with pytest.raises(WireRangeError):
            make_wire_format(codec).encode(torch.zeros(4), torch.tensor(1.0),
                                           torch.tensor(0, dtype=torch.int32), n_workers=8)
    with pytest.raises(WireRangeError):
        make_wire_format("packed4").pack(torch.zeros(4, dtype=torch.int32), n_workers=8)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(codec=st.sampled_from(ALL_CODECS),
       leaf_sizes=st.lists(st.integers(min_value=1, max_value=300), min_size=1, max_size=4),
       n=st.integers(min_value=1, max_value=8), M=st.integers(min_value=1, max_value=4))
def test_static_accountant_matches_logged_property(codec, leaf_sizes, n, M):
    assume(_lim(codec, n) >= 1)
    wf = make_wire_format(codec)
    declared = sum(_declared(wf, s) for s in leaf_sizes) * M
    assert declared == _meter_logged(codec, leaf_sizes, n, M)


@pytest.mark.parametrize("bucket", (1, 7, 512, 4096, 1 << 16))
def test_plan_bucket_sizes_matches_plan_buckets(bucket):
    wf = make_wire_format("packed8")
    leaf_sizes = (5000, 3000, 171)
    words = {str(i): wf.pack(torch.zeros(s, dtype=torch.int32), n_workers=N)
             for i, s in enumerate(leaf_sizes)}
    manifest = bucketing.plan_buckets(words, bucket_words=bucket)
    total = sum(tf.leaf_wire_words("packed", 8, s) for s in leaf_sizes)
    assert manifest.total_words == total
    assert manifest.bucket_sizes == tf.plan_bucket_sizes(total, bucket)
    assert tf.plan_bucket_sizes(total, bucket) == jtr.plan_bucket_sizes(total, bucket)
    assert manifest.payload_bytes == sum(tf.payload_bytes("packed", 8, s) for s in leaf_sizes)


def test_manifest_ring_collectives_matches_transport_plan():
    wf = make_wire_format("packed8")
    leaf_sizes, M, B = (5000, 3000, 171), 2, 512
    words = {str(i): wf.pack(torch.zeros(s, dtype=torch.int32), n_workers=N)
             for i, s in enumerate(leaf_sizes)}
    manifest = bucketing.plan_buckets(words, bucket_words=B)
    plan = tf.plan_transport(_spec(n_accum=M, wire_kind="packed", bits=8,
                                   leaf_sizes=leaf_sizes, overlap="ring", bucket_words=B))
    # one psum node per image, its leaves the buckets: no chunk padding
    assert plan.n_eqns == M and plan.n_leaves == manifest.n_buckets * M
    assert plan.coll_bytes == manifest.payload_bytes * M and plan.padding_bytes == 0


# ---------------------------------------------------------------------------
# T-rules: node-level drift from the declared transport
# ---------------------------------------------------------------------------
def _dense8(x):
    return torch.clamp(torch.round(x), -3, 3).to(torch.int8)


def test_traffic_serial_route_clean():
    rep = tf.account_traffic(_trace(lambda x: _psum(_dense8(x)), F32),
                             _spec(leaf_sizes=(256,), overlap="off"))
    assert rep.ok, _rules(rep)
    assert rep.observed_eqns == rep.plan.n_eqns == 1
    assert rep.observed_bytes == rep.plan.coll_bytes == 256


def test_t001_widened_wire_flagged():
    rep = tf.account_traffic(_trace(lambda x: _psum(_ints(x)), F32),
                             _spec(leaf_sizes=(256,), overlap="off"))
    assert _rules(rep) == ["T001"]
    assert "1024 != declared transport 256" in rep.violations[0].message


def test_t002_split_collective_flagged():
    def step(x):
        ints = _dense8(x)  # the same payload, two nodes
        return torch.cat([_psum(ints[:128]), _psum(ints[128:])])

    rep = tf.account_traffic(_trace(step, F32), _spec(leaf_sizes=(256,), overlap="off"))
    assert _rules(rep) == ["T002"]


def test_t002_bucket_count_drift_flagged():
    def step(x):  # the ring route's node, cut into 3 buckets where 2 are declared
        ints = _dense8(x)
        return coll.psum_wire_words_bucketed([[ints[:100], ints[100:200], ints[200:]]] * N)

    spec = _spec(leaf_sizes=(256,), overlap="ring", bucket_words=128)
    rep = tf.account_traffic(_trace(step, F32), spec)
    assert _rules(rep) == ["T002"] and rep.observed_leaves == 3 and rep.plan.n_leaves == 2


def test_traffic_skipped_without_leaf_sizes():
    rep = tf.account_traffic(_trace(lambda x: _psum(_ints(x)), F32), _spec())
    assert rep.plan is None and rep.ok


# ---------------------------------------------------------------------------
# the composed audit: suppression + report shape
# ---------------------------------------------------------------------------
def test_full_audit_suppression_spans_rule_families():
    def step(x):
        ints = _ints(x)
        return _psum(ints) + _psum(ints)  # planted P002 duplicate

    t = _trace(step, F32)
    spec = _spec(bits=32)
    assert any(v.rule == "P002" for v in sched.full_audit(t, spec).violations)
    waived = sched.full_audit(t, spec, suppress={"P002": "planted fixture for this test"})
    assert "P002" not in _rules(waived)
    assert any(v.rule == "P002" for v, _why in waived.suppressed)
    with pytest.raises(ValueError, match="unknown rule"):
        sched.full_audit(t, spec, suppress={"Z999": "nope"})
    with pytest.raises(ValueError, match="justification"):
        sched.full_audit(t, spec, suppress={"P002": "  "})


def test_full_report_dict_has_all_sections():
    d = sched.full_audit(_trace(lambda x: _psum(_ints(x)), F32), _spec(bits=32)).to_dict()
    assert "schedule" in d and "traffic" in d
    assert {"hidden_fraction", "interleavable_fraction", "collectives"} <= set(d["schedule"])
    assert {"declared", "observed_eqns", "observed_bytes"} <= set(d["traffic"])


def test_matrix_diff_ignores_timing_and_names_drift():
    from repro_torch.analysis.__main__ import _diff_reports

    base = {
        "points": [
            {"config": "a", "codec": "packed8", "overlap": "off", "microbatches": 1,
             "fused": False, "ok": True, "violations": [], "seconds": 1.0},
            {"config": "a", "codec": "packed8", "overlap": "ring", "microbatches": 4,
             "fused": False, "ok": True, "violations": [], "seconds": 2.0},
        ],
        "lint": [],
    }
    same = copy.deepcopy(base)
    same["points"][0]["seconds"] = 99.0  # timings churn freely
    assert _diff_reports(base, same) == []
    removed = copy.deepcopy(base)
    removed["points"].pop()
    drift = _diff_reports(base, removed)
    assert len(drift) == 1 and "removed" in drift[0]
    flipped = copy.deepcopy(base)
    flipped["points"][1]["ok"] = False
    flipped["points"][1]["violations"] = [{"rule": "T001", "where": "w", "message": "m"}]
    drift = _diff_reports(base, flipped)
    assert len(drift) == 1 and "verdict changed" in drift[0] and "T001" in drift[0]


def test_matrix_cli_one_point(tmp_path):
    from repro_torch.analysis.__main__ import main

    report = tmp_path / "r.json"
    args = ["--matrix", "--check", "--configs", "granite-8b", "--codecs", "dense8",
            "--overlaps", "off", "--microbatches", "1", "--no-fused-points",
            "--report", str(report)]
    assert main(args) == 0 and report.exists()
    assert main(args + ["--diff"]) == 0


def test_rule_ids_disjoint_across_families():
    from repro_torch.analysis.lint import LINT_RULES

    ids = [r for fam in (wa.RULES, sched.RULES, tf.RULES, LINT_RULES) for r in fam]
    assert len(ids) == len(set(ids))
    assert {r[0] for r in ids} == {"W", "P", "T", "C"}
    assert sorted(ids) == ["C001", "C002", "C003", "P001", "P002", "P003", "T001", "T002",
                           "W001", "W002", "W003"]


# ---------------------------------------------------------------------------
# the real thing: the port's compressed step, recorded
# ---------------------------------------------------------------------------
def _real(codec, ov, m, fused, *, n=N, group=None):
    cfg = smoke_config(get_arch("granite-8b"))
    shape = ShapeConfig("t", 32, N * m, "train")
    wf = make_wire_format(codec)
    comp = make_compressor("intsgd", bits=wf.bits, wire=codec)
    opt = OPTIMIZERS["sgd"]()
    art = build_train_step(cfg, shape, n_workers=n, compressor=comp, base_opt=opt,
                           lr_schedule=constant(0.1), param_dtype=torch.float32, fused=fused,
                           microbatches=m, device="cpu", overlap=ov, bucket_words=4096,
                           group=group)
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    opt_state, comp_state = build_init_state(params, n_workers=n, compressor=comp,
                                             base_opt=opt, fused=fused, group=group)
    batch = materialize_batch(cfg, shape, torch.Generator().manual_seed(1), "cpu")
    seeds = leaf_seeds(torch.Generator().manual_seed(2), n, len(params), "cpu",
                       m if comp.fused_capable else 1)
    return art, (params, opt_state, comp_state, 1, batch, seeds)


# granite smoke; packed8, dense8 and topk8:64; off and ring; M in {1, 2};
# fused where the codec can at M = 1
_GRID = [(codec, ov, m, m == 1 and not codec.startswith("topk"))
         for codec in ("packed8", "dense8", "topk8:64") for ov in ("off", "ring")
         for m in (1, 2)]


@pytest.mark.parametrize("codec,ov,m,fused", _GRID)
def test_forced_mesh_full_audit_and_roofline(codec, ov, m, fused):
    """The port's real step on the local backend's 4 workers (the
    reference's forced 4-device mesh): W/P/T clean, bytes and counts exact,
    the pipelined ring interleavable and hidden, the serial psum
    serialized."""
    art, args = _real(codec, ov, m, fused)
    rep = sched.verify_step(art, args=args)
    assert rep.ok, rep.violations
    s, t, a = rep.schedule, rep.traffic, rep.audit
    assert t.observed_bytes == t.plan.coll_bytes and t.observed_eqns == t.plan.n_eqns
    assert a.stats["clips_checked"] >= 1 and a.stats["int_wire_ops"] >= 1
    assert s.backward_flops > 0
    if m == 2 and not codec.startswith("topk"):
        # image 0's reduce is unordered with image 1's backward, and back
        assert s.n_wire_collectives == 2
        assert s.hidden_fraction == 1.0 and s.interleavable_fraction == 1.0, s.to_dict()
    else:  # one monolithic reduce: every matmul feeds it
        assert s.n_wire_collectives == 1 and s.n_serialized == 1


def test_recording_changes_nothing():
    art, args = _real("packed8", "ring", 2, False)
    plain = art.steps["compressed"](*copy.deepcopy(args))
    recorded, trace = tr.record(art.steps["compressed"], *copy.deepcopy(args))
    assert len(trace.nodes) > 1000

    def flat(x):
        return tr._tensors(x)

    a, b = flat(plain), flat(recorded)
    assert len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def _gloo_rank(group, rank):
    import torch as _torch

    from repro_torch.analysis import schedule as _sched
    from repro_torch.analysis import trace as _tr

    art, args = _real("packed8", "ring", 2, False, group=group)
    plain = art.steps["compressed"](*copy.deepcopy(args))
    out, trace = _tr.record(art.steps["compressed"], *copy.deepcopy(args))
    rep = _sched.full_audit(trace, art.audit_spec)
    wire = [n for n in trace.nodes if n.kind == "collective" and n.axis == "data"
            and any(lf.kind == "i" for lf in n.leaves)]
    same = all(_torch.equal(u, v) for u, v in zip(_tr._tensors(plain), _tr._tensors(out)))
    return dict(ok=rep.ok, violations=[str(v) for v in rep.violations], same=same,
                n_contrib=[n.n_contrib for n in wire],
                calls=[n.stats["async_calls"] for n in wire],
                leaves=[len(n.leaves) for n in wire],
                hidden=rep.schedule.hidden_fraction,
                bytes=(rep.traffic.observed_bytes, rep.traffic.plan.coll_bytes))


def test_forced_mesh_audit_four_workers():
    """The step on four gloo ranks (the port's counterpart of the
    reference's forced 4-device mesh): every rank's recorded step passes, one
    psum node per image over the group (its in-place async reduces bound
    at wait()), one all_reduce a bucket, bit-equal to the step unrecorded."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    ranks = run_ranks(_gloo_rank, N, backend="gloo", timeout_s=300)
    for r in ranks:
        assert r["ok"], r["violations"]
        assert r["same"] and r["n_contrib"] == [N, N]
        assert r["bytes"][0] == r["bytes"][1]
        assert r["calls"] == r["leaves"]  # one async all_reduce a bucket
        assert r["hidden"] == 1.0
