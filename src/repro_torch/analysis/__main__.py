"""``python -m repro_torch.analysis --matrix`` — sweep the full static audit
(W wire rules + P schedule rules + T traffic rules) over the supported
(config × codec × overlap × microbatch) grid, run the contract linter over
``src/repro_torch`` + ``tests/``, and write ``ANALYSIS_report_torch.json``
(port of ``repro/analysis/__main__.py``).

Every point builds the real train step (``build_train_step``) at the smoke
size on the local backend with 4 workers, records its compressed step on the
meta device and runs :func:`repro_torch.analysis.schedule.full_audit` —
shapes only: no memory, no kernel, no card. A few fused points ride along
for W003/P003 coverage.

``--check`` exits non-zero on any violation. ``--diff`` compares the fresh
sweep against the report at ``--report`` instead of rewriting it: new or
removed grid points, flipped verdicts, or changed violation sets fail the
run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

DEFAULT_CODECS = ("dense8", "packed8", "topk8:64")
DEFAULT_OVERLAPS = ("off", "ring")
DEFAULT_MICROBATCHES = (1, 4)
DEFAULT_REPORT = "ANALYSIS_report_torch.json"
SEQ = 64
WORKERS = 4  # the local backend's
BUCKET_WORDS = 4096  # several buckets at the smoke size

# (config, codec, overlap, microbatches, fused) — the identity of one grid
# point; everything else in an entry is a verdict about it
POINT_KEY = ("config", "codec", "overlap", "microbatches", "fused")


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    p.add_argument("--matrix", action="store_true", help="sweep the audit over the grid")
    p.add_argument("--check", action="store_true",
                   help="exit non-zero on any lint/audit violation")
    p.add_argument("--diff", action="store_true",
                   help="compare against the report at --report instead of rewriting it; "
                        "exit non-zero on any drift")
    p.add_argument("--configs", default=None,
                   help="comma-separated arch subset (default: every shipped config)")
    p.add_argument("--codecs", default=",".join(DEFAULT_CODECS))
    p.add_argument("--overlaps", default=",".join(DEFAULT_OVERLAPS))
    p.add_argument("--microbatches", default=",".join(map(str, DEFAULT_MICROBATCHES)))
    p.add_argument("--no-fused-points", action="store_true",
                   help="skip the extra fused-route (W003/P003) points")
    p.add_argument("--report", default=DEFAULT_REPORT)
    return p.parse_args(argv)


def _point_key(entry) -> tuple:
    return tuple(entry[k] for k in POINT_KEY)


def _fmt_key(key: tuple) -> str:
    return " × ".join(f"{k}={v}" for k, v in zip(POINT_KEY, key))


def _verdict(entry) -> dict:
    """The drift-relevant slice of a point entry: the verdict and the rule
    ids behind it — never timing, never message text."""
    return {
        "ok": bool(entry.get("ok")),
        "rules": sorted({v["rule"] for v in entry.get("violations", [])}),
        "error": "error" in entry,
    }


def _diff_reports(old: dict, new: dict) -> list:
    """Human-readable drift lines between two matrix reports ([] = none):
    the grid point SET and each point's verdict (``ok`` + violation rule
    ids + build-error-ness); timings, roofline numbers and message wording
    are ignored."""
    drift = []
    old_pts = {_point_key(e): e for e in old.get("points", [])}
    new_pts = {_point_key(e): e for e in new.get("points", [])}
    for key in sorted(old_pts.keys() - new_pts.keys()):
        drift.append(f"point removed: {_fmt_key(key)}")
    for key in sorted(new_pts.keys() - old_pts.keys()):
        drift.append(f"point added: {_fmt_key(key)}")
    for key in sorted(old_pts.keys() & new_pts.keys()):
        was, now = _verdict(old_pts[key]), _verdict(new_pts[key])
        if was != now:
            drift.append(
                f"verdict changed: {_fmt_key(key)}: ok {was['ok']}->{now['ok']}, "
                f"rules {was['rules']}->{now['rules']}"
                + (", build error appeared" if now["error"] and not was["error"]
                   else ", build error gone" if was["error"] and not now["error"] else ""))
    if bool(old.get("lint")) != bool(new.get("lint")):
        drift.append(f"lint drift: {len(old.get('lint', []))} committed violation(s) vs "
                     f"{len(new.get('lint', []))} fresh")
    return drift


def _lcm(values) -> int:
    out = 1
    for m in values:
        a, b = out, m
        while b:
            a, b = b, a % b
        out = out * m // a
    return out


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    if not args.matrix:
        print("nothing to do: pass --matrix (or use `python -m repro_torch.analysis.lint "
              "<paths>` for the linter alone)")
        return 2

    from repro_torch.analysis import lint as lint_mod

    src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = os.path.dirname(os.path.dirname(src_root))
    tests = os.path.join(repo_root, "tests")
    lint_violations = lint_mod.lint_paths([src_root] + ([tests] if os.path.isdir(tests) else []))
    for v in lint_violations:
        print(f"LINT {v}")

    import torch

    from repro_torch.analysis import schedule as schedule_mod
    from repro_torch.configs.base import ShapeConfig, get_arch, ported_archs, smoke_config
    from repro_torch.core.compressor import make_compressor
    from repro_torch.launch.step import build_train_step
    from repro_torch.optim.schedules import constant
    from repro_torch.optim.sgd import sgd
    from repro_torch.wire import make_wire_format

    configs = ([c.strip() for c in args.configs.split(",") if c.strip()] if args.configs
               else ported_archs())
    codecs = [c.strip() for c in args.codecs.split(",") if c.strip()]
    for c in codecs:
        make_wire_format(c)  # a typo fails NOW with the registry's option list
    overlaps = [o.strip() for o in args.overlaps.split(",") if o.strip()]
    micro = [int(m) for m in args.microbatches.split(",") if m.strip()]
    n = WORKERS
    shape = ShapeConfig("analysis", SEQ, n * _lcm(micro), "train")

    points = [(arch, codec, ov, m, False)
              for arch in configs for codec in codecs for ov in overlaps for m in micro]
    if not args.no_fused_points and configs:
        # the fused route takes M = 1; the packed point exercises W003/P003,
        # the dense point pins the fused dense lanes as in contract
        points += [(configs[0], "packed8", "off", 1, True),
                   (configs[0], "dense8", "off", 1, True)]

    results = []
    t_all = time.time()
    for arch, codec, ov, m, fused in points:
        label = f"{arch} × {codec} × overlap={ov} × M={m}" + (" × fused" if fused else "")
        t0 = time.time()
        base = {"config": arch, "codec": codec, "overlap": ov, "microbatches": m,
                "fused": fused}
        try:
            art = build_train_step(
                smoke_config(get_arch(arch)), shape, n_workers=n,
                compressor=make_compressor("intsgd", bits=make_wire_format(codec).bits,
                                           wire=codec),
                base_opt=sgd(momentum=0.9), lr_schedule=constant(0.1),
                param_dtype=torch.float32, fused=fused, microbatches=m, device="meta",
                overlap=ov, bucket_words=BUCKET_WORDS)
            report = schedule_mod.verify_step(art)
            entry = {**base, **report.to_dict()}
        except Exception as e:  # a build or record failure is a matrix failure
            entry = {**base, "ok": False, "error": f"{type(e).__name__}: {e}",
                     "violations": []}
        entry["seconds"] = round(time.time() - t0, 2)
        results.append(entry)
        sched = entry.get("schedule") or {}
        extra = (f" [coll={sched['n_wire_collectives']} hidden={sched['hidden_fraction']:.2f}"
                 f" inter={sched['interleavable_fraction']:.2f}]" if sched else "")
        print(f"audit {label}: {'OK' if entry['ok'] else 'FAIL'}{extra} ({entry['seconds']}s)",
              flush=True)
        if not entry["ok"]:
            for v in entry.get("violations", []):
                print(f"    [{v['rule']}] {v['where']}: {v['message']}")
            if "error" in entry:
                print(f"    build error: {entry['error']}")

    ok = not lint_violations and all(r["ok"] for r in results)
    artifact = {
        "grid": {"configs": configs, "codecs": codecs, "overlaps": overlaps,
                 "microbatches": micro, "workers": n, "backend": "local", "device": "meta"},
        "lint": [v.to_dict() for v in lint_violations],
        "points": results,
        "ok": ok,
        "seconds": round(time.time() - t_all, 2),
    }

    drift = []
    if args.diff:
        if not os.path.exists(args.report):
            drift = [f"no report at {args.report} to diff against"]
        else:
            with open(args.report) as f:
                drift = _diff_reports(json.load(f), artifact)
        for line in drift:
            print(f"DIFF {line}")
        print(f"diff vs {args.report}: {len(drift)} drift line(s) (report NOT rewritten; "
              f"regenerate without --diff to accept)")
    else:
        with open(args.report, "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)

    n_bad = sum(not r["ok"] for r in results)
    print(f"matrix: {len(results)} points, {n_bad} failing, {len(lint_violations)} lint "
          f"violation(s){'' if args.diff else ' -> ' + args.report} ({artifact['seconds']}s)")
    if args.check and not ok:
        return 1
    if args.diff and drift:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
