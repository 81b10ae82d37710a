"""AST contract linter over the port (port of ``repro/analysis/lint.py``;
C = contract; no torch import anywhere in this module, so it runs before a
test session pays torch's start-up).

Rules:

  C001  single resolution point — the raw ``torch.distributed`` surface
        that moves or synchronizes data (``all_reduce``, ``all_gather``,
        ``all_gather_into_tensor``, ``all_to_all``, ``all_to_all_single``,
        ``reduce_scatter*``, ``broadcast``, ``send``/``recv``,
        ``isend``/``irecv``, ``new_group``, ``init_process_group``) may be
        touched ONLY by ``src/repro_torch/parallel/collectives.py``. Every
        other module goes through that shim (or ``CommCtx``), which is what
        gives the recorder (:mod:`repro_torch.analysis.trace`) one place to
        tag each collective with its axis.
  C002  optimizer contract — every ``Optimizer(...)`` construction passes
        ``dx_scale`` AND ``fused_kernel`` explicitly.
  C003  codec locality — every ``WireFormat`` subclass lives under
        ``src/repro_torch/wire/``.

Suppression: end the offending line (or the line above it) with

    # lint: allow(C001) -- <justification>

A non-empty justification is REQUIRED; a bare allow is itself a violation.

CLI: ``python -m repro_torch.analysis.lint src/repro_torch tests`` — prints
violations, exits non-zero if any.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["LINT_RULES", "LintViolation", "lint_source", "lint_paths", "main"]

BANNED_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "broadcast", "send", "recv", "isend", "irecv",
    "new_group", "init_process_group",
})
# every member of this family is raw surface
_BANNED_PREFIXES = ("reduce_scatter",)

_RAW_MODULES = ("torch.distributed",)

_SHIM = "repro_torch/parallel/collectives.py"

LINT_RULES = {
    "C001": "raw torch.distributed collectives only in repro_torch/parallel/collectives.py",
    "C002": "Optimizer(...) must pass dx_scale and fused_kernel explicitly",
    "C003": "WireFormat subclasses must live under src/repro_torch/wire/",
}

_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\((?P<rules>[A-Z0-9,\s]+)\)\s*(?:--\s*(?P<why>.*\S))?"
)


def _banned(member: str) -> bool:
    return member in BANNED_COLLECTIVES or member.startswith(_BANNED_PREFIXES)


@dataclasses.dataclass(frozen=True)
class LintViolation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _allowances(lines: Sequence[str]) -> Dict[int, Dict[str, Optional[str]]]:
    """1-based line -> {rule: justification|None}; an allow comment covers
    its own line and the line below it."""
    out: Dict[int, Dict[str, Optional[str]]] = {}
    for i, text in enumerate(lines, start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        rules = [r.strip() for r in m.group("rules").split(",") if r.strip()]
        why = m.group("why")
        for ln in (i, i + 1):
            d = out.setdefault(ln, {})
            for r in rules:
                d[r] = why
    return out


class _Imports(ast.NodeVisitor):
    """name in this module -> the dotted path it denotes."""

    def __init__(self):
        self.names: Dict[str, str] = {}

    def visit_Import(self, node):
        for a in node.names:
            if a.asname:
                self.names[a.asname] = a.name
            else:
                head = a.name.split(".")[0]
                self.names[head] = head

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        for a in node.names:
            self.names[a.asname or a.name] = f"{mod}.{a.name}" if mod else a.name


def _dotted(node) -> Optional[str]:
    """Attribute/Name chain -> dotted string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _resolve(dotted: str, names: Dict[str, str]) -> str:
    head, _, rest = dotted.partition(".")
    base = names.get(head, head)
    return f"{base}.{rest}" if rest else base


def lint_source(source: str, path: str = "<string>") -> List[LintViolation]:
    """Lint one module's source. `path` is used for rule scoping (the shim
    exemption, the wire-package check) and reporting — pass a path
    relative to the repo root when you have one."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [LintViolation("C000", path, e.lineno or 0, f"syntax error: {e.msg}")]
    lines = source.splitlines()
    allows = _allowances(lines)
    imports = _Imports()
    imports.visit(tree)
    names = imports.names
    norm = path.replace("\\", "/")
    is_shim = norm.endswith(_SHIM)
    in_wire_pkg = "/wire/" in norm or norm.endswith("/wire")

    found: List[LintViolation] = []

    def emit(rule: str, line: int, msg: str):
        allow = allows.get(line, {}).get(rule, "missing")
        if allow is None:
            found.append(LintViolation(
                rule, path, line,
                f"allow({rule}) needs a justification: `# lint: allow({rule}) -- <why>`",
            ))
        elif allow == "missing":
            found.append(LintViolation(rule, path, line, msg))
        # else: suppressed with a recorded justification

    for node in ast.walk(tree):
        # ---- C001: raw collective surface -----------------------------
        if not is_shim:
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod in _RAW_MODULES:
                    for a in node.names:
                        if _banned(a.name):
                            emit("C001", node.lineno,
                                 f"importing {a.name!r} from {mod} — route it through "
                                 f"repro_torch.parallel.collectives ({LINT_RULES['C001']})")
            if isinstance(node, ast.Attribute):
                dotted = _dotted(node)
                if dotted and "." in dotted:
                    resolved = _resolve(dotted, names)
                    mod, _, member = resolved.rpartition(".")
                    if _banned(member) and mod in _RAW_MODULES:
                        emit("C001", node.lineno,
                             f"raw {resolved} — route it through "
                             f"repro_torch.parallel.collectives ({LINT_RULES['C001']})")
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                target = names.get(node.func.id, "")
                mod, _, member = target.rpartition(".")
                if _banned(member) and mod in _RAW_MODULES:
                    emit("C001", node.lineno,
                         f"call to {target} (imported as {node.func.id!r}) — route it "
                         f"through repro_torch.parallel.collectives")

        # ---- C002: Optimizer(...) contract ----------------------------
        if isinstance(node, ast.Call):
            callee = None
            if isinstance(node.func, ast.Name):
                callee = node.func.id
            elif isinstance(node.func, ast.Attribute):
                callee = node.func.attr
            if callee == "Optimizer":
                kw = {k.arg for k in node.keywords}
                missing = [k for k in ("dx_scale", "fused_kernel") if k not in kw]
                if missing and None not in kw:  # **kwargs splat: can't tell
                    emit("C002", node.lineno,
                         f"Optimizer(...) without explicit {' and '.join(missing)} — every "
                         f"optimizer must declare its §4.1 Δx rescale and its fused-kernel "
                         f"capability ({LINT_RULES['C002']})")

        # ---- C003: WireFormat locality --------------------------------
        if isinstance(node, ast.ClassDef) and not in_wire_pkg:
            for base in node.bases:
                base_name = (
                    base.id if isinstance(base, ast.Name)
                    else base.attr if isinstance(base, ast.Attribute)
                    else None
                )
                if base_name == "WireFormat":
                    emit("C003", node.lineno,
                         f"WireFormat subclass {node.name!r} outside src/repro_torch/wire/ — "
                         f"the codec registry and the wire auditor enumerate that package "
                         f"({LINT_RULES['C003']})")
    # de-duplicate (an Attribute inside a Call is visited twice)
    uniq = {}
    for v in found:
        uniq.setdefault((v.rule, v.line, v.message), v)
    return sorted(uniq.values(), key=lambda v: (v.path, v.line, v.rule))


def lint_paths(paths: Sequence[str]) -> List[LintViolation]:
    out: List[LintViolation] = []
    for p in paths:
        root = Path(p)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            out.extend(lint_source(f.read_text(), str(f)))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m repro_torch.analysis.lint <path> [path ...]")
        return 2
    violations = lint_paths(args)
    for v in violations:
        print(v)
    print(f"lint: {len(violations)} violation(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
