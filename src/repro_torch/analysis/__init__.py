"""repro_torch.analysis — static verification of the port's contracts
(port of ``repro/analysis``).

The JAX package audits a traced jaxpr. The port audits a **recorded trace
of one step** (:mod:`repro_torch.analysis.trace`): every aten op the step
runs, with the wire's collectives and the kernels as one node each, and the
same rule families over it:

  * the floatless-wire AUDITOR (``trace`` + ``intervals`` + ``wire_audit``):
    no float on the data-parallel wire, and the §5.1 guard-bit/overflow
    invariants for the declared (codec, n_workers, microbatches) — W-rules;
  * the PERFORMANCE auditor (``schedule`` + ``traffic``): the wire
    collectives' overlap eligibility on the recorded dataflow (P-rules and a
    static roofline), and their bytes and counts against the port's own
    transport (T-rules); ``schedule.full_audit`` composes all three;
  * the AST contract LINTER (``lint``): C-rules over the port's source tree,
    no torch import on its path.

This ``__init__`` stays import-light on purpose: ``python -m
repro_torch.analysis.lint src/repro_torch tests`` runs before anything
imports torch. The audit API is re-exported lazily.

CLI: ``python -m repro_torch.analysis --matrix [--check] [--diff]`` sweeps
the (config × codec × overlap × microbatch) grid, each point's step
recorded on the meta device, and writes ``ANALYSIS_report_torch.json``.
"""
from __future__ import annotations

_LAZY = {
    "audit_trace": "repro_torch.analysis.wire_audit",
    "audit_step": "repro_torch.analysis.wire_audit",
    "spec_for_step": "repro_torch.analysis.wire_audit",
    "WireSpec": "repro_torch.analysis.wire_audit",
    "Violation": "repro_torch.analysis.wire_audit",
    "AuditReport": "repro_torch.analysis.wire_audit",
    "WireAuditError": "repro_torch.analysis.wire_audit",
    "RULES": "repro_torch.analysis.wire_audit",
    "SCALAR_REDUCE_ALLOWANCE": "repro_torch.analysis.wire_audit",
    "Interval": "repro_torch.analysis.intervals",
    "wire_chain_proof": "repro_torch.analysis.intervals",
    "eval_trace_intervals": "repro_torch.analysis.intervals",
    "record": "repro_torch.analysis.trace",
    "Trace": "repro_torch.analysis.trace",
    "COLLECTIVES": "repro_torch.analysis.trace",
    "build_graph": "repro_torch.analysis.trace",
    "backward_nodes": "repro_torch.analysis.trace",
    "forward_nodes": "repro_torch.analysis.trace",
    "analyze_schedule": "repro_torch.analysis.schedule",
    "full_audit": "repro_torch.analysis.schedule",
    "verify_step": "repro_torch.analysis.schedule",
    "ScheduleReport": "repro_torch.analysis.schedule",
    "FullReport": "repro_torch.analysis.schedule",
    "account_traffic": "repro_torch.analysis.traffic",
    "plan_transport": "repro_torch.analysis.traffic",
    "TransportPlan": "repro_torch.analysis.traffic",
    "TrafficReport": "repro_torch.analysis.traffic",
    "lint_paths": "repro_torch.analysis.lint",
    "lint_source": "repro_torch.analysis.lint",
    "LINT_RULES": "repro_torch.analysis.lint",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
