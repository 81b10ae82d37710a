"""Elastic scaling: re-plan after node failures and keep training (port of
``repro/runtime/elastic.py``; the planner is plain Python, kept whole).

The property that makes IntSGD *elastic-friendly* (and that a fixed-α scheme
like Heuristic IntSGD lacks): the scaling rule α_k = √d / √(2 n r_k/η² + ε²)
takes the worker count n as an INPUT. When a data-parallel replica dies we
rebuild the mesh with n' = n - failed, recompute α with n', and the
convergence guarantees keep holding for the new n' (the theory never pins n).

Protocol (one coordinator):
  1. failure detector flags dead hosts (heartbeat timeout in production;
     injected in tests);
  2. pick the largest (dp', tp) grid covering the surviving hosts, dropping
     at most dp_step replicas — TP groups are rebuilt whole: a TP group with
     any dead member is retired entirely;
  3. restore the latest checkpoint at the new worker count
     (``launch.train.train_loop(resume=True, n_workers=n')``, at tp > 1
     on the new (n', tp) grid, ``grid=make_debug_mesh(n', tp)`` and a store
     on it): the store's global layout is mesh-agnostic, and every leaf of
     a fused-route IntSGD state is replicated over dp, so it loads at any
     n'; a leaf held one row per worker is refused, naming it and both
     counts;
  4. rebuild the step for the new count (its clip limit and α take n');
     rescale the per-worker batch or accept the smaller global batch
     (configurable policy);
  5. resume from the checkpointed step (the data pipeline is indexed by
     (step, worker) so no data is skipped or repeated).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.wire import WireRangeError, make_wire_format


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    n_dp: int  # surviving data-parallel replicas
    tp: int  # tensor-parallel degree (unchanged)
    retired_replicas: tuple  # dp indices dropped
    global_batch: int
    note: str


def plan_after_failures(
    *,
    dp: int,
    tp: int,
    failed_devices: Sequence[int],
    global_batch: int,
    keep_global_batch: bool = True,
    wire=None,
    microbatches: int = 1,
) -> ElasticPlan:
    """Devices are numbered dp-major: device = dp_index * tp + tp_index.
    A dp replica survives iff ALL of its tp members survive.

    ``wire`` (codec name or WireFormat) re-validates the wire configuration
    for the NEW worker count at plan time: the §5.1 clip limit
    ``(2^(bits-1)-1) // n`` depends on n, so growing back after failures (or
    a paradoxical shrink across a power-of-two boundary) can cross into the
    degenerate range where every integer clips to 0. Without this check the
    :class:`~repro_torch.wire.base.WireRangeError` only fires deep inside the
    rebuilt step, at its first encode — after the checkpoint restore and the
    rebuild are already done. Validating here fails (or warns via ``note``) before
    any of that starts.

    ``microbatches`` must match the rebuilt step's setting: with M-microbatch
    pipelining the step encodes with ``clip_limit(n_dp·M)``
    (``IntSGD.encode_ints(n_accum=M)``), so THAT is the product that must
    stay representable — and keep_global_batch re-meshes typically RAISE M
    to fit the bigger per-worker batch, pushing toward the boundary.
    """
    failed = set(failed_devices)
    retired = tuple(
        r for r in range(dp) if any(r * tp + t in failed for t in range(tp))
    )
    n_dp = dp - len(retired)
    if n_dp <= 0:
        raise RuntimeError("no complete TP group survives; cold restart required")
    if keep_global_batch:
        # keep the optimization trajectory: same global batch, bigger
        # per-worker microbatch (grad-accum if it no longer fits)
        gb = global_batch
        note = f"global batch kept at {gb}; per-worker batch x{dp}/{n_dp}"
    else:
        gb = global_batch * n_dp // dp
        note = f"global batch rescaled {global_batch}->{gb}; lr should scale by {n_dp}/{dp}"
    if wire is not None:
        wf = make_wire_format(wire)
        mb = f" x{microbatches} microbatches" if microbatches > 1 else ""
        if getattr(wf, "transport", "psum") == "gather":
            # A gather-transport codec (TopKInt) never divides its clip by
            # n, so clip_limit cannot degenerate — the n-dependent bound
            # moved to the DECODE side: unpack scatter-adds up to n_dp·M
            # full-range values per coordinate into an int32 image. k is
            # per-leaf and mesh-independent, but the gathered payload and
            # the image sum both scale with the surviving worker count, so
            # re-prove the bound here, at plan time, like the psum clip.
            lim = wf.clip_limit(n_dp * microbatches)
            worst = n_dp * microbatches * lim
            int32_max = 2**31 - 1
            if worst > int32_max:
                raise WireRangeError(
                    f"gather wire {wf.name}{wf.bits} cannot decode over "
                    f"{n_dp} workers{mb}: scatter-added image sum can reach "
                    f"{worst} > int32 max {int32_max}"
                )
            note += (
                f"; wire {wf.name}{wf.bits}:{wf.k} revalidated for "
                f"n_dp'={n_dp}{mb} (decoded image sum |Σ| <= {worst} fits "
                f"int32; k={wf.k} per leaf intact)"
            )
        else:
            # raises WireRangeError at PLAN time if int{bits} cannot carry
            # the accumulated sum over the surviving n_dp workers x M
            # microbatches
            lim_new = wf.clip_limit(n_dp * microbatches)
            try:
                lim_old = wf.clip_limit(dp * microbatches)
                delta = f"clip limit {lim_old}->{lim_new}"
            except WireRangeError:  # the OLD count was itself out of range
                delta = f"clip limit ->{lim_new} (previous n_dp={dp} was invalid)"
            note += (
                f"; wire {wf.name}{wf.bits} revalidated for n_dp'={n_dp}{mb} "
                f"({delta})"
            )
    return ElasticPlan(
        n_dp=n_dp, tp=tp, retired_replicas=retired, global_batch=gb, note=note
    )
