"""Straggler mitigation by partial integer aggregation (port of
``repro/runtime/straggler.py``).

IntSGD's wire is a plain SUM of integers, so dropping the late workers is
exact: sum what arrived and divide by n_live·α in place of n·α. The result
is an unbiased (sub)gradient of the mean over the contributing workers (the
same objective under iid data; under heterogeneous data the variance of
client sampling). PowerSGD's two-phase all-reduces and QSGD's all-gather
cannot drop a late worker without restarting the collective.

The partial sum goes over the WIRE CODEC: a late worker sends the codec's
encoding of the all-zeros image. Its image is zero-masked (``v * alive`` in
int32) BEFORE pack. For :class:`~repro_torch.wire.packed.PackedInt` each
field carries ``v + lim``, so the dead worker's word is the pure bias
pattern ``Σ_j lim << j·bits``, not the zero word; ``unpack(n_summed=n)``
subtracts ``n·lim`` per field, the dead workers' bias included, and the
masked contribution is exactly zero. For a gather codec (TopKInt) the
masked image selects zeros at indices 0..k-1, which scatter-add nothing.
The aggregation goes through :meth:`~repro_torch.core.comm.CommCtx.psum_wire`
like every other wire sum (the integer-only guard, the bucketed and gather
routes), and n_live is summed as an int32 payload: no float crosses the
wire.

In production the deadline lives in the collective runtime; here it is a
mask, so the policy is testable: this is the aggregation rule that the
paper's Algorithm 1, line 12, degrades to under loss.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Union

import torch

from repro_torch.core.comm import CommCtx
from repro_torch.parallel import collectives as coll
from repro_torch.wire import DenseInt, WireFormat

Tree = Dict[str, torch.Tensor]


def _alive_flags(alive, n_local: int) -> list:
    """One int32 0/1 per local worker, from bools (a sequence, a bool
    tensor, or a single bool on a process group)."""
    flags = torch.as_tensor(alive, dtype=torch.bool).reshape(-1)
    if flags.numel() != n_local:
        raise ValueError(f"alive has {flags.numel()} flags for {n_local} local workers")
    return [int(a) for a in flags.tolist()]


def straggler_tolerant_sum(worker_ints: Iterable[Tree], alive: Union[Sequence[bool], torch.Tensor],
                           ctx: CommCtx, wf: WireFormat | None = None):
    """Partial integer aggregation over the wire codec.

    ``worker_ints``: the local workers' Int(α∘g) images (the §5.1-clipped
    integer trees), in worker order, as ``CommCtx.psum_wire`` takes them;
    ``alive``: one bool per local worker (did it make the deadline) — on a
    process group this rank's own; ``wf``: the codec the images ride (the
    int32 dense transport by default). Returns ``(sum over the alive
    workers, n_live)``, n_live a 0-d int32 tensor, the same on every
    worker."""
    wf = DenseInt(bits=32) if wf is None else wf
    flags = _alive_flags(alive, ctx.n_local)

    def masked():
        for ints, a in zip(worker_ints, flags):
            yield {k: v * a for k, v in ints.items()}  # int32 stays int32

    _, int_sum = ctx.psum_wire(masked(), wf)
    dev = next(iter(int_sum.values())).device
    n_live = coll.psum_wire_words(
        ({"n_live": torch.tensor(a, dtype=torch.int32, device=dev)} for a in flags),
        ctx.group)["n_live"]
    return int_sum, n_live


def decode_partial(int_sum_tree: Tree, alphas, n_live: torch.Tensor):
    """ĝ = (1/(n_live·α_l)) Σ_alive Int(α_l g_i) per leaf, as
    ``s.float() / (max(n_live, 1).float() * α)`` (the JAX package's order,
    bit for bit).

    ``alphas`` is one scalar α (Algorithm 1) or a per-leaf dict (Algorithm
    2's blockwise rule): each leaf divides by its own α. Returns ``(ĝ,
    all_dead)``: with no worker alive there is no gradient information, and
    a silent zero decode would freeze training unseen, so the bool flag
    surfaces it (the training loop skips the step or reruns the round) while the
    max(n_live, 1) guard keeps the division finite."""
    if not isinstance(alphas, dict):
        alphas = {k: alphas for k in int_sum_tree}
    all_dead = n_live == 0
    denom = torch.clamp(n_live, min=1).to(torch.float32)
    ghat = {k: s.to(torch.float32) / (denom * alphas[k]) for k, s in int_sum_tree.items()}
    return ghat, all_dead
