"""Batched serving engine: a continuous-batching decode loop (port of
``repro/serving/engine.py``).

  * slot-based continuous batching: requests claim free slots, and a
    finished sequence frees its slot without stalling the batch;
  * prompt prefill token by token through the batched decode step: every
    slot steps, as in the JAX package's engine. In the attention families
    the other slots rewrite their current KV entry with the same values.
    In the recurrent families (hybrid, ssm) they do not: each slot's O(1)
    state advances on every step, the other slots' prefill steps included,
    and a slot's state is not reset when it admits a request, which so
    inherits the state its slot's last occupant left. The port keeps this
    reference behaviour, so that its token streams equal the JAX engine's;
  * greedy sampling (:func:`~repro_torch.models.decode.tp_greedy`, the
    argmax at tp = 1);
  * a train→serve weight refresh over the integer wire
    (:meth:`ServeEngine.apply_wire_delta`): the replica receives transport
    words, never a float tensor.

The slots' positions and current tokens are kept on the host and sent with
each step; each step's next tokens come back to the host once per engine
iteration (one ``tolist``), not once per slot. The engine runs on
``device``: the card unless the caller asks for the CPU.

The JAX package's ``mesh=`` route runs the step through a replicated
``shard_map``: every device steps the same batch with the whole params.
Here ``mesh=`` is a ``torch.distributed`` process group: every rank holds
the whole params, steps the same batch at ``Axes()`` (no model axis), and
each step's next tokens are checked to agree across the ranks (two
integer all-reduces, max and min); a rank that disagrees raises. It adds
no sharded engine, which the JAX package lacks too: a sharded decode is
``launch.step.build_serve_step``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.models.decode import init_lm_cache, lm_decode_step, tp_greedy
from repro_torch.parallel import collectives as coll
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """``slots`` sequences of up to ``max_seq`` tokens decoded together:
    bf16 activations and a bf16 KV cache (the JAX engine's; the recurrent
    families' states float32), params in their own type."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor], *, slots: int = 4,
                 max_seq: int = 256, device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.slots = slots
        self.max_seq = max_seq
        self.cache = init_lm_cache(cfg, slots, max_seq, device=self.device)
        self.pos = [0] * slots
        self.cur_tok = [0] * slots
        self.active: List[Optional[Request]] = [None] * slots
        self.pending: List[Request] = []

    def step(self) -> torch.Tensor:
        """One batched decode step of every slot at its current token and
        position: the next tokens (slots,), on the device."""
        tokens = torch.tensor(self.cur_tok, dtype=torch.int64, device=self.device)
        pos = torch.tensor(self.pos, dtype=torch.int64, device=self.device)
        with torch.no_grad():
            logits, self.cache = lm_decode_step(self.params, self.cache, tokens, pos, self.cfg)
        nxt = tp_greedy(logits)
        if self.mesh is not None and not coll.all_agree(nxt, self.mesh):
            raise RuntimeError("the replicated engine's ranks picked different tokens")
        return nxt

    def apply_wire_delta(self, words, alphas, wf, *, n_summed: int = 1) -> None:
        """Train→serve weight refresh over the integer wire.

        A trainer pushes a parameter delta as codec transport words
        (``wf.pack(wf.encode(Δx, α))`` per leaf: bits/8 bytes a coordinate
        for the packed codec in place of 4-byte floats); the replica
        unpacks, decodes and applies them, ``(p.float() + Δ).to(p.dtype)``
        per leaf, without receiving a float tensor. ``words`` has a payload
        for every leaf; ``alphas`` is a dict of α by leaf or one α for all;
        ``n_summed`` is the number of summed payloads when the delta came
        off an all-reduce."""
        if words.keys() != self.params.keys():
            raise ValueError(f"wire delta for leaves {sorted(set(words) ^ set(self.params))} "
                             "does not match the params")
        for k, p in self.params.items():
            a = alphas[k] if isinstance(alphas, dict) else alphas
            ints = wf.unpack(words[k], p.shape, n_summed=n_summed)
            delta = wf.decode(ints, a, n_workers=n_summed)
            del ints
            # p widened exactly into the float32 sum: (p.float() + Δ) bit for bit
            self.params[k] = delta.add_(p).to(p.dtype)
            del delta

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt (prefill needs a token)")
        self.pending.append(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.pending:
                req = self.pending.pop(0)
                self.active[s] = req
                # prefill by stepping through the prompt (fills the cache)
                for i, tok in enumerate(req.prompt):
                    self.cur_tok[s] = tok
                    self.pos[s] = i
                    nxt = self.step()
                first = int(nxt[s])
                self.pos[s] = len(req.prompt)
                self.cur_tok[s] = first
                req.out.append(first)

    def run(self, max_iters: int = 1000) -> int:
        """Serve until every submitted request is done (or ``max_iters``
        engine iterations); a request stops at ``max_new`` tokens or when
        its position reaches ``max_seq - 1``. Returns the iterations."""
        it = 0
        while (self.pending or any(self.active)) and it < max_iters:
            it += 1
            self._admit()
            if not any(self.active):
                continue
            nxt = self.step().tolist()  # the iteration's one read to the host
            for s, req in enumerate(self.active):
                if req is None:
                    continue
                req.out.append(nxt[s])
                self.pos[s] += 1
                self.cur_tok[s] = nxt[s]
                if len(req.out) >= req.max_new or self.pos[s] >= self.max_seq - 1:
                    req.done = True
                    self.active[s] = None
        return it
