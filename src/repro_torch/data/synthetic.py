"""Deterministic synthetic token pipeline (port of
``repro/data/synthetic.py``, with the port's own numpy generator).

Each (step, worker) pulls its own slice from a seeded generator, so a
restart replays identical data without coordination. The token process is
the JAX package's: a Zipf-ish unigram mixture with a Markov flavour, so the
loss curve has learnable structure on top of irreducible entropy. The bits
differ from the JAX package's (another generator); tests that compare the
two packages hand both the same batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    batch_per_worker: int
    seed: int = 0

    def batch(self, step: int, worker: int, device="cpu"):
        """Deterministic {"tokens", "labels"} (int64, (B, T)) for
        (step, worker); the last label of each row is -1 (no target)."""
        rng = np.random.default_rng([self.seed, step, worker])
        b, t, v = self.batch_per_worker, self.seq_len, self.vocab
        base = rng.integers(0, v, (b, t))
        skew = np.square(rng.random((b, t), dtype=np.float32))
        toks = (base * skew).astype(np.int64) % v
        # markov structure: every other token correlates with its predecessor
        shifted = np.roll(toks, 1, axis=1)
        odd = (np.arange(t) % 2).astype(bool)
        toks = np.where(odd[None, :], (shifted * 31 + 7) % v, toks)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        return {
            "tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device),
        }
