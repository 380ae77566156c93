"""Deterministic synthetic token batches, in the port.

The port's copy of ``repro.data.pipeline.synthetic_batch``: the same shape
and the same order-1 Markov recurrence, token_{t+1} = (31·token_t + noise_t
+ 7) % vocab, with the first token and the noise drawn from a
``torch.Generator`` seeded by (seed, step).  The draws differ from the
reference's threefry numbers, so tests that compare the two packages feed
the reference's prompts in.
"""
from __future__ import annotations

import torch

__all__ = ["synthetic_batch"]


def synthetic_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                    device="cpu") -> torch.Tensor:
    """(batch, seq) int64 tokens, a pure function of (seed, step)."""
    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    first = torch.randint(0, vocab, (batch,), generator=gen)
    noise = torch.randint(0, max(2, vocab // 64), (batch, seq - 1), generator=gen)
    out = torch.empty((batch, seq), dtype=torch.int64)
    out[:, 0] = first
    tok = first
    for t in range(seq - 1):
        tok = (tok * 31 + noise[:, t] + 7) % vocab
        out[:, t + 1] = tok
    return out.to(device)
