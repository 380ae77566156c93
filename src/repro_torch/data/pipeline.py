"""Deterministic synthetic data, in the port.

The port's copy of ``repro.data.pipeline``.  What training needs from it:
every batch is a pure function of (seed, step), so a resume from a
checkpoint replays the same data with no loader state to save, and the data
carries a learnable signal, so the loss visibly falls.

* :func:`synthetic_batch` — the reference's shape and its order-1 Markov
  recurrence, token_{t+1} = (31·token_t + noise_t + 7) % vocab;
* :func:`synthetic_images` — class-conditional Gaussian blobs (the CNN
  examples' images), the reference's geometry and noise scale;
* :class:`DataPipeline` / :func:`make_pipeline` — one workload's batches,
  with the encoder-decoder / VLM context stub (N(0, 0.1²) frames or image
  embeddings, seeded ``seed ^ 0x5EED``).

The draws come from a ``torch.Generator`` seeded by (seed, step), not the
reference's threefry numbers, so tests that compare the two packages feed
the reference's batches in.  Batches are made on the host and moved to
``device`` (the card by default in the pipeline, as in the drivers).

With a mesh (a rank of a data-parallel / FSDP / tensor-parallel run)
every rank draws the whole global batch from (seed, step) and keeps its
rows of it, over the rules' "batch" axes (``sharding.microbatch_rows``:
with ``accum`` microbatches, its rows of each in turn), the context's rows
too; ranks that share a data coordinate (a "model" line) keep the same
rows, whole sequences, which the model cuts to their sequence shards.  The
data does not depend on the mesh, so a run restarts on another mesh with
the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.parallel import sharding as sh

__all__ = ["DataPipeline", "make_pipeline", "synthetic_batch", "synthetic_images"]


def _gen(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def synthetic_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                    device="cpu") -> torch.Tensor:
    """(batch, seq) int64 tokens, a pure function of (seed, step)."""
    gen = _gen(seed, step)
    first = torch.randint(0, vocab, (batch,), generator=gen)
    noise = torch.randint(0, max(2, vocab // 64), (batch, seq - 1), generator=gen)
    out = torch.empty((batch, seq), dtype=torch.int64)
    out[:, 0] = first
    tok = first
    for t in range(seq - 1):
        tok = (tok * 31 + noise[:, t] + 7) % vocab
        out[:, t + 1] = tok
    return out.to(device)


def synthetic_images(seed: int, step: int, batch: int, hw: int, ch: int, n_classes: int,
                     device="cpu"):
    """Class-conditional blobs: (images (B, H, W, C) f32 in about [-1, 1],
    labels (B,) int64), a pure function of (seed, step)."""
    gen = _gen(seed, step)
    labels = torch.randint(0, n_classes, (batch,), generator=gen)
    grid = torch.arange(hw, dtype=torch.float32) / hw
    yy, xx = grid[:, None].expand(hw, hw), grid[None, :].expand(hw, hw)
    cy = (labels % 4).to(torch.float32) / 4.0 + 0.125
    cx = ((labels // 4) % 4).to(torch.float32) / 4.0 + 0.125
    d2 = (yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2
    blob = torch.exp(-d2 * (8.0 + (labels % 3))[:, None, None].to(torch.float32))
    noise = 0.1 * torch.randn((batch, hw, hw, ch), generator=gen)
    img = blob[..., None] * torch.ones((ch,)) + noise
    return (img * 2.0 - 1.0).to(device), labels.to(device)


@dataclasses.dataclass
class DataPipeline:
    """Token batches of one (arch, shape) workload on ``device``."""

    seed: int
    global_batch: int
    seq_len: int
    vocab: int
    ctx_len: int = 0  # encdec / vlm context stub length (0 = none)
    d_model: int = 0
    device: str = "cuda"
    mesh: Optional[object] = None
    rules: Optional[sh.ShardingRules] = None
    accum: int = 1

    def rows(self) -> Optional[list]:
        """This rank's rows of the global batch (None: every row)."""
        if self.mesh is None or self.rules is None:
            return None
        return sh.microbatch_rows(self.global_batch, self.accum, self.mesh,
                                  self.rules.get("batch"))

    def batch(self, step: int) -> dict:
        rows = self.rows()
        keep = (lambda t: t) if rows is None else (lambda t: t[rows])
        out = {"tokens": keep(synthetic_batch(self.seed, step, self.global_batch,
                                              self.seq_len, self.vocab)).to(self.device)}
        if self.ctx_len:
            gen = _gen(self.seed ^ 0x5EED, step)
            ctx = torch.randn((self.global_batch, self.ctx_len, self.d_model),
                              generator=gen) * 0.1
            out["ctx"] = keep(ctx).to(self.device)
        return out


def make_pipeline(cfg, shape, *, seed: int = 0, mesh=None, rules=None,
                  global_batch: Optional[int] = None, seq_len: Optional[int] = None,
                  device="cuda", accum: int = 1) -> DataPipeline:
    ctx_len = 0
    if cfg.family == "encdec":
        ctx_len = cfg.n_frames
    elif cfg.family == "vlm":
        ctx_len = cfg.n_image_tokens
    return DataPipeline(
        seed=seed,
        global_batch=global_batch or shape.global_batch,
        seq_len=seq_len or shape.seq_len,
        vocab=cfg.vocab,
        ctx_len=ctx_len,
        d_model=cfg.d_model,
        device=str(device),
        mesh=mesh,
        rules=rules if mesh is not None else None,
        accum=accum,
    )
