"""Deterministic, shard-aware, resumable synthetic data pipeline (a copy of
the JAX package's ``data/pipeline.py``, in numpy).

Batches are a pure function of (seed, step, shard): a Philox counter-based
generator keyed on those values, so the only pipeline state is the step
counter the train state already holds, and every data-parallel rank makes
its own shard without coordination.  The same (seed, step, shard) gives the
JAX package's batch bit for bit.

The token stream is not uniform noise: a hash-chain Markov structure
(``tok_{t+1} = (7 tok_t + a) mod V`` with 10 % noise) makes next-token
prediction learnable, so a few training steps show the loss falling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    shape: ShapeSpec
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1
    text_len: Optional[int] = None   # vlm: tokens after the vision prefix

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=[np.uint64(self.seed), np.uint64((step << 20) + self.shard_index)]))

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: int32 [B / shard_count, S], labels the
        tokens shifted by one (plus "frames"/"patches" for encdec/vlm)."""
        b = self.shape.global_batch // self.shard_count
        s = self.text_len if self.text_len is not None else self.shape.seq_len
        rng = self._rng(step)
        vocab = self.cfg.vocab
        a = 31337 % vocab
        start = rng.integers(0, vocab, size=(b, 1), dtype=np.int64)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = start[:, 0]
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, vocab, size=(b, s), dtype=np.int64)
        for t in range(s):
            nxt = (toks[:, t] * 7 + a) % vocab
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        d = self.cfg.d_model
        if self.cfg.family == "encdec":
            enc = self.shape.seq_len // self.cfg.audio_downsample
            batch["frames"] = rng.standard_normal((b, enc, d)).astype(np.float32)
        if self.cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (b, self.cfg.vision_tokens, d)).astype(np.float32)
        return batch
