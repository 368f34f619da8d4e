"""Deterministic synthetic token pipeline.

The counterpart of ``repro.data.pipeline``: the same Philox streams, the
same zipf draws and the same ``embeddings`` kind, so a batch is JAX's bit
for bit. Every (step, host) pair maps to an independent Philox stream, so:
  * restarts resume mid-epoch exactly (the step index is the only state),
  * elastic re-sharding keeps per-example streams stable (examples are keyed
    by global example id, not by host),
  * no host reads another host's shard (scales to any host count).

Optionally applies the paper's self-join near-duplicate filter per batch
(``data/dedup.py``, on ``device``: CUDA by default, where the join launches
the fused-join kernel): duplicates are *replaced* by fresh samples drawn
from a reserve stream so the global batch size stays static.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int            # global batch (examples per step)
    seq: int
    seed: int = 0
    dedup: bool = False
    dedup_eps: float = 0.05
    input_kind: str = "tokens"
    d_model: int = 0      # for embeddings input_kind
    device: Any = None    # where the dedup's self-join runs (CUDA if None)

    def _rng(self, step: int, salt: int = 0):
        key = (self.seed << 32) ^ (salt << 16) ^ 0xD5
        return np.random.Generator(np.random.Philox(key=key, counter=step))

    def batch_at(self, step: int) -> dict:
        """Global batch for ``step`` (host-sliced by the caller if needed)."""
        rng = self._rng(step)
        if self.input_kind == "embeddings":
            emb = rng.normal(size=(self.batch, self.seq, self.d_model))
            labels = rng.integers(0, self.vocab, (self.batch, self.seq))
            return {"embeds": emb.astype(np.float32),
                    "labels": labels.astype(np.int32)}
        # zipfian-ish marginals make the loss non-degenerate
        z = rng.zipf(1.3, size=(self.batch, self.seq))
        tokens = (z % self.vocab).astype(np.int32)
        if self.dedup:
            tokens = self._dedup(tokens, step)
        labels = np.roll(tokens, -1, axis=1).astype(np.int32)
        labels[:, -1] = -1  # masked
        return {"tokens": tokens, "labels": labels}

    def _dedup(self, tokens: np.ndarray, step: int) -> np.ndarray:
        from repro_torch.data.dedup import dedup_batch

        keep = dedup_batch(tokens, eps=self.dedup_eps, device=self.device)
        n_dup = int((~keep).sum())
        if n_dup:
            reserve = self._rng(step, salt=1)
            z = reserve.zipf(1.3, size=(n_dup, self.seq))
            tokens = tokens.copy()
            tokens[~keep] = (z % self.vocab).astype(np.int32)
        return tokens

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
