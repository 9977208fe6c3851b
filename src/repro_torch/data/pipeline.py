"""Deterministic synthetic corpus and its batch iterator (the port's own
copy of ``repro/data/pipeline.py``, which is pure numpy).

No corpora ship offline, so the pipeline synthesizes a byte-level corpus
with real sequential structure (templated English-like sentences and
arithmetic spans): enough signal for the small stand-ins to learn
next-token statistics, which the paper's ΔPPL orderings need.  Content is
a pure function of (seed, shard, step) and equals the reference's byte
for byte; batches are ``torch.long`` on the iterator's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["SyntheticCorpus", "DataIterator"]

_WORDS = (
    "the quick brown fox jumps over lazy dog a and of to in is was for on "
    "with that model cache memory kernel rotation quantize fourier sign "
    "random transform bandwidth decode token attention head layer scale "
    "group channel int4 fp16 apple silicon unified metal tensor"
).split()


class SyntheticCorpus:
    """Byte-level corpus: a pure function of the seed; vocab = 256."""

    vocab_size = 256

    def __init__(self, seed: int = 0):
        self.seed = seed

    def _sentence(self, rng: np.random.Generator) -> str:
        n = int(rng.integers(4, 12))
        words = [str(_WORDS[int(rng.integers(len(_WORDS)))]) for _ in range(n)]
        if rng.random() < 0.3:  # structured arithmetic span
            a, b = int(rng.integers(0, 99)), int(rng.integers(0, 99))
            words.append(f"{a}+{b}={a + b}")
        return " ".join(words) + ". "

    def tokens(self, shard: int, step: int, n: int) -> np.ndarray:
        """Deterministic (n,) int32 token chunk for (shard, step)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, shard, step]))
        buf = ""
        while len(buf) < n:
            buf += self._sentence(rng)
        return np.frombuffer(buf[:n].encode("latin-1"),
                             dtype=np.uint8).astype(np.int32)


@dataclasses.dataclass
class DataIterator:
    """Stateful iterator over the corpus; ``step`` is its whole state.
    ``device`` defaults to ``cuda`` (``repro_torch.resolve_device``)."""

    corpus: SyntheticCorpus
    batch_per_shard: int
    seq_len: int
    shard_id: int = 0
    num_shards: int = 1
    step: int = 0
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def next(self) -> dict:
        """{"tokens": (batch_per_shard, seq_len) torch.long}."""
        b = np.stack([
            self.corpus.tokens(self.shard_id * 1_000_003 + i, self.step,
                               self.seq_len)
            for i in range(self.batch_per_shard)])
        self.step += 1
        return {"tokens": torch.from_numpy(b).long().to(self.device)}

    # -- checkpoint integration (reference ``pipeline.py:88-98``) --
    def state_dict(self) -> dict:
        return {"step": self.step, "shard_id": self.shard_id,
                "num_shards": self.num_shards}

    def restore(self, state: dict) -> None:
        """Resume at the saved step; the shard stays the iterator's own."""
        self.step = int(state["step"])

    def reshard(self, shard_id: int, num_shards: int) -> None:
        """Elastic re-scale: repartition shards, keep the step counter."""
        self.shard_id = shard_id
        self.num_shards = num_shards
