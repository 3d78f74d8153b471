"""Data pipelines (the port's own copy of ``kubedl_tpu/training/data.py``).

- :class:`SyntheticTokens` — host-side PRNG token batches (numpy), the
  same stream as the reference's for the same seed.
- :class:`ByteCorpus` — byte-level tokenization of a local text file with
  random crops.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticTokens:
    """Deterministic synthetic next-token data, generated host-side."""

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0) -> None:
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        return self.rng.integers(
            0, self.vocab, (self.batch, self.seq), dtype=np.int32
        )


class ByteCorpus:
    """Byte-level LM dataset over a text file (vocab 256)."""

    VOCAB = 256

    def __init__(self, path: str, batch: int, seq: int, seed: int = 0) -> None:
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        if len(self.data) < seq + 1:
            raise ValueError(f"corpus {path} shorter than seq+1={seq + 1}")
        self.batch, self.seq = batch, seq
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        starts = self.rng.integers(0, len(self.data) - self.seq - 1, self.batch)
        out = np.stack([self.data[s : s + self.seq] for s in starts])
        return out.astype(np.int32)


__all__ = ["SyntheticTokens", "ByteCorpus"]
