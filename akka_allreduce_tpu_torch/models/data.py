"""Synthetic LM data: the copy task.

The port's copy of ``SyntheticCopyLM`` and ``lm_copy_task`` from
``akka_allreduce_tpu/models/data.py``. ``batches`` is numpy only and gives
the same batches as the JAX package's for the same seed (held bit for bit in
the tests). ``device_sampler`` waits for the training slice.
"""

from __future__ import annotations

import numpy as np


class SyntheticCopyLM:
    """Long-range-dependency LM stream: the second half of every sequence
    repeats the first half, so next-token loss on the back half is only
    learnable by attending ``seq_len/2`` tokens back."""

    def __init__(self, seq_len: int, vocab: int = 64, *, seed: int = 0) -> None:
        if seq_len % 2:
            raise ValueError(f"seq_len must be even, got {seq_len}")
        self.seq_len = seq_len
        self.vocab = vocab
        self._seed = seed

    def batches(self, batch_size: int, steps: int, *, seed_offset: int = 1):
        """Yield ``steps`` batches of (inputs, labels), each (B, seq_len) int32."""
        rng = np.random.default_rng(self._seed + seed_offset)
        half = self.seq_len // 2
        for _ in range(steps):
            first = rng.integers(
                0, self.vocab, size=(batch_size, half + 1), dtype=np.int64
            )
            seq = np.concatenate([first, first[:, 1:]], axis=1)  # len + 1
            yield seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def lm_copy_task(seq_len: int = 128, vocab: int = 64, seed: int = 0) -> SyntheticCopyLM:
    """The long-context LM workload."""
    return SyntheticCopyLM(seq_len, vocab, seed=seed)
