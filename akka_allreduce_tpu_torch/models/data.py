"""Synthetic data: the classification stream and the LM copy task.

The port's copy of ``SyntheticClassification``, ``mnist_like``,
``SyntheticCopyLM`` and ``lm_copy_task`` from
``akka_allreduce_tpu/models/data.py``. ``batches`` is numpy only and gives
the same batches as the JAX package's for the same seed (held bit for bit in
the tests). ``device_sampler`` draws batches on the device with a
``torch.Generator``: the same task, but not ``jax.random``'s numbers.
``imagenet_like`` and ``FileDataset`` arrive with ResNet-50.
"""

from __future__ import annotations

import numpy as np
import torch


class SyntheticClassification:
    """Class-template + Gaussian-noise stream with a fixed seed: each class
    has a fixed random template and a sample is its template plus noise, so
    a correct trainer reduces the loss."""

    def __init__(
        self,
        input_shape: tuple[int, ...],
        classes: int,
        *,
        noise: float = 0.5,
        seed: int = 0,
    ) -> None:
        self.input_shape = input_shape
        self.classes = classes
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.templates = rng.standard_normal((classes, *input_shape), dtype=np.float32)
        self._seed = seed

    def batches(self, batch_size: int, steps: int, *, seed_offset: int = 1):
        """Yield ``steps`` batches of (images f32, labels int32)."""
        rng = np.random.default_rng(self._seed + seed_offset)
        for _ in range(steps):
            labels = rng.integers(0, self.classes, size=batch_size)
            noise = rng.standard_normal((batch_size, *self.input_shape), dtype=np.float32)
            images = self.templates[labels] + self.noise * noise
            yield images, labels.astype(np.int32)

    def device_sampler(self):
        """``(generator, rows) -> (images f32, labels int64)`` drawn with
        ``generator`` on its device: the data-loader path that keeps a
        training chain free of host-to-device copies
        (``DPTrainer.train_chain``). The templates are uploaded once a
        device, so the device stream and ``batches`` present the same task."""
        noise_scale, classes, shape = self.noise, self.classes, self.input_shape
        host = torch.from_numpy(self.templates)
        uploaded: dict[torch.device, torch.Tensor] = {}

        def sample(generator: torch.Generator, rows: int):
            dev = generator.device
            if dev not in uploaded:
                uploaded[dev] = host.to(dev)
            labels = torch.randint(0, classes, (rows,), generator=generator, device=dev)
            noise = torch.randn((rows, *shape), generator=generator, device=dev)
            return uploaded[dev][labels] + noise_scale * noise, labels

        return sample


def mnist_like(seed: int = 0) -> SyntheticClassification:
    """28x28x1, 10 classes: the MLP/MNIST workload's shape."""
    return SyntheticClassification((28, 28, 1), 10, seed=seed)


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

    def device_sampler(self):
        """``(generator, rows) -> (tokens, labels)``, each (rows, seq_len)
        int64, drawn with ``generator`` on its device: the data-loader path
        that keeps a training chain free of host-to-device copies
        (``LongContextTrainer.train_chain``). Deterministic per generator
        seed; the copy structure is ``batches``'s."""
        half = self.seq_len // 2
        vocab = self.vocab

        def sample(generator: torch.Generator, rows: int):
            first = torch.randint(0, vocab, (rows, half + 1), generator=generator,
                                  device=generator.device)
            seq = torch.cat([first, first[:, 1:]], dim=1)
            return seq[:, :-1], seq[:, 1:]

        return sample


def lm_copy_task(seq_len: int = 128, vocab: int = 64, seed: int = 0) -> SyntheticCopyLM:
    """The long-context LM workload."""
    return SyntheticCopyLM(seq_len, vocab, seed=seed)
