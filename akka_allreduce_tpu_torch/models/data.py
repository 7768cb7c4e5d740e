"""Training data: the classification stream, the LM copy task and ``.npz``
files.

The port's copy of ``SyntheticClassification``, ``mnist_like``,
``imagenet_like``, ``SyntheticCopyLM``, ``lm_copy_task`` and ``FileDataset``
from ``akka_allreduce_tpu/models/data.py``. ``batches`` is numpy only and
gives the same batches as the JAX package's for the same seed (held bit for
bit in the tests). ``device_sampler`` draws batches on the device with a
``torch.Generator``: the same task, but not ``jax.random``'s numbers.
"""

from __future__ import annotations

from pathlib import Path

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


def imagenet_like(size: int = 64, classes: int = 1000, seed: int = 0) -> SyntheticClassification:
    """NHWC images for the ResNet-50 workload (64 px by default; 224 for
    full-size runs)."""
    return SyntheticClassification((size, size, 3), classes, seed=seed)


class FileDataset:
    """A ``.npz`` file, or a directory of ``.npz`` shards, each holding
    arrays ``x`` and ``y``: real data in place of a synthetic stream.

    ``batches`` yields shuffled minibatches (reshuffled on every pass through
    the data), the JAX package's for the same seed; ``device_sampler`` keeps
    the arrays on the device and draws rows (with replacement) there. Labels
    become int32; inputs keep their stored dtype. A missing shard, a missing
    array or mismatched row counts raise here, and a batch larger than the
    data raises when ``batches`` is called, not at the first ``next()``.
    """

    def __init__(self, path, *, x_key: str = "x", y_key: str = "y", seed: int = 0) -> None:
        p = Path(path)
        files = sorted(p.glob("*.npz")) if p.is_dir() else [p]
        if not files:
            raise FileNotFoundError(f"no .npz shards under {p}")
        xs, ys = [], []
        for f in files:
            with np.load(f, allow_pickle=False) as z:
                if x_key not in z or y_key not in z:
                    raise KeyError(f"{f} lacks arrays {x_key!r}/{y_key!r} (has {sorted(z.files)})")
                xs.append(np.asarray(z[x_key]))
                ys.append(np.asarray(z[y_key]))
        self.x = np.concatenate(xs, axis=0)
        self.y = np.concatenate(ys, axis=0).astype(np.int32)
        if self.x.shape[0] != self.y.shape[0]:
            raise ValueError(f"x rows {self.x.shape[0]} != y rows {self.y.shape[0]}")
        self.n = self.x.shape[0]
        self._seed = seed

    def batches(self, batch_size: int, steps: int, *, seed_offset: int = 1):
        """Yield ``steps`` minibatches, without replacement within a pass."""
        if batch_size > self.n:
            raise ValueError(f"batch {batch_size} exceeds dataset rows {self.n}")

        def gen():
            rng = np.random.default_rng(self._seed + seed_offset)
            order = rng.permutation(self.n)
            at = 0
            for _ in range(steps):
                if at + batch_size > self.n:
                    order = rng.permutation(self.n)
                    at = 0
                idx = order[at:at + batch_size]
                at += batch_size
                yield self.x[idx], self.y[idx]

        return gen()

    def device_sampler(self):
        """``(generator, rows) -> (x, y int64)``: rows drawn with
        ``generator`` on its device from a copy of the arrays uploaded once a
        device."""
        host = (torch.from_numpy(self.x), torch.from_numpy(self.y).long())
        uploaded: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
        n = self.n

        def sample(generator: torch.Generator, rows: int):
            dev = generator.device
            if dev not in uploaded:
                uploaded[dev] = (host[0].to(dev), host[1].to(dev))
            x, y = uploaded[dev]
            idx = torch.randint(0, n, (rows,), generator=generator, device=dev)
            return x[idx], y[idx]

        return sample


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
