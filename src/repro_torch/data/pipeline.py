"""Data pipeline: synthetic MNIST-class data + per-learner partitioning.

A NumPy copy of ``repro/data/pipeline.py`` (``Dataset``,
``synthetic_mnist``, ``token_batches``, ``FederatedPartitioner``): the same
seed gives the same samples, token batches and shard indices, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Dataset", "synthetic_mnist", "token_batches", "FederatedPartitioner"]


@dataclasses.dataclass(frozen=True)
class Dataset:
    x: np.ndarray          # (N, F) float32
    y: np.ndarray          # (N,)   int32

    @property
    def size(self) -> int:
        return int(self.x.shape[0])

    def subset(self, idx: np.ndarray) -> "Dataset":
        return Dataset(self.x[idx], self.y[idx])


def synthetic_mnist(
    n: int = 60_000,
    *,
    n_test: int = 10_000,
    features: int = 784,
    classes: int = 10,
    seed: int = 0,
    noise: float = 2.5,
) -> tuple[Dataset, Dataset]:
    """Class-structured Gaussian mixture that mimics MNIST's shape/scale."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(features))
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    means = []
    for c in range(classes):
        fx, fy = 1 + c % 3, 1 + (c // 3) % 3
        phase = c * 0.7
        img = np.sin(2 * np.pi * fx * xx + phase) * np.cos(2 * np.pi * fy * yy + 0.3 * c)
        img += 0.5 * np.sin(2 * np.pi * (xx + yy) * (1 + 0.5 * c))
        means.append(img.reshape(-1))
    means = np.stack(means)                         # (C, F)

    def make(count, seed_off):
        r = np.random.default_rng(seed + seed_off)
        y = r.integers(0, classes, size=count).astype(np.int32)
        x = means[y] + noise * r.standard_normal((count, features)).astype(np.float32)
        return Dataset(x.astype(np.float32), y)

    return make(n, 1), make(n_test, 2)


def token_batches(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    """Endless synthetic LM batches with a learnable bigram structure:
    ``{"tokens", "labels"}`` int32 (batch, seq - 1), the labels the tokens
    shifted by one. Each token follows its predecessor's fixed successor
    with probability 0.7, else is uniform."""
    perm = rng.permutation(vocab)
    while True:
        first = rng.integers(0, vocab, size=(batch, 1))
        toks = [first]
        for _ in range(seq - 1):
            prev = toks[-1]
            nxt = np.where(
                rng.random((batch, 1)) < 0.7, perm[prev] % vocab,
                rng.integers(0, vocab, size=(batch, 1)),
            )
            toks.append(nxt)
        tokens = np.concatenate(toks, axis=1).astype(np.int32)
        yield {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class FederatedPartitioner:
    """Re-samples per-learner batches of the allocated sizes each cycle."""

    def __init__(self, dataset: Dataset, seed: int = 0):
        self.dataset = dataset
        self.seed = int(seed)
        self.draws = 0   # index of the next draw (the fold-in key)

    def draw_indices(self, total: int) -> np.ndarray:
        """One cycle's sample indices (total,), keyed only by
        ``(seed, draw index)`` through ``SeedSequence``, so the sequence
        is the same in every process and for any split of the total."""
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, self.draws))
        )
        self.draws += 1
        return rng.choice(self.dataset.size, size=int(total), replace=False)

    def draw(self, d: np.ndarray) -> list[Dataset]:
        """d: (K,) integer batch sizes, sum <= dataset size. Disjoint shards."""
        idx = self.draw_indices(int(np.sum(d)))
        out, off = [], 0
        for dk in d:
            out.append(self.dataset.subset(idx[off : off + int(dk)]))
            off += int(dk)
        return out
