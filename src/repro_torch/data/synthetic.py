"""Offline synthetic datasets — a bit-for-bit numpy copy of
``repro.data.synthetic``: class-conditional images (class prototypes +
smooth per-sample noise) and an order-1 Markov token stream for the model
zoo's LM training."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ImageDataset:
    images: np.ndarray        # [N, H, W, C] float32 in [-2, 2]
    labels: np.ndarray        # [N] int32
    writer_ids: np.ndarray    # [N] int32 (all zeros unless writers > 1)
    num_classes: int

    def subset(self, idx: np.ndarray) -> "ImageDataset":
        return ImageDataset(self.images[idx], self.labels[idx],
                            self.writer_ids[idx], self.num_classes)

    def __len__(self):
        return len(self.labels)


def _smooth(rng: np.random.Generator, shape, passes: int = 2) -> np.ndarray:
    """Spatially smooth noise: average shifted copies (cheap blur)."""
    x = rng.normal(size=shape).astype(np.float32)
    for _ in range(passes):
        x = (x + np.roll(x, 1, axis=-3) + np.roll(x, 1, axis=-2)
             + np.roll(x, -1, axis=-3) + np.roll(x, -1, axis=-2)) / 5.0
    return x


def make_image_classification(n_samples: int, *, num_classes: int = 10,
                              image_size: int = 32, channels: int = 3,
                              writers: int = 1, noise: float = 0.9,
                              seed: int = 0) -> ImageDataset:
    """Class-conditional synthetic images (CIFAR-like at the defaults)."""
    rng = np.random.default_rng(seed)
    protos = _smooth(rng, (num_classes, image_size, image_size, channels))
    protos /= np.abs(protos).max(axis=(1, 2, 3), keepdims=True)
    styles = (_smooth(rng, (writers, image_size, image_size, channels))
              * 0.4 if writers > 1 else None)
    labels = rng.integers(0, num_classes, n_samples).astype(np.int32)
    writer_ids = rng.integers(0, writers, n_samples).astype(np.int32)
    imgs = protos[labels] + noise * _smooth(
        rng, (n_samples, image_size, image_size, channels), passes=1)
    if styles is not None:
        imgs += styles[writer_ids]
    imgs = np.clip(imgs, -2.0, 2.0).astype(np.float32)
    return ImageDataset(imgs, labels, writer_ids, num_classes)


def make_token_stream(n_tokens: int, vocab: int, *, seed: int = 0,
                      concentration: float = 0.2) -> np.ndarray:
    """Order-1 Markov chain with Dirichlet-sparse rows (a learnable LM
    stream: its transitions give a loss well below ``ln(vocab)``).

    As in the reference, the transition matrix is ``[vocab, vocab]`` f64,
    which is 131 GB at a full vocabulary of 128,256: the stream is for
    reduced vocabularies (ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(vocab, concentration), size=vocab)
    cum = np.cumsum(trans, axis=1)
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.integers(vocab)
    u = rng.random(n_tokens)
    for t in range(1, n_tokens):
        toks[t] = np.searchsorted(cum[toks[t - 1]], u[t])
    return np.clip(toks, 0, vocab - 1)


def train_test_split(ds: ImageDataset, test_frac: float, seed: int = 0
                     ) -> Tuple[ImageDataset, ImageDataset]:
    """Seeded random split into (train, test)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    cut = int(len(ds) * (1 - test_frac))
    return ds.subset(idx[:cut]), ds.subset(idx[cut:])
