"""Offline synthetic image datasets — a bit-for-bit numpy copy of
``repro.data.synthetic`` (class prototypes + smooth per-sample noise)."""
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


def train_test_split(ds: ImageDataset, test_frac: float, seed: int = 0
                     ) -> Tuple[ImageDataset, ImageDataset]:
    """Seeded random split into (train, test)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    cut = int(len(ds) * (1 - test_frac))
    return ds.subset(idx[:cut]), ds.subset(idx[cut:])
