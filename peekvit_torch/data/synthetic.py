"""Synthetic in-memory dataset (counterpart of
peekvit_tpu/data/synthetic.py; configs/dataset/synthetic.yaml):
class-conditional Gaussian blobs, so that a small model fits it. One seed
gives the JAX package's arrays, bit for bit."""

from __future__ import annotations

import numpy as np

from peekvit_torch.data.datasets import ArrayDataset
from peekvit_torch.data.transforms import Denormalize


def _make_split(rng, n, image_size, num_classes, base):
    labels = rng.integers(0, num_classes, size=n).astype(np.int64)
    imgs = base[labels] + 0.5 * rng.normal(
        size=(n, image_size, image_size, 3)).astype(np.float32)
    return imgs, labels


class Synthetic:
    def __init__(self, image_size: int = 160, num_classes: int = 10,
                 train_size: int = 512, val_size: int = 256, seed: int = 0, **kwargs):
        rng = np.random.default_rng(seed)
        self.image_size = image_size
        self.num_classes = num_classes
        self.denormalize_transform = Denormalize()
        # class prototypes shared by both splits, so val measures generalization
        base = rng.normal(size=(num_classes, image_size, image_size, 3)).astype(np.float32)
        xtr, ytr = _make_split(rng, train_size, image_size, num_classes, base)
        xva, yva = _make_split(rng, val_size, image_size, num_classes, base)
        self.train_dataset = ArrayDataset(xtr, ytr)
        self.val_dataset = ArrayDataset(xva, yva)
        self.classes = [f"class_{i}" for i in range(num_classes)]
