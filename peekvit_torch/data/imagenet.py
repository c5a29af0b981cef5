"""Counterpart of peekvit_tpu/data/imagenet.py. ImageNet-1k eval/train wrapper (reference data/imagenet.py).

Expects the standard layout ``{root}/train/{wnid}/*.JPEG`` and
``{root}/val/{wnid}/*.JPEG`` (no download — ImageNet is user-staged in the
reference too, via torchvision.datasets.ImageNet)."""

from __future__ import annotations

import os

from peekvit_torch.data import transforms as T
from peekvit_torch.data.datasets import ImageFolder


class ImageNetDataset:
    def __init__(self, root, train_transform=None, test_transform=None,
                 target_transform=None, image_size: int = 224, **kwargs):
        self.root = root
        self.image_size = image_size
        self.num_classes = 1000
        # reference ImageNet wrapper has no denormalize_transform attr
        # (SURVEY.md §2 L1) — we add one anyway; nothing depends on absence.
        self.denormalize_transform = T.Denormalize()
        self.train_transform = train_transform or T.train_transform(image_size)
        self.test_transform = test_transform or T.test_transform(image_size)

        train_dir = os.path.join(root, "train")
        val_dir = os.path.join(root, "val")
        self.train_dataset = (
            ImageFolder(train_dir, self.train_transform, target_transform)
            if os.path.isdir(train_dir) else None
        )
        self.val_dataset = ImageFolder(val_dir, self.test_transform, target_transform)
