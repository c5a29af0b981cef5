"""Counterpart of peekvit_tpu/data/food101.py. Food-101 (reference data/food101.py, wrapping torchvision Food101).
Native parser for the standard layout: ``{root}/food-101/images/<cls>/*.jpg``
+ ``meta/train.txt`` / ``meta/test.txt``."""

from __future__ import annotations

import os
import pathlib

import numpy as np

from peekvit_torch.data import transforms as T
from peekvit_torch.data.datasets import Dataset, download_url, extract_archive

_URL = "http://data.vision.ee.ethz.ch/cvl/food-101.tar.gz"


class _FoodSplit(Dataset):
    def __init__(self, images_dir, entries, class_to_idx, transform):
        self.images_dir = str(images_dir)
        self.entries = entries  # e.g. 'apple_pie/1005649'
        self.class_to_idx = class_to_idx
        self.transform = transform
        self._rng = np.random.default_rng(0)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx):
        from PIL import Image

        entry = self.entries[idx]
        cls = entry.split("/")[0]
        path = os.path.join(self.images_dir, entry + ".jpg")
        with Image.open(path) as img:
            x = self.transform(img.convert("RGB"), self._rng)
        return x, self.class_to_idx[cls]


class Food101Dataset:
    def __init__(self, root, train_transform=None, test_transform=None,
                 target_transform=None, image_size: int = 224,
                 augmentation_ops: int = 2, augmentation_magnitude: int = 9,
                 **kwargs):
        self.root = root
        self.image_size = image_size
        self.num_classes = 101
        self.denormalize_transform = T.Denormalize()
        self.train_transform = train_transform or T.train_transform(
            image_size, augmentation_ops, augmentation_magnitude
        )
        self.test_transform = test_transform or T.test_transform(image_size)

        base = pathlib.Path(root) / "food-101"
        if not base.exists():
            os.makedirs(root, exist_ok=True)
            archive = download_url(_URL, str(pathlib.Path(root) / "food-101.tar.gz"))
            extract_archive(archive, root)

        def read_split(name):
            with open(base / "meta" / f"{name}.txt") as f:
                return [line.strip() for line in f if line.strip()]

        classes = sorted(
            d.name for d in os.scandir(base / "images") if d.is_dir()
        )
        class_to_idx = {c: i for i, c in enumerate(classes)}
        self.classes = classes
        self.train_dataset = _FoodSplit(
            base / "images", read_split("train"), class_to_idx, self.train_transform
        )
        self.val_dataset = _FoodSplit(
            base / "images", read_split("test"), class_to_idx, self.test_transform
        )
