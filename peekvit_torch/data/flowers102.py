"""Counterpart of peekvit_tpu/data/flowers102.py. Oxford Flowers-102 (reference data/flowers102.py, which wraps
torchvision.datasets.Flowers102). Native parser for the standard layout:
``{root}/flowers-102/jpg/image_XXXXX.jpg`` + ``imagelabels.mat`` +
``setid.mat`` (scipy reads the .mat files)."""

from __future__ import annotations

import os
import pathlib

import numpy as np

from peekvit_torch.data import transforms as T
from peekvit_torch.data.datasets import Dataset, download_url, extract_archive

_BASE = "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/"


class _FlowersSplit(Dataset):
    def __init__(self, jpg_dir, ids, labels, transform):
        self.jpg_dir = str(jpg_dir)
        self.ids = ids
        self.labels = labels
        self.transform = transform
        self._rng = np.random.default_rng(0)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        from PIL import Image

        i = int(self.ids[idx])
        path = os.path.join(self.jpg_dir, f"image_{i:05d}.jpg")
        with Image.open(path) as img:
            x = self.transform(img.convert("RGB"), self._rng)
        return x, int(self.labels[i - 1]) - 1  # .mat labels are 1-based


class Flowers102Dataset:
    def __init__(self, root, train_transform=None, test_transform=None,
                 target_transform=None, image_size: int = 224,
                 augmentation_ops: int = 2, augmentation_magnitude: int = 9,
                 **kwargs):
        from scipy.io import loadmat

        self.root = root
        self.image_size = image_size
        self.num_classes = 102
        self.denormalize_transform = T.Denormalize()
        self.train_transform = train_transform or T.train_transform(
            image_size, augmentation_ops, augmentation_magnitude
        )
        self.test_transform = test_transform or T.test_transform(image_size)

        base = pathlib.Path(root) / "flowers-102"
        jpg = base / "jpg"
        if not jpg.exists():
            os.makedirs(base, exist_ok=True)
            archive = download_url(_BASE + "102flowers.tgz", str(base / "102flowers.tgz"))
            extract_archive(archive, str(base))
            download_url(_BASE + "imagelabels.mat", str(base / "imagelabels.mat"))
            download_url(_BASE + "setid.mat", str(base / "setid.mat"))

        labels = loadmat(base / "imagelabels.mat")["labels"].ravel()
        setid = loadmat(base / "setid.mat")
        # torchvision maps train<-trnid, val<-valid, test<-tstid; the
        # reference uses (train, val) splits only.
        self.train_dataset = _FlowersSplit(
            jpg, setid["trnid"].ravel(), labels, self.train_transform
        )
        self.val_dataset = _FlowersSplit(
            jpg, setid["valid"].ravel(), labels, self.test_transform
        )
