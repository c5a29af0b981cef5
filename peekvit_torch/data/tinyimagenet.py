"""Counterpart of peekvit_tpu/data/tinyimagenet.py. TinyImageNet-200 (reference data/tinyimagenet.py): download zip, re-layout
val/ annotations into ImageFolder form (reference :59-94)."""

from __future__ import annotations

import os
import pathlib
import shutil

from peekvit_torch.data import transforms as T
from peekvit_torch.data.datasets import ImageFolder, download_url, extract_archive


class TinyImageNetDataset:
    URL = "http://cs231n.stanford.edu/tiny-imagenet-200.zip"

    def __init__(self, root, train_transform=None, test_transform=None,
                 target_transform=None, image_size: int = 64,
                 augmentation_ops: int = 2, augmentation_magnitude: int = 9,
                 **kwargs):
        self.root = root
        self.image_size = image_size
        self.num_classes = 200
        self.denormalize_transform = T.Denormalize()
        self.train_transform = train_transform or T.train_transform(
            image_size, augmentation_ops, augmentation_magnitude
        )
        self.test_transform = test_transform or T.test_transform(image_size)

        os.makedirs(root, exist_ok=True)
        base = pathlib.Path(root) / "tiny-imagenet-200"
        if not base.exists():
            archive = download_url(self.URL, str(pathlib.Path(root) / "tiny.zip"))
            extract_archive(archive, root)
        self._normalize_val_layout(base / "val")

        self.train_dataset = ImageFolder(
            base / "train", self.train_transform, target_transform
        )
        self.val_dataset = ImageFolder(
            base / "val", self.test_transform, target_transform
        )

    @staticmethod
    def _normalize_val_layout(path, images_folder="images",
                              annotations_file="val_annotations.txt"):
        """Move ``val/images/*`` into per-class dirs per the annotations
        (reference tinyimagenet.py:59-94)."""
        images_dir = os.path.join(path, images_folder)
        ann = os.path.join(path, annotations_file)
        if not os.path.exists(images_dir) and not os.path.exists(ann):
            if not os.listdir(path):
                raise RuntimeError("Validation folder is empty.")
            return
        with open(ann) as f:
            for line in f:
                values = line.split()
                img, label = values[0], values[1]
                label_dir = os.path.join(path, label)
                os.makedirs(label_dir, exist_ok=True)
                try:
                    shutil.move(os.path.join(images_dir, img),
                                os.path.join(label_dir, img))
                except FileNotFoundError:
                    continue
        shutil.rmtree(images_dir, ignore_errors=True)
        os.remove(ann)
