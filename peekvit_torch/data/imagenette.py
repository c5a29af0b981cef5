"""Counterpart of peekvit_tpu/data/imagenette.py. Imagenette dataset (reference data/imagenette.py).

Contract preserved: download fast.ai tgz -> extract -> ImageFolder;
train = RandAugment->Resize->Normalize, test = Resize->CenterCrop->Normalize;
exposes .train_dataset/.val_dataset/.denormalize_transform/class names and
the ImagenetToImagenetteLabel mapping (reference :137-154)."""

from __future__ import annotations

import os
import pathlib

from peekvit_torch.data import transforms as T
from peekvit_torch.data.datasets import ImageFolder, download_url, extract_archive


class Imagenette:
    IMAGENETTE_URL = "https://s3.amazonaws.com/fast-ai-imageclas/imagenette2-160.tgz"
    IMAGENETTE_CLASSES = [
        "tench", "English springer", "cassette player", "chain saw", "church",
        "French horn", "garbage truck", "gas pump", "golf ball", "parachute",
    ]

    def __init__(self, root, train_transform=None, test_transform=None,
                 target_transform=None, image_size: int = 160,
                 augmentation_ops: int = 2, augmentation_magnitude: int = 9,
                 **kwargs):
        self.root = root
        self.image_size = image_size
        self.augmentation_ops = augmentation_ops
        self.augmentation_magnitude = augmentation_magnitude
        self.denormalize_transform = T.Denormalize()
        self.num_classes = 10

        self.train_transform = train_transform or T.train_transform(
            image_size, augmentation_ops, augmentation_magnitude
        )
        self.test_transform = test_transform or T.test_transform(image_size)

        os.makedirs(root, exist_ok=True)
        extracted = pathlib.Path(root) / "imagenette2-160"
        if not extracted.exists():
            archive = download_url(
                self.IMAGENETTE_URL, str(pathlib.Path(root) / "imagenette.tgz")
            )
            extract_archive(archive, root)

        self.train_dataset = ImageFolder(
            extracted / "train", self.train_transform, target_transform
        )
        self.val_dataset = ImageFolder(
            extracted / "val", self.test_transform, target_transform
        )
        self.classes = self.IMAGENETTE_CLASSES


class ImagenetToImagenetteLabel:
    """Imagenette label -> ImageNet-1k label (reference :137-154), for
    evaluating ImageNet-pretrained heads on Imagenette."""

    MAPPING = {0: 0, 1: 217, 2: 482, 3: 491, 4: 497,
               5: 566, 6: 569, 7: 571, 8: 574, 9: 701}

    def __call__(self, label: int) -> int:
        return self.MAPPING[label]
