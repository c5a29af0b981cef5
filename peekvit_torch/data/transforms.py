"""Image transforms on PIL and numpy (counterpart of
peekvit_tpu/data/transforms.py), NHWC float32 out.

The recipe of every image dataset:
  train: RandAugment(num_ops, magnitude) -> Resize -> ToArray -> Normalize
  test:  Resize -> CenterCrop -> ToArray -> Normalize
with the ImageNet mean and std. RandAugment has torchvision's 14-op space
with the standard magnitude binning (31 bins, magnitude 0-30), and takes
its random numbers from an explicit numpy Generator.

PIL is imported where an image is touched, never at import: the
synthetic path (``Synthetic``, ``Denormalize``) runs without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _pil():
    from PIL import Image, ImageEnhance, ImageOps

    return Image, ImageEnhance, ImageOps


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x, rng: Optional[np.random.Generator] = None):
        for t in self.transforms:
            x = t(x, rng) if getattr(t, "random", False) else t(x)
        return x


class Resize:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        Image = _pil()[0]
        return img.resize((self.size[1], self.size[0]), Image.BILINEAR)


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img):
        w, h = img.size
        s = self.size
        left, top = (w - s) // 2, (h - s) // 2
        return img.crop((left, top, left + s, top + s))


class ToArray:
    """PIL -> float32 HWC in [0, 1] (torchvision ToTensor without the
    CHW transpose); an array passes through as float32."""

    def __call__(self, img) -> np.ndarray:
        if hasattr(img, "convert"):  # a PIL image
            return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
        return np.asarray(img, dtype=np.float32)


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (arr - self.mean) / self.std


class Denormalize:
    """The inverse of Normalize, on HWC or NHWC arrays or tensors (the
    datasets' ``denormalize_transform``)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr) -> np.ndarray:
        if hasattr(arr, "detach"):
            arr = arr.detach().cpu().numpy()
        return np.asarray(arr) * self.std + self.mean


# --------------------------------------------------------------- RandAugment

_FILL = (128, 128, 128)
_NUM_BINS = 31


def _affine(img, matrix):
    Image = _pil()[0]
    return img.transform(img.size, Image.AFFINE, matrix, Image.BILINEAR, fillcolor=_FILL)


def _shear_x(img, v):
    return _affine(img, (1, v, 0, 0, 1, 0))


def _shear_y(img, v):
    return _affine(img, (1, 0, 0, v, 1, 0))


def _translate_x(img, v):
    return _affine(img, (1, 0, v * img.size[0], 0, 1, 0))


def _translate_y(img, v):
    return _affine(img, (1, 0, 0, 0, 1, v * img.size[1]))


def _rotate(img, v):
    return img.rotate(v, _pil()[0].BILINEAR, fillcolor=_FILL)


def _enhance(name):
    def op(img, v):
        return getattr(_pil()[1], name)(img).enhance(1.0 + v)

    return op


def _posterize(img, v):
    return _pil()[2].posterize(img, int(round(v)))


def _solarize(img, v):
    return _pil()[2].solarize(img, int(v))


def _autocontrast(img, v):
    return _pil()[2].autocontrast(img)


def _equalize(img, v):
    return _pil()[2].equalize(img)


# (name, magnitude range, signed, op): torchvision's RandAugment op space
_OPS = [
    ("Identity", None, False, lambda img, v: img),
    ("ShearX", (0.0, 0.3), True, _shear_x),
    ("ShearY", (0.0, 0.3), True, _shear_y),
    ("TranslateX", (0.0, 150.0 / 331.0), True, _translate_x),
    ("TranslateY", (0.0, 150.0 / 331.0), True, _translate_y),
    ("Rotate", (0.0, 30.0), True, _rotate),
    ("Brightness", (0.0, 0.9), True, _enhance("Brightness")),
    ("Color", (0.0, 0.9), True, _enhance("Color")),
    ("Contrast", (0.0, 0.9), True, _enhance("Contrast")),
    ("Sharpness", (0.0, 0.9), True, _enhance("Sharpness")),
    ("Posterize", (8, 4), False, _posterize),
    ("Solarize", (255.0, 0.0), False, _solarize),
    ("AutoContrast", None, False, _autocontrast),
    ("Equalize", None, False, _equalize),
]


class RandAugment:
    """num_ops random ops at one magnitude bin, the random numbers from
    ``rng``."""

    random = True

    def __init__(self, num_ops: int = 2, magnitude: int = 9):
        self.num_ops = num_ops
        self.magnitude = magnitude

    def __call__(self, img, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        img = img.convert("RGB")
        for _ in range(self.num_ops):
            _, rng_range, signed, fn = _OPS[int(rng.integers(len(_OPS)))]
            if rng_range is None:
                v = 0.0
            else:
                lo, hi = rng_range
                v = lo + (hi - lo) * self.magnitude / (_NUM_BINS - 1)
                if signed and rng.random() < 0.5:
                    v = -v
            img = fn(img, v)
        return img


def train_transform(image_size: int, augmentation_ops: int = 2,
                    augmentation_magnitude: int = 9) -> Compose:
    """RandAugment -> Resize -> ToArray -> Normalize."""
    return Compose([RandAugment(augmentation_ops, augmentation_magnitude),
                    Resize(image_size), ToArray(), Normalize()])


def test_transform(image_size: int) -> Compose:
    """Resize -> CenterCrop -> ToArray -> Normalize."""
    return Compose([Resize(image_size), CenterCrop(image_size), ToArray(), Normalize()])
