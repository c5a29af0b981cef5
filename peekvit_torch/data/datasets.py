"""Dataset primitives: the ImageFolder scan and the download and extract
helpers (counterpart of peekvit_tpu/data/datasets.py).

ImageFolder decodes with PIL, imported at the first image. The JAX
package's C++ batch decoder (``native_batch``) is not ported: ROADMAP.md
port queue A item 8 part 3.
"""

from __future__ import annotations

import os
import pathlib
import tarfile
import urllib.request
import zipfile
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".tif")
NATIVE_ITEM = "ROADMAP.md port queue A item 8 part 3 (the native image decoder)"


class Dataset:
    """Map-style dataset protocol: __len__ and __getitem__."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError


class ImageFolder(Dataset):
    """A class per subdirectory, class names sorted into indices
    (torchvision.datasets.ImageFolder)."""

    def __init__(self, root, transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None, seed: int = 0):
        self.root = str(root)
        self.transform = transform
        self.target_transform = target_transform
        self.classes = sorted(d.name for d in os.scandir(self.root) if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            for dirpath, _, files in sorted(os.walk(os.path.join(self.root, cls))):
                for fname in sorted(files):
                    if fname.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(dirpath, fname),
                                             self.class_to_idx[cls]))
        if not self.samples:
            raise RuntimeError(f"No images found under {self.root}")
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.samples)

    def native_batch(self, indices, num_threads: int = 8):
        raise NotImplementedError(f"ImageFolder.native_batch is not ported yet: {NATIVE_ITEM}")

    def __getitem__(self, idx):
        from PIL import Image

        path, target = self.samples[idx]
        with Image.open(path) as img:
            img = img.convert("RGB")
            if _is_random(self.transform):
                sample = self.transform(img, self._rng)
            else:
                sample = self.transform(img) if self.transform else img
        if self.target_transform:
            target = self.target_transform(target)
        return sample, target


def _is_random(t) -> bool:
    from peekvit_torch.data.transforms import Compose

    if t is None:
        return False
    if isinstance(t, Compose):
        return True  # Compose threads the rng itself
    return getattr(t, "random", False)


class ArrayDataset(Dataset):
    """In-memory (data, labels) pairs with an optional per-sample transform."""

    def __init__(self, data: np.ndarray, labels: np.ndarray,
                 transform: Optional[Callable] = None):
        assert len(data) == len(labels)
        self.data, self.labels = data, labels
        self.transform = transform

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        x, y = self.data[idx], self.labels[idx]
        if self.transform:
            x = self.transform(x)
        return x, y


class TransformedSubset(Dataset):
    def __init__(self, base: Dataset, indices: Sequence[int]):
        self.base, self.indices = base, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.base[self.indices[idx]]


# ------------------------------------------------------------ download utils


def download_url(url: str, dest: str) -> str:
    """``dest`` if it exists, else the download of ``url`` to it. A failed
    download raises, naming where to stage the file by hand."""
    dest_path = pathlib.Path(dest)
    if dest_path.exists():
        return str(dest_path)
    dest_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = str(dest_path) + ".part"
    try:
        urllib.request.urlretrieve(url, tmp)  # noqa: S310
        os.replace(tmp, dest_path)
    except Exception as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"Could not download {url} -> {dest}: {e}. Stage the archive at {dest} by "
            "hand, or use dataset=synthetic.") from e
    return str(dest_path)


def extract_archive(archive: str, dest_dir: str) -> None:
    os.makedirs(dest_dir, exist_ok=True)
    if archive.endswith((".tgz", ".tar.gz", ".tar")):
        with tarfile.open(archive) as f:
            f.extractall(path=dest_dir)  # noqa: S202
    elif archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as f:
            f.extractall(path=dest_dir)  # noqa: S202
    else:
        raise ValueError(f"Unknown archive format: {archive}")
