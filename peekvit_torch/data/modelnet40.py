"""Counterpart of peekvit_tpu/data/modelnet40.py. ModelNet40 point clouds (reference data/modelnet40.py): ply_data HDF5
download; train aug = random point dropout + anisotropic scale/translate +
point shuffle (reference :15-31,53-60)."""

from __future__ import annotations

import glob
import os
import pathlib

import numpy as np

from peekvit_torch.data.datasets import Dataset, download_url, extract_archive

MODELNET40_CLASSES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]


def random_point_dropout(pc: np.ndarray, rng: np.random.Generator,
                         max_dropout_ratio: float = 0.875) -> np.ndarray:
    """Replace a random fraction of points with the first point
    (reference modelnet40.py:15-24)."""
    dropout_ratio = rng.random() * max_dropout_ratio
    drop_idx = np.where(rng.random(pc.shape[0]) <= dropout_ratio)[0]
    if len(drop_idx) > 0:
        pc = pc.copy()
        pc[drop_idx, :] = pc[0, :]
    return pc


def translate_pointcloud(pc: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Anisotropic scale [2/3, 3/2] + translate [-0.2, 0.2]
    (reference modelnet40.py:26-31)."""
    xyz1 = rng.uniform(low=2.0 / 3.0, high=3.0 / 2.0, size=[3])
    xyz2 = rng.uniform(low=-0.2, high=0.2, size=[3])
    return np.add(np.multiply(pc, xyz1), xyz2).astype("float32")


class ModelNet40Ply2048(Dataset):
    """HDF5-backed split with the reference train augmentations
    (reference modelnet40.py:35-64); truncates to num_points."""

    def __init__(self, root, split: str = "train", num_points: int = 2048,
                 seed: int = 0):
        assert split in ("train", "test")
        self.split = split
        self.num_points = num_points
        data_list, labels_list = [], []
        import h5py

        for h5_name in sorted(glob.glob(os.path.join(root, f"ply_data_{split}*.h5"))):
            with h5py.File(h5_name, "r") as f:
                data_list.append(f["data"][:].astype(np.float32))
                labels_list.append(f["label"][:].astype(np.int64))
        if not data_list:
            raise RuntimeError(f"No ply_data_{split}*.h5 under {root}")
        self.data = np.concatenate(data_list, axis=0)[:, :, :3]
        self.labels = np.concatenate(labels_list, axis=0).squeeze(-1)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item):
        points = self.data[item][: self.num_points]
        label = int(self.labels[item])
        if self.split == "train":
            points = random_point_dropout(points, self._rng)
            points = translate_pointcloud(points, self._rng)
            points = points[self._rng.permutation(len(points))]
        return points, label


class ModelNet40:
    MODELNET40_URL = (
        "https://shapenet.cs.stanford.edu/media/modelnet40_ply_hdf5_2048.zip"
    )
    MODELNET40_CLASSES = MODELNET40_CLASSES

    def __init__(self, root, num_points: int = 2048, num_classes: int = 40,
                 train_transform=None, test_transform=None,
                 target_transform=None, **kwargs):
        self.root = root
        self.num_points = num_points
        self.num_classes = 40
        base = pathlib.Path(root) / "modelnet40_ply_hdf5_2048"
        if not base.exists():
            os.makedirs(root, exist_ok=True)
            archive = download_url(
                self.MODELNET40_URL, str(pathlib.Path(root) / "modelnet40.zip")
            )
            extract_archive(archive, root)
        self.train_dataset = ModelNet40Ply2048(str(base), "train", num_points)
        self.val_dataset = ModelNet40Ply2048(str(base), "test", num_points)
