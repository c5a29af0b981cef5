"""Input pipeline (counterpart of peekvit_tpu/data/): host-side decode and
augmentation on PIL and numpy, batched by the threaded
:class:`~peekvit_torch.data.loader.DataLoader`, sent to the card by
``prefetch_to_device``. Every dataset wrapper has the JAX package's
surface: ``.train_dataset`` / ``.val_dataset`` /
``.denormalize_transform`` and the class names. Images are NHWC float32,
the layout of the port's patch embedding (ops/patch_embed.py)."""

from peekvit_torch.data.loader import DataLoader, prefetch_to_device
from peekvit_torch.data.synthetic import Synthetic

__all__ = ["DataLoader", "prefetch_to_device", "Synthetic"]
