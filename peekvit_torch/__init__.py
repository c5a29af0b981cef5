"""peekvit_torch: the PyTorch / CUDA port of peekvit_tpu for one NVIDIA
H100 (sm_90a).

The JAX package ``peekvit_tpu`` is the reference; this package imports
nothing of it. Entry points run on the card unless the caller passes
``device="cpu"``. The encoder's kernels are hand-written CUDA under
``peekvit_torch/csrc``, built with nvcc at the first launch (importing
the package builds nothing).
"""

from peekvit_torch.inference import InferenceEngine
from peekvit_torch.models.registry import build_model
from peekvit_torch.training.trainer import Trainer

__all__ = ["InferenceEngine", "Trainer", "build_model"]
