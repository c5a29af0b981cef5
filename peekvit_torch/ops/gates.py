"""Token gates (counterpart of peekvit_tpu/ops/gates.py; reference
models/blocks.py:14-69).

- ``sigmoid_with_temp``: sigmoid(x / temp + bias), the same in train and
  eval.
- ``hard_sigmoid_eval``: the gumbel-sigmoid gate at eval, round(sigmoid(x))
  (bias and temperature ignored, reference blocks.py:57). ``torch.round``
  rounds half to even, as ``jnp.round`` does.

The train-time gumbel-sigmoid sampler draws random numbers, and training
a gated model is not ported yet: it raises.
"""

from __future__ import annotations

import torch

_TRAINING_ITEM = "ROADMAP.md port queue A item 4b (ResidualViT training)"


def sigmoid_with_temp(x: torch.Tensor, temp: float = 1.0, bias: float = 0.0) -> torch.Tensor:
    return torch.sigmoid(x / temp + bias)


def hard_sigmoid_eval(logits: torch.Tensor) -> torch.Tensor:
    """Eval-time gumbel-sigmoid gate: round(sigmoid(x))."""
    return torch.round(torch.sigmoid(logits))


def gumbel_sigmoid(*args, **kwargs):
    raise NotImplementedError(f"the train-time gumbel-sigmoid gate is not ported yet: {_TRAINING_ITEM}")
