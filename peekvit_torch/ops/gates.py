"""Token gates (counterpart of peekvit_tpu/ops/gates.py; reference
models/blocks.py:14-69).

- ``sigmoid_with_temp``: sigmoid(x / temp + bias), the same in train and
  eval.
- ``hard_sigmoid_eval``: the gumbel-sigmoid gate at eval, round(sigmoid(x))
  (bias and temperature ignored, reference blocks.py:57). ``torch.round``
  rounds half to even, as ``jnp.round`` does.
- ``gumbel_sigmoid``: the train-time gate, straight-through
  round(sigmoid((logits + g) / tau + bias)) with g ~ Gumbel(0, 1) drawn
  from an explicit ``torch.Generator`` (JAX draws from its own PRNG key:
  the two streams differ, so a parity test passes the same ``noise=`` to
  both sides).
"""

from __future__ import annotations

from typing import Optional

import torch

_TINY = torch.finfo(torch.float32).tiny


def sigmoid_with_temp(x: torch.Tensor, temp: float = 1.0, bias: float = 0.0) -> torch.Tensor:
    return torch.sigmoid(x / temp + bias)


def hard_sigmoid_eval(logits: torch.Tensor) -> torch.Tensor:
    """Eval-time gumbel-sigmoid gate: round(sigmoid(x))."""
    return torch.round(torch.sigmoid(logits))


def gumbel_sigmoid(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                   tau: float = 1.0, bias: float = 0.0, hard: bool = True,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-sigmoid with straight-through rounding (the train-time gate,
    peekvit_tpu/ops/gates.py:25-38). ``noise`` (logits' shape) replaces the
    Gumbel draw from ``generator``."""
    if noise is None:
        # -log(-log(u)), u uniform in [tiny, 1) as jax.random.gumbel, drawn
        # on the generator's device
        gen_device = generator.device if generator is not None else logits.device
        u = torch.rand(logits.shape, generator=generator, device=gen_device).clamp_min(_TINY)
        noise = -torch.log(-torch.log(u))
    y_soft = torch.sigmoid((logits + noise.to(logits.device, logits.dtype)) / tau + bias)
    if hard:
        return torch.round(y_soft) - y_soft.detach() + y_soft
    return y_soft
