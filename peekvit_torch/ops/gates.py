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
- ``gumbel_softmax``: the MoE gate (JAX ``GumbelSoftmax``). Eval:
  one_hot(argmax(logits)), no noise; train: softmax((logits + g) / tau),
  under ``hard=True`` one_hot(argmax) with the straight-through gradient
  of the soft probabilities. ``torch.argmax`` takes the first maximal
  index, as ``jnp.argmax`` does. g as in ``gumbel_sigmoid``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from peekvit_torch.ops.global_batch import per_sample

_TINY = torch.finfo(torch.float32).tiny


def sigmoid_with_temp(x: torch.Tensor, temp: float = 1.0, bias: float = 0.0) -> torch.Tensor:
    return torch.sigmoid(x / temp + bias)


def hard_sigmoid_eval(logits: torch.Tensor) -> torch.Tensor:
    """Eval-time gumbel-sigmoid gate: round(sigmoid(x))."""
    return torch.round(torch.sigmoid(logits))


def _gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Gumbel(0, 1) draws -log(-log(u)), u uniform in [tiny, 1) as
    jax.random.gumbel, drawn on the generator's device (else ``device``),
    over the global batch under data parallelism (ops/global_batch.py)."""
    gen_device = generator.device if generator is not None else device
    u = per_sample(lambda s: torch.rand(s, generator=generator, device=gen_device),
                   shape).clamp_min(_TINY)
    return -torch.log(-torch.log(u))


def gumbel_sigmoid(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                   tau: float = 1.0, bias: float = 0.0, hard: bool = True,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-sigmoid with straight-through rounding (the train-time gate,
    peekvit_tpu/ops/gates.py:25-38). ``noise`` (logits' shape) replaces the
    Gumbel draw from ``generator``."""
    if noise is None:
        noise = _gumbel_noise(logits.shape, generator, logits.device)
    y_soft = torch.sigmoid((logits + noise.to(logits.device, logits.dtype)) / tau + bias)
    if hard:
        return torch.round(y_soft) - y_soft.detach() + y_soft
    return y_soft


def gumbel_softmax(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                   tau: float = 1.0, hard: bool = True, dim: int = -1, train: bool = True,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gumbel-softmax gate (peekvit_tpu/ops/gates.py:46-68). ``noise``
    (logits' shape) replaces the Gumbel draw from ``generator``; eval
    draws none."""
    n = logits.shape[dim]
    if not train:
        idx = torch.argmax(logits, dim=dim)
        return F.one_hot(idx, n).movedim(-1, dim).to(logits.dtype)
    if noise is None:
        noise = _gumbel_noise(logits.shape, generator, logits.device)
    y_soft = torch.softmax((logits + noise.to(logits.device, logits.dtype)) / tau, dim=dim)
    if not hard:
        return y_soft
    y_hard = F.one_hot(torch.argmax(y_soft, dim=dim), n).movedim(-1, dim).to(logits.dtype)
    return y_hard - y_soft.detach() + y_soft
