"""Dropout with flax ``nn.Dropout``'s semantics (counterpart of the
``nn.Dropout`` sites of the JAX models and of the attention-weight
dropout of peekvit_tpu/ops/attention.py:84-86).

Every dropout site of the port calls :func:`dropout`. It keeps each
element with probability ``1 - rate`` and scales the kept ones by
``1 / (1 - rate)``; a rate of 0 and an eval forward are the identity and
draw nothing, a rate of 1 gives zeros. The keep mask covers the full
shape and comes from :func:`keep_mask`, drawn from the caller's
``torch.Generator`` (the Trainer's step generator lives on the batch's
device): ``torch.rand(shape) < 1 - rate``. JAX's bits cannot be drawn in
torch, so a parity test replaces :func:`keep_mask`, the one seam every
mask passes through. Under data parallelism the mask is drawn over the
global batch and this rank's rows are kept (``ops/global_batch.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from peekvit_torch.ops.global_batch import per_sample


def keep_mask(shape, keep_prob: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A bool mask of ``shape``, True with probability ``keep_prob``, drawn
    from ``generator`` on its own device (else on ``device``) and moved to
    ``device``."""
    gen_device = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=gen_device)
    return (u < keep_prob).to(device)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None, *,
            train: bool = True) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic=not train)``: x where kept,
    divided by ``1 - rate``, else 0."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = per_sample(lambda s: keep_mask(s, keep_prob, generator, x.device), x.shape)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
