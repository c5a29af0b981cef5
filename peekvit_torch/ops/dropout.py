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
global batch and this rank's rows are kept (``ops/global_batch.py``);
under tensor parallelism over every head, and this rank's heads kept.
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
            train: bool = True, shard: Optional[tuple] = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic=not train)``: x where kept,
    divided by ``1 - rate``, else 0. ``shard=(axis, n, index)``: ``x`` is
    part ``index`` of ``n`` equal parts of a whole tensor along ``axis``
    (the attention weights of a tensor-parallel rank's heads); the mask is
    drawn over the whole shape and this part kept, as the single device
    draws it."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate

    def draw(shape):
        if shard is None:
            return keep_mask(shape, keep_prob, generator, x.device)
        axis, n, index = shard
        k = shape[axis]
        whole = shape[:axis] + (k * n,) + shape[axis + 1:]
        return keep_mask(whole, keep_prob, generator, x.device).narrow(axis, index * k, k)

    keep = per_sample(draw, x.shape)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
