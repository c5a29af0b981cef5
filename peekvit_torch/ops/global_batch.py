"""One forward over one data slice of a global batch.

Under data parallelism (``parallel/data.py``) every rank receives the
global batch and runs the forward on its own rows. Two things in a
forward are not row-local, and this module holds the seam for both:

- **Per-sample draws** (dropout masks, the gumbel gates' noise, the
  sampled budgets, the NoiseBlock's normals): :func:`per_sample` draws
  over the global batch's shape and returns this slice's rows, so that a
  data-parallel forward draws exactly what the single-device forward of
  the same generator draws (JAX's linen step under GSPMD draws over the
  global shape too). Every rank's generator is seeded alike, so the cost
  is the global draw on every rank.
- **Whole-batch means** (the ResidualViT budget token's mean, a
  reference quirk; the A-ViT's mean halting score per layer):
  :func:`batch_mean` is the slice's mean, then the mean over the data
  column, as JAX's ``jax.lax.pmean`` over the data axis.

Outside :func:`data_slice` both are the plain single-device operations.
The collective comes from the caller (``parallel/data.py``), so this
module needs no process group. The slice is a context variable, not an
argument: the draws and means sit deep in every family's forward, and a
context variable is private to the thread (and task) that set it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch

# (n_data, data_index, mean over the data column) inside a data slice
_SLICE: contextvars.ContextVar = contextvars.ContextVar("data_slice", default=None)


@contextlib.contextmanager
def data_slice(n_data: int, data_index: int, mean: Callable[[torch.Tensor], torch.Tensor]):
    """Run the block's forwards as slice ``data_index`` of ``n_data`` equal
    slices of the batch; ``mean(t)`` averages a 0-d tensor over the slices
    (differentiable)."""
    token = _SLICE.set((int(n_data), int(data_index), mean))
    try:
        yield
    finally:
        _SLICE.reset(token)


def per_sample(draw: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
    """``draw(shape)`` for a draw whose leading axis is the batch: inside a
    data slice, ``draw`` of the global batch's shape, then this slice's
    rows."""
    shape, data = tuple(shape), _SLICE.get()
    if data is None or not shape:
        return draw(shape)
    n, index, _ = data
    rows = shape[0]
    return draw((rows * n,) + shape[1:])[index * rows:(index + 1) * rows]


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the whole batch, a 0-d tensor: inside a data
    slice, this slice's mean averaged over every slice (equal slices, so
    the global mean up to the order of the sums)."""
    local, data = x.mean(), _SLICE.get()
    return local if data is None else data[2](local)
