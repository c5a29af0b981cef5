"""Data parallelism over the mesh's data axis (counterpart of the JAX
package's data-parallel paths: the shard-mapped engine,
peekvit_tpu/inference.py:2444-2462, and the Trainer's dp steps,
peekvit_tpu/training/trainer.py:313-400, :721-809).

The convention is the one the tensor-parallel engine's data axis and the
dp x sp step follow: every rank receives the **global** batch, runs its
rows ``data_index * B/n .. (data_index + 1) * B/n`` (:func:`data_rows`),
and the outputs come back as the global batch's (:func:`gather_rows`,
differentiable). A batch that the data axis does not divide raises with
JAX's message. Inside :func:`data_slice` the forward's per-sample draws
are made over the global batch and its whole-batch means are averaged
over the data column (``ops/global_batch.py``), so that a data-parallel
forward computes what the single-device forward computes.

Gloo's ``all_gather`` takes CPU tensors only, but its ``all_reduce``
takes CUDA tensors too, so the gather is an all-reduce of a zero-filled
buffer (``sequence._gather_tokens``): adding zeros is exact, and every
rank holds the same bits. A data axis of 1 runs no collective.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from peekvit_torch.ops import global_batch
from peekvit_torch.parallel.mesh import DATA_AXIS
from peekvit_torch.parallel.sequence import _gather_tokens


def check_divisible(batch: int, mesh, what: str) -> None:
    """JAX's guard (inference.py:2934-2942, trainer.py:829-843): the data
    axis must divide the batch."""
    n = mesh.shape[DATA_AXIS]
    if batch % n:
        raise ValueError(f"batch size {batch} must divide the mesh's '{DATA_AXIS}' axis size "
                         f"{n} for {what} (shard_map splits the batch evenly)")


def data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch (leading axis)."""
    per = x.shape[0] // mesh.shape[DATA_AXIS]
    return x[mesh.data_index * per:(mesh.data_index + 1) * per]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated along the leading axis, the
    same on every rank; differentiable (the backward all-reduces the
    cotangent and takes this rank's rows)."""
    return _gather_tokens(x, 0, mesh.data_index, mesh.shape[DATA_AXIS], mesh.data_group)


class _MeanOverData(torch.autograd.Function):
    """The mean of one 0-d tensor per rank over a group of ``n`` ranks.
    Backward: the cotangent all-reduced, over n (each rank's loss is its
    share of one global loss, so the cotangents are summed)."""

    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        y = x.detach().float().clone()
        dist.all_reduce(y, group=group)
        return (y / n).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def mean_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``jax.lax.pmean(x, 'data')`` of a 0-d tensor, differentiable."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return x
    return _MeanOverData.apply(x, n, mesh.data_group)


@contextlib.contextmanager
def data_slice(mesh):
    """The forwards inside run as this rank's slice of the global batch:
    per-sample draws over the global batch, whole-batch means over the
    data column."""
    with global_batch.data_slice(mesh.shape[DATA_AXIS], mesh.data_index,
                                 lambda t: mean_over_data(t, mesh)):
        yield


def gather_tree(tree, mesh, rows: int, keep=()):
    """``tree`` (a tensor, or tuples, lists and dicts of them) with every
    floating tensor whose leading axis holds this rank's ``rows`` gathered
    over the data column; other leaves, and the dict entries named in
    ``keep`` (values that are already the whole batch's), as they are."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() and tree.shape[0] == rows and tree.is_floating_point():
            return gather_rows(tree, mesh)
        return tree
    if isinstance(tree, dict):
        return {k: v if k in keep else gather_tree(v, mesh, rows, keep)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_tree(v, mesh, rows, keep) for v in tree)
    return tree


def over_data(mesh, fn):
    """``fn(prepared, images, *rest)`` as a data-parallel engine forward:
    this rank's rows inside :func:`data_slice`, the outputs gathered over
    the data column; the whole batch in and out."""

    def wrapped(prepared, images, *rest, **kwargs):
        check_divisible(images.shape[0], mesh, "data-parallel serving")
        rows = data_rows(images, mesh)
        with data_slice(mesh):
            out = fn(prepared, rows, *rest, **kwargs)
        return gather_tree(out, mesh, rows.shape[0])

    return wrapped
