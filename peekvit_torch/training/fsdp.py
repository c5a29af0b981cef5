"""Sharded parameters: FSDP over the data axis (counterpart of
``Trainer(fsdp_sharded_params=True)`` and peekvit_tpu/parallel/mesh.py
``fsdp_param_sharding``), and the store that tensor-parallel training
(``parallel/tensor.py``) keeps its shards in.

:class:`ShardedParams` holds, for every parameter of a model in the JAX
tree's order, what this rank keeps between steps (its *local* tensor) and
how that relates to the whole leaf:

- **whole**: the leaf itself (replicated);
- **gathered**: a slice of the leaf along one axis; the module's parameter
  is empty between steps, is filled with the whole leaf in front of the
  forward (:meth:`gather`) and emptied when the step ends (:meth:`free`);
  its gradient, whole on every rank of the group, is cut back to the
  slice (:meth:`collect_grads`);
- **held**: a slice that the module itself computes with (the Megatron
  modules of ``parallel/tensor.py``): the local tensor is the module's
  parameter.

The optimizer runs over the local tensors only (:meth:`local_tree`), so
its state is the held fraction of the replicated optimizer's. A slice is
``n`` equal parts of one axis, part ``index`` (``qkv``: the same part of
each third of a packed (.., 3D) axis, a head group of each of q, k and v).

Gloo has no ``all_gather`` for CUDA tensors and no ``reduce_scatter``, so
a gather is one fp32 ``all_reduce`` of a zero-filled buffer into which
each rank writes its slices (adding zeros is exact: every rank holds the
same bits), and a gradient takes the existing fp32 all-reduce over the
data column before each rank keeps its slice.

FSDP (:func:`fsdp_params`): every leaf with a dimension ``s >= n``,
``s % n == 0`` is *gathered* over the data column, cut on the first such
dimension (JAX's ``_data_axis_spec``); the others, and scalars, stay
whole. The whole leaves are gathered once, in front of the module
forward, and freed when the step ends (a gather per layer is later work,
ROADMAP.md). Gathered leaves hold exactly the replicated values, and the
optimizers are elementwise, so the step is the replicated data-parallel
step's, up to the global norm of clipping (summed per slice).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from peekvit_torch.models.adapters import _nest, live_params, tree_leaves
from peekvit_torch.parallel.mesh import DATA_AXIS, data_axis_spec, split_axis

WHOLE, GATHERED, HELD = "whole", "gathered", "held"


def _pieces(full: torch.Tensor, axis: int, n: int, index: int, qkv: bool) -> list:
    """The views of ``full`` that part ``index`` of ``n`` covers."""
    if qkv:
        third = full.shape[axis] // 3
        k = third // n
        return [full.narrow(axis, c * third + index * k, k) for c in range(3)]
    k = full.shape[axis] // n
    return [full.narrow(axis, index * k, k)]


def take_part(full: torch.Tensor, axis: int, n: int, index: int, qkv: bool = False):
    """Part ``index`` of ``n`` of ``full`` along ``axis``, a new tensor."""
    pieces = _pieces(full, axis, n, index, qkv)
    return torch.cat(pieces, dim=axis) if qkv else pieces[0].clone()


def put_part(full: torch.Tensor, part: torch.Tensor, axis: int, n: int, index: int,
             qkv: bool = False) -> None:
    """Write ``part`` (:func:`take_part`'s) into its place in ``full``."""
    pieces = _pieces(full, axis, n, index, qkv)
    for view, src in zip(pieces, part.split(pieces[0].shape[axis], dim=axis)):
        view.copy_(src)


@dataclass
class Leaf:
    path: str             # the JAX tree path, "/"-joined
    param: nn.Parameter   # the module's parameter
    local: torch.Tensor   # what this rank holds between steps
    kind: str             # WHOLE, GATHERED or HELD
    shape: tuple          # the whole leaf's shape
    axis: Optional[int] = None
    qkv: bool = False


def _empty(p: torch.Tensor) -> torch.Tensor:
    return torch.empty(0, dtype=p.dtype, device=p.device)


def gathered_leaf(path: str, p: nn.Parameter, axis: int, n: int, index: int) -> Leaf:
    """A GATHERED leaf: this rank's part ``index`` of ``n`` of ``p`` along
    ``axis`` held, ``p`` emptied until :meth:`ShardedParams.gather`."""
    shape = tuple(p.shape)
    local = nn.Parameter(take_part(p.detach(), axis, n, index))
    p.data = _empty(p)
    return Leaf(path, p, local, GATHERED, shape, axis)


class ShardedParams:
    """The parameters of one model, sharded over a group of ``n`` ranks in
    which this one is ``index`` (the data column for FSDP, the model row
    for tensor parallelism). ``leaves`` in the model's parameter order."""

    def __init__(self, leaves: list, n: int, index: int, group):
        self.leaves, self.n, self.index, self.group = leaves, n, index, group

    # ------------------------------------------------------------ the step

    def _whole(self, leaves: list, source) -> list:
        """The whole leaves of ``leaves``, from each rank's ``source(leaf)``
        slice: one fp32 all-reduce over the group."""
        if not leaves:
            return []
        device = leaves[0].local.device
        flat = torch.zeros(sum(_numel(lf.shape) for lf in leaves), dtype=torch.float32,
                           device=device)
        fulls, offset = [], 0
        for lf in leaves:
            full = flat[offset:offset + _numel(lf.shape)].view(lf.shape)
            put_part(full, source(lf).detach().float(), lf.axis, self.n, self.index, lf.qkv)
            fulls.append(full)
            offset += full.numel()
        if self.n > 1:
            dist.all_reduce(flat, group=self.group)
        return fulls

    def _gathered(self) -> list:
        return [lf for lf in self.leaves if lf.kind == GATHERED]

    def gather(self) -> None:
        """Fill every gathered leaf's parameter with the whole leaf."""
        gathered = self._gathered()
        for lf, full in zip(gathered, self._whole(gathered, lambda lf: lf.local)):
            lf.param.data = full.to(lf.param.dtype)

    def free(self) -> None:
        """Empty every gathered leaf's parameter and its gradient."""
        for lf in self._gathered():
            lf.param.data = _empty(lf.param)
            lf.param.grad = None

    def collect_grads(self) -> None:
        """Each gathered leaf's gradient (the same whole gradient on every
        rank of the group) cut to this rank's slice, onto its local tensor."""
        for lf in self._gathered():
            g = lf.param.grad
            lf.local.grad = None if g is None else take_part(g, lf.axis, self.n, self.index,
                                                             lf.qkv)
            lf.param.grad = None

    def module_params(self) -> list:
        """The module's parameters as the forward sees them (the data
        column all-reduces their gradients)."""
        return [lf.param for lf in self.leaves]

    def local_tree(self) -> dict:
        """What this rank holds, as a nested dict in the JAX tree's grammar
        (the optimizer's parameters)."""
        return _nest((lf.path.replace("/", "."), lf.local) for lf in self.leaves)

    def sq_norm(self, grads: list) -> torch.Tensor:
        """The squared global norm of the whole gradient from the local
        gradients ``grads`` (in the leaves' order): the slices' squares
        summed over the group, the whole leaves' counted once."""
        parts = [torch.sum(g.float() * g.float()) for g in grads]
        sharded = [s for s, lf in zip(parts, self.leaves) if lf.kind != WHOLE]
        whole = [s for s, lf in zip(parts, self.leaves) if lf.kind == WHOLE]
        total = torch.stack(sharded).sum() if sharded else torch.zeros((), device=grads[0].device)
        if self.n > 1 and sharded:
            dist.all_reduce(total, group=self.group)
        return total + sum(whole) if whole else total

    # ----------------------------------------------------- whole leaves

    def full_state_dict(self) -> dict:
        """Every leaf whole, in JAX's layout, keyed as ``state_dict``
        (collective over the group)."""
        split = [lf for lf in self.leaves if lf.kind != WHOLE]
        fulls = dict(zip((lf.path for lf in split), self._whole(split, lambda lf: lf.local)))
        return {lf.path.replace("/", "."): (fulls[lf.path].to(lf.param.dtype)
                                            if lf.path in fulls else lf.param.detach())
                for lf in self.leaves}

    def load_full_state_dict(self, state: dict) -> None:
        """Load whole leaves (``state_dict`` keys) into this rank's share."""
        with torch.no_grad():
            for lf in self.leaves:
                full = torch.as_tensor(state[lf.path.replace("/", ".")])
                if tuple(full.shape) != lf.shape:
                    raise ValueError(f"{lf.path}: shape {tuple(full.shape)} != {lf.shape}")
                full = full.to(lf.local.device, lf.local.dtype)
                lf.local.copy_(full if lf.kind == WHOLE else
                               take_part(full, lf.axis, self.n, self.index, lf.qkv))

    # ------------------------------------------------------------ sizes

    def held_bytes(self) -> int:
        """Bytes of parameters this rank holds between steps."""
        return sum(lf.local.numel() * lf.local.element_size() for lf in self.leaves)

    def whole_bytes(self) -> int:
        """Bytes of the whole model's parameters."""
        return sum(_numel(lf.shape) * lf.local.element_size() for lf in self.leaves)

    def split_fraction(self) -> float:
        """The fraction of the model's elements in leaves split over the
        group (JAX's test measure of a sharded placement)."""
        total = sum(_numel(lf.shape) for lf in self.leaves)
        return sum(_numel(lf.shape) for lf in self.leaves if lf.kind != WHOLE) / max(total, 1)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def fsdp_params(model: nn.Module, mesh) -> ShardedParams:
    """Shard ``model``'s parameters over ``mesh``'s data column (FSDP):
    each divisible leaf keeps this rank's slice of its first divisible
    dimension and its parameter is emptied until :meth:`ShardedParams.gather`."""
    n, index = mesh.shape[DATA_AXIS], mesh.data_index
    leaves = []
    for path, p in tree_leaves(live_params(model)):
        axis = split_axis(data_axis_spec(tuple(p.shape), n), DATA_AXIS)
        leaves.append(Leaf(path, p, p, WHOLE, tuple(p.shape)) if axis is None
                      else gathered_leaf(path, p, axis, n, index))
    return ShardedParams(leaves, n, index, mesh.data_group)
