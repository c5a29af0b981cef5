"""A (data, model) mesh over the ranks of a ``torch.distributed`` group
(counterpart of peekvit_tpu/parallel/mesh.py ``make_mesh``), or a (data,
stage) mesh for the pipeline (JAX's ``Mesh(devices.reshape(n, S), ("data",
"stage"))``).

The JAX mesh is a grid of devices in one program; here each rank is one
process, and the mesh is that rank's view of the grid: its position, the
process group of its model row (the ranks that hold the other slices of
the same weights, over which tensor-parallel partials are all-reduced)
and of its data column (the ranks that serve the other slices of the
batch), and its device.

Rank r sits at (data r // n_model, model r % n_model), the row-major
``reshape(n_data, n_model)`` of the JAX mesh, so a model row is ``n_model``
consecutive ranks. The caller initializes the default process group
(``torch.distributed.init_process_group``: address, world size, rank and
backend are the caller's); the mesh only splits it.

The placement rules of sharded training are JAX's, leaf by leaf:
:func:`param_spec` (the Megatron and expert rules of
``Trainer(tensor_parallel=True)``) and :func:`data_axis_spec` (FSDP's and
ZeRO-1's first divisible dimension). A spec is a tuple of axis names, one
per leading dimension it names, ``None`` where a dimension is whole: the
``PartitionSpec`` of the JAX package as a plain tuple, ``()`` for a
replicated leaf.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from peekvit_torch.models.registry import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a (data, model) or (data, stage) mesh. ``shape``
    maps ``DATA_AXIS`` and the second axis (``MODEL_AXIS`` or ``STAGE_AXIS``)
    to their sizes; ``model_group`` holds the ranks of this rank's row along
    the second axis, ``data_group`` those of its data column;
    ``data_index`` / ``model_index`` are its position."""

    shape: dict
    data_group: Any
    model_group: Any
    data_index: int
    model_index: int
    device: torch.device


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None,
              axis: str = MODEL_AXIS) -> Mesh:
    """The calling rank's view of an ``n_data`` × ``n_model`` mesh over the
    default process group (``n_data`` defaults to world size // n_model);
    ``axis`` names the second axis: ``MODEL_AXIS``, or ``STAGE_AXIS`` for a
    pipeline's (data, stage) mesh.
    Every rank must call it, with the same arguments: each model row and
    each data column becomes a group (``dist.new_group``, called by every
    rank in the same order). ``device``: by default (or ``"cuda"`` with
    no index) ``cuda:{rank % device_count}``, so several ranks may share a
    card; pass ``"cpu"`` to run on the CPU. Raises without a card unless
    the CPU is asked for."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if axis not in (MODEL_AXIS, STAGE_AXIS):
        raise ValueError(f"the second mesh axis is {MODEL_AXIS!r} or {STAGE_AXIS!r}, got {axis!r}")
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs n_data * n_model == world size, "
                         f"got world size {world}")
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    data_index, model_index = divmod(rank, n_model)
    model_group = data_group = None
    for i in range(n_data):
        group = dist.new_group([i * n_model + j for j in range(n_model)])
        if i == data_index:
            model_group = group
    for j in range(n_model):
        group = dist.new_group([i * n_model + j for i in range(n_data)])
        if j == model_index:
            data_group = group
    return Mesh({DATA_AXIS: n_data, axis: n_model}, data_group, model_group,
                data_index, model_index, dev)


# Tensor-parallel rules: a regex on the "/"-joined parameter path -> spec.
# Column-parallel for qkv / fc1 (the output features split), row-parallel
# for the out-projection / fc2 (the input features split), the qkv / fc1
# biases on the split output (JAX parallel/mesh.py:110-138).
_TP_RULES = [
    (re.compile(r"(in_proj|fc1)_?kernel$"), (None, MODEL_AXIS)),
    (re.compile(r"(out_proj|fc2)_?kernel$"), (MODEL_AXIS, None)),
    (re.compile(r"(in_proj|fc1)_?bias$"), (MODEL_AXIS,)),
]
# Expert parallelism: the stacked MoE MLP experts split their leading
# expert axis.
_EP_RULES = [
    (re.compile(r"experts/fc[12]_kernel$"), (MODEL_AXIS, None, None)),
    (re.compile(r"experts/fc[12]_bias$"), (MODEL_AXIS, None)),
]


def param_spec(path: str, ndim: int) -> tuple:
    """JAX's ``param_spec`` under ``Trainer(tensor_parallel=True)``: the
    spec of the leaf at ``path`` (of rank ``ndim``); ``()`` replicated.
    The expert rules first, on a leaf of the rule's rank; then the Megatron
    rules on a 1-D or 2-D leaf (a 2-D bias takes the 1-D bias spec, which
    splits its leading axis, as in JAX)."""
    for pat, spec in _EP_RULES:
        if pat.search(path) and ndim == len(spec):
            return spec
    if ndim in (1, 2):
        for pat, spec in _TP_RULES:
            if pat.search(path):
                return spec
    return ()


def split_axis(spec: tuple, axis_name: str) -> Optional[int]:
    """The dimension ``spec`` splits over ``axis_name``, or None."""
    return spec.index(axis_name) if axis_name in spec else None


def data_axis_spec(shape, n: int) -> tuple:
    """JAX's ``_data_axis_spec``: the first dimension ``s`` with ``s >= n``
    and ``s % n == 0`` splits over the data axis; a leaf with none, and a
    scalar, stays replicated (``()``)."""
    for axis, s in enumerate(shape):
        if s >= n and s % n == 0:
            return (None,) * axis + (DATA_AXIS,)
    return ()
